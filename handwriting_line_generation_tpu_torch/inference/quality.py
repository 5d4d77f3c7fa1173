"""Repeatable generation-quality evaluation.

Counterpart of ``handwriting_line_generation_tpu/inference/quality.py``.
One call -> one dict with the BASELINE.md quality metrics:

- **gen-CER**: a frozen recognizer reads lines the generator rendered from
  corpus text with interpolated dataset styles, beside **real_CER**, the
  same reader and greedy decoding on the real lines, and their difference,
  the realism gap; optionally also read after the v3 post-render
  degradation (``gen_CER_degraded``);
- **writer-ID retrieval** (top-1/5/20 and mean rank) and **inter/intra
  style distances**;
- **FID**: the Frechet distance between the recognizer's trunk features
  (``CNNOnlyHWR(return_features=True)``, pooled over the true ink frames)
  of real and generated lines, in numpy float64.

The style sweep, the renders and the recognizer run on the device; greedy
decoding, the degradation, the distances and the FID's eigen-solve run on
the host, as in the JAX package.  Each render of a chunk of texts draws its
noise from ``seed + <chunk start>`` (a ``torch.Generator``: torch cannot
reproduce JAX's draws).
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from handwriting_line_generation_tpu_torch.charset import (
    Charset, ctc_greedy_decode_batch,
)
from handwriting_line_generation_tpu_torch.device import resolve_device
from handwriting_line_generation_tpu_torch.inference.generate import (
    GenerationSession, to_uint8,
)
from handwriting_line_generation_tpu_torch.inference.styles import (
    StyleExtractor, inter_intra_distances, writer_id_retrieval,
)
from handwriting_line_generation_tpu_torch.models.hw_with_style import \
    HWWithStyle
from handwriting_line_generation_tpu_torch.ops.ctc import mask_frames_to_blank
from handwriting_line_generation_tpu_torch.utils.error_rates import \
    batch_cer_wer
from handwriting_line_generation_tpu_torch.utils.png import write_png_gray

_T0 = time.time()


def _mark(msg: str) -> None:
    """Stage breadcrumb on stderr, seconds since import: when a time limit
    kills a long run, the last mark says which stage took the time."""
    print(f"[quality +{time.time() - _T0:7.1f}s] {msg}", file=sys.stderr,
          flush=True)


def frechet_distance(feat_a: np.ndarray, feat_b: np.ndarray) -> float:
    """FID formula ||mu_a - mu_b||^2 + tr(Sa + Sb - 2 sqrt(Sa Sb)).

    The trace of the matrix square root is computed from the eigenvalues of
    the (diagonalizable, similarity-symmetric) product ``Sa @ Sb``.  With
    fewer samples than features the covariances are rank-deficient (held
    off singular by a 1e-6 ridge) and the result is sensitive to rounding.
    """
    mu_a, mu_b = feat_a.mean(0), feat_b.mean(0)
    sa = np.cov(feat_a, rowvar=False) + 1e-6 * np.eye(feat_a.shape[1])
    sb = np.cov(feat_b, rowvar=False) + 1e-6 * np.eye(feat_b.shape[1])
    eig = np.linalg.eigvals(sa @ sb)
    tr_sqrt = np.sqrt(np.clip(eig.real, 0.0, None)).sum()
    return float(((mu_a - mu_b) ** 2).sum() + np.trace(sa) + np.trace(sb)
                 - 2.0 * tr_sqrt)


def _pool(skip: torch.Tensor, frames: torch.Tensor) -> torch.Tensor:
    """Mean of ``skip [B, T, D]`` over each line's first ``frames``, in
    float32."""
    skip = skip.float()
    mask = (torch.arange(skip.shape[1], device=skip.device)[None, :]
            < frames[:, None])[..., None]
    return (torch.where(mask, skip, 0.0).sum(dim=1)
            / mask.sum(dim=1).clamp(min=1))


def load_texts(path: str, limit: Optional[int] = None) -> List[str]:
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f if ln.strip()]
    return lines[:limit] if limit else lines


class QualityEvaluator:
    """Checkpoint quality harness over a dataset split and a text corpus.

    ``device`` defaults to ``cuda`` and raises without a GPU; pass
    ``device="cpu"`` to run on the CPU.  ``stage_seconds`` holds the host
    seconds of the last run's stages (the style sweep, gen + readback, the
    degraded readback, the FID)."""

    def __init__(self, model: HWWithStyle, charset: Charset, seed: int = 0,
                 device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.charset = charset
        self.seed = seed
        # only the conv recognizer exposes features
        self.has_features = model.cfg.hwr.kind == "cnn_only"
        self.stage_seconds: Dict[str, float] = {}

    def _recog(self, image: torch.Tensor, frames: torch.Tensor
               ) -> torch.Tensor:
        return mask_frames_to_blank(self.model.recognize(image), frames)

    def _feat_fn(self, model: HWWithStyle, image: torch.Tensor,
                 frames: torch.Tensor) -> torch.Tensor:
        """Trunk features ``[B, 512]`` averaged over each line's frames,
        pooled in float32 even under a bfloat16 compute dtype."""
        _, skip = model.hwr(image, return_features=True)
        return _pool(skip, frames)

    def _read(self, image: torch.Tensor, frames: torch.Tensor):
        """``(masked log-probs, pooled features or None)`` of one recognizer
        pass: the JAX harness runs the recognizer twice for these, with the
        same weights and inputs."""
        if not self.has_features:
            return self._recog(image, frames), None
        logp, skip = self.model.hwr(image, return_features=True)
        return mask_frames_to_blank(logp, frames), _pool(skip, frames)

    def _time(self, stage: str, t0: float) -> None:
        self.stage_seconds[stage] = (self.stage_seconds.get(stage, 0.0)
                                     + time.perf_counter() - t0)

    # -- pieces ----------------------------------------------------------

    def style_metrics(self, batcher, max_batches: Optional[int] = None,
                      with_features: bool = False,
                      with_real_cer: bool = True) -> Dict:
        """Style-space metrics from one sweep of the split; with
        ``with_features`` the real lines' FID features come from the same
        ``inference_mode`` call as each batch's extraction (a ``tap``).

        ``with_real_cer`` decodes the recognizer log-probs the sweep
        computes anyway against the real lines' transcriptions: the same
        reader and greedy decoding :meth:`generate_and_read` applies to
        generated lines, so ``gen_CER - real_CER`` compares like with like.
        """
        t0 = time.perf_counter()
        ext = StyleExtractor(self.model,
                             tap=self._feat_fn if with_features else None,
                             device=self.device)
        gts: List[str] = []
        _mark(f"style sweep start (max_batches={max_batches})")
        data = ext.extract_dataset(
            batcher, max_batches, with_pred=with_real_cer,
            on_batch=(lambda b: gts.extend(b["gt"])) if with_real_cer
            else None)
        feats = data.get("tap", [])
        _mark(f"style sweep done ({len(data['ids'])} groups)")
        out = {}
        out.update({f"style_{k}": v
                    for k, v in inter_intra_distances(data).items()})
        out.update({f"writer_id_{k}": v
                    for k, v in writer_id_retrieval(data).items()})
        if with_real_cer:
            preds: List[str] = []
            for logp in data["pred"]:
                preds.extend(ctc_greedy_decode_batch(logp, self.charset))
            cer, wer = batch_cer_wer(gts, preds)
            out["real_CER"], out["real_WER"] = cer, wer
        _mark("style metrics computed")
        self._style_bank = np.asarray(data["styles"])
        self._real_feats = (np.concatenate(feats, axis=0) if feats
                            else None)
        self._time("style_sweep", t0)
        return out

    @torch.inference_mode()
    def generate_and_read(self, texts: Sequence[str], bank: np.ndarray,
                          batch: int = 32,
                          mix_range=(-0.5, 1.5),
                          out_dir: Optional[str] = None,
                          degrade: bool = False) -> Dict:
        """Render ``texts`` with interpolated bank styles; the frozen
        recognizer reads them back.  Returns gen-CER/WER, the generated
        lines' features and the decoded strings.  The last chunk is padded
        to ``batch`` with its last text; the padding is dropped from every
        result.

        ``degrade``: also read a copy run through the v3 post-render
        degradation (``data.synthetic.degrade_image``: elastic warp,
        brightness, blur, noise), each line seeded ``seed + start * batch +
        b``: real v3 lines carry those post-ops and raw generator output
        does not, so the degraded readback is the matched-domain comparison
        against ``real_CER``.
        """
        if not len(texts):
            raise ValueError(
                "generate_and_read: no texts to render — pass --texts, set "
                "data.text_data, or use a split with real transcriptions")
        if not len(bank):
            raise ValueError(
                "generate_and_read: empty style bank — the style-extraction "
                "pass produced no styles (empty split?)")
        from handwriting_line_generation_tpu_torch.data.synthetic import (
            degrade_image, normalize_image,
        )
        from handwriting_line_generation_tpu_torch.ops.augment import \
            quantize_image_u8
        t_all = time.perf_counter()
        deg_secs = 0.0
        session = GenerationSession(self.model, self.charset,
                                    device=self.device)
        rng = np.random.default_rng(self.seed)
        label_len = max(max(len(t) for t in texts), 1)
        preds: List[str] = []
        preds_deg: List[str] = []
        feats: List[np.ndarray] = []
        dumped = 0
        _mark(f"gen+readback start ({len(texts)} texts, batch={batch})")
        for s in range(0, len(texts), batch):
            chunk = list(texts[s:s + batch])
            pad = batch - len(chunk)
            keep = batch - pad
            chunk += [chunk[-1]] * pad
            idx = rng.integers(0, len(bank), size=(batch, 2))
            mix = rng.uniform(*mix_range, size=(batch, 1))
            styles = bank[idx[:, 0]] * mix + bank[idx[:, 1]] * (1 - mix)
            image = session.render_tensor(chunk, styles, seed=self.seed + s,
                                          label_len=label_len)
            frames = torch.full((batch,), image.shape[2] // 4,
                                dtype=torch.int64, device=self.device)
            logp, feat = self._read(image, frames)
            preds.extend(ctc_greedy_decode_batch(
                logp.cpu().numpy(), self.charset)[:keep])
            img = (image.float().cpu().numpy() if degrade or out_dir
                   else None)
            if degrade:
                t0 = time.perf_counter()
                deg = np.stack([
                    normalize_image(degrade_image(
                        quantize_image_u8(img[b, ..., 0]),
                        np.random.default_rng(self.seed + s * batch + b)))
                    for b in range(batch)])[..., None]
                deg_secs += time.perf_counter() - t0
                logp_d = self._recog(
                    torch.from_numpy(deg).to(self.device), frames)
                preds_deg.extend(ctc_greedy_decode_batch(
                    logp_d.cpu().numpy(), self.charset)[:keep])
            if feat is not None:
                feats.append(feat[:keep].cpu().numpy())
            if out_dir and dumped < 16:
                os.makedirs(out_dir, exist_ok=True)
                for b in range(min(keep, 16 - dumped)):
                    write_png_gray(
                        os.path.join(out_dir, f"gen_{dumped:03d}.png"),
                        to_uint8(img[b]))
                    dumped += 1
        cer, wer = batch_cer_wer(list(texts), preds)
        _mark("gen+readback done")
        out = {"gen_CER": cer, "gen_WER": wer,
               "features": (np.concatenate(feats, axis=0)
                            if feats else None),
               "preds": preds}
        if degrade:
            cer_d, wer_d = batch_cer_wer(list(texts), preds_deg)
            out["gen_CER_degraded"] = cer_d
            out["gen_WER_degraded"] = wer_d
            self.stage_seconds["degrade"] = (
                self.stage_seconds.get("degrade", 0.0) + deg_secs)
        self.stage_seconds["gen_readback"] = (
            self.stage_seconds.get("gen_readback", 0.0)
            + time.perf_counter() - t_all - deg_secs)
        return out

    # -- the one call ----------------------------------------------------

    def run(self, batcher, texts: Sequence[str],
            max_batches: Optional[int] = None,
            gen_batch: int = 32,
            out_dir: Optional[str] = None,
            degrade: bool = True) -> Dict:
        """The full quality pass.  Headline metrics: **fid_hwr** and
        **writer_id_top1**; the CER family is reported beside the same
        reader's ``real_CER`` (the realism gaps), since gen-CER falls below
        the corpus's own once generated lines read cleaner than real
        ones."""
        self.stage_seconds = {}
        out = self.style_metrics(batcher, max_batches,
                                 with_features=self.has_features)
        gen = self.generate_and_read(texts, self._style_bank,
                                     batch=gen_batch, out_dir=out_dir,
                                     degrade=degrade)
        for k in ("gen_CER", "gen_WER", "gen_CER_degraded",
                  "gen_WER_degraded"):
            if k in gen:
                out[k] = gen[k]
        if "real_CER" in out:
            out["realism_gap"] = out["gen_CER"] - out["real_CER"]
            if "gen_CER_degraded" in out:
                out["realism_gap_degraded"] = (out["gen_CER_degraded"]
                                               - out["real_CER"])
        if self.has_features and self._real_feats is not None:
            t0 = time.perf_counter()
            out["fid_hwr"] = frechet_distance(self._real_feats,
                                              gen["features"])
            self._time("fid", t0)
        return out
