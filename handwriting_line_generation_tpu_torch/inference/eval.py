"""Evaluation harness and render helpers.

Counterpart of ``handwriting_line_generation_tpu/inference/eval.py``: run
the model over a dataset split, average CER/WER and the reconstruction loss
per batch, dump original-vs-reconstruction side-by-side images and
generated-line images, and the side-channel style / spaced-label /
prediction / nearest-neighbour files, with the JAX package's names and
headers.

Torch cannot reproduce JAX's random draws, so the fixed keys of the JAX
evaluator become fixed ``torch.Generator`` seeds in the same places: the
autoencode noise from seed 0, the generation noise from seed 1 and its
spacing jitter from seed 0.  Greedy decoding, the error rates and the
nearest-neighbour distances run on the host, as there.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from handwriting_line_generation_tpu_torch.charset import (
    Charset, ctc_greedy_decode_batch,
)
from handwriting_line_generation_tpu_torch.device import resolve_device
from handwriting_line_generation_tpu_torch.inference.styles import \
    StyleExtractor
from handwriting_line_generation_tpu_torch.models.hw_with_style import \
    HWWithStyle
from handwriting_line_generation_tpu_torch.ops.ctc import mask_frames_to_blank
from handwriting_line_generation_tpu_torch.utils.error_rates import (
    batch_cer_wer, cer as cer_fn,
)
from handwriting_line_generation_tpu_torch.utils.png import write_png_gray


def _to_u8(img: np.ndarray) -> np.ndarray:
    return ((1.0 - img[..., 0]) * 127.5).clip(0, 255).astype(np.uint8)


def side_by_side(orig: np.ndarray, recon: np.ndarray,
                 border: int = 2) -> np.ndarray:
    """Original above reconstruction with a black divider of ``border``
    rows, per sample (``hwdataset_eval.py:114-264`` layout)."""
    o, r = _to_u8(orig), _to_u8(recon)
    w = max(o.shape[1], r.shape[1])
    pad = lambda x: np.pad(x, ((0, 0), (0, w - x.shape[1])),
                           constant_values=255)
    div = np.zeros((border, w), np.uint8)
    return np.concatenate([pad(o), div, pad(r)], axis=0)


def _csv(s: str) -> str:
    return s.replace('"', '""')


class Evaluator:
    """A model on a device, evaluated over a split.

    ``device`` defaults to ``cuda`` and raises without a GPU; pass
    ``device="cpu"`` to run on the CPU.  The model is moved there and put
    in eval mode."""

    def __init__(self, model: HWWithStyle, charset: Charset, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.charset = charset
        self.extractor = StyleExtractor(self.model, device=self.device)

    def _seeded(self, seed: int) -> torch.Generator:
        return torch.Generator(self.device).manual_seed(seed)

    def generate(self, label, lens, style, spaced_len: int) -> torch.Tensor:
        """Each label in the given style: spacing jitter from seed 0, the
        generator's noise from seed 1."""
        style = self.model._style_tuple(style)
        spaced, _ = self.model.space(label, lens, style,
                                     spaced_len=spaced_len,
                                     generator=self._seeded(0))
        return self.model.generate_spaced(spaced, style,
                                          generator=self._seeded(1))

    @torch.inference_mode()
    def run(self, batcher, max_batches: Optional[int] = None,
            out_dir: Optional[str] = None,
            save_images: bool = False,
            save_styles: bool = False,
            save_spaced: bool = False,
            save_preds: bool = False,
            save_nns: bool = False,
            save_gen: bool = False) -> Dict:
        """Metrics averaged over the batches of a split (``CER``, ``WER``
        and, with a style extractor and a generator, ``autoLoss``), and the
        side channels the flags ask for:

        * ``save_images``: ``recon_<batch>_<b>.png``, the original above its
          reconstruction, for the first 4 lines of each batch;
        * ``save_styles``: ``styles.npz`` (``styles``, ``authors``), one row
          per author group;
        * ``save_spaced``: ``spaced.npz``, each line's aligned spaced label
          keyed by its record id;
        * ``save_preds``: ``preds.csv``, each line's ground truth, greedy
          decoding and CER;
        * ``save_nns``: ``nns.csv``, each line's three nearest neighbours in
          style space with their authors and distances;
        * ``save_gen``: ``gen_<batch>_<b>.png``, each of the first 4 lines'
          text rendered in its own extracted style.
        """
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
        cfg = self.model.cfg
        reconstruct = (cfg.style.kind != "none"
                       and cfg.generator.kind != "none")
        dev = self.device
        totals: Dict[str, float] = {}
        styles_acc: List[np.ndarray] = []
        nn_styles: List[np.ndarray] = []
        nn_authors: List[str] = []
        spaced_acc: Dict[str, np.ndarray] = {}
        authors: List[str] = []
        pred_rows: List[str] = []
        n = 0
        rng = np.random.default_rng(0)
        for i, batch in enumerate(batcher.batches(rng, shuffle=False)):
            if max_batches is not None and i >= max_batches:
                break
            image = torch.as_tensor(batch["image"]).to(dev)
            label = torch.as_tensor(batch["label"]).to(dev)
            lens = torch.as_tensor(batch["label_lengths"]).to(dev)
            # frames past each line's ink are masked to blank
            width = torch.as_tensor(batch["width"]).to(dev)
            frames = torch.clamp((width + 3) // 4, 1, image.shape[2] // 4)
            raw = self.model.recognize(image)
            preds = ctc_greedy_decode_batch(
                mask_frames_to_blank(raw, frames).cpu().numpy(), self.charset)
            cer, wer = batch_cer_wer(batch["gt"], preds)
            totals["CER"] = totals.get("CER", 0) + cer
            totals["WER"] = totals.get("WER", 0) + wer
            if save_preds:
                for b, (gt, pr) in enumerate(zip(batch["gt"], preds)):
                    au = batch["author"][b] if "author" in batch else ""
                    pred_rows.append(
                        f'{n},{b},"{au}","{_csv(gt)}","{_csv(pr)}",'
                        f"{cer_fn(gt, pr):.4f}")
            if reconstruct:
                a = batch.get("a_batch_size", 1)
                # the extraction reads the recognizer pass above
                recon, spaced, style = self.extractor.reconstruct(
                    image, frames, label, lens, a, self._seeded(0),
                    pred=raw)
                packed = None
                if save_nns or save_styles:
                    packed = style.float().cpu().numpy()
                if save_nns:
                    nn_styles.append(np.repeat(packed, a, axis=0))
                    nn_authors.extend(batch.get(
                        "author", [""] * image.shape[0]))
                auto = (recon - image).abs().mean().item()
                totals["autoLoss"] = totals.get("autoLoss", 0) + auto
                if save_styles:
                    styles_acc.append(packed)
                    authors.extend(batch["author"][::a])
                if save_spaced:
                    # keyed by record id: the dataset's spaced_loc cache
                    # reads these back per line
                    sl = spaced.cpu().numpy()
                    for b, rid in enumerate(batch.get(
                            "rid", [f"{i}-{b}" for b in range(len(sl))])):
                        spaced_acc[rid or f"{i}-{b}"] = sl[b]
                if save_images and out_dir:
                    rec = recon[:4].float().cpu().numpy()
                    for b in range(min(4, image.shape[0])):
                        write_png_gray(
                            os.path.join(out_dir, f"recon_{i}_{b}.png"),
                            side_by_side(np.asarray(batch["image"][b]),
                                         rec[b]))
                if save_gen and out_dir:
                    gen = self.generate(label, lens,
                                        style.repeat_interleave(a, dim=0),
                                        image.shape[2] // 4)
                    gen = gen[:4].float().cpu().numpy()
                    for b in range(min(4, image.shape[0])):
                        write_png_gray(
                            os.path.join(out_dir, f"gen_{i}_{b}.png"),
                            _to_u8(gen[b]))
            n += 1
        out = {k: v / max(n, 1) for k, v in totals.items()}
        if save_styles and styles_acc:
            np.savez_compressed(
                os.path.join(out_dir or ".", "styles.npz"),
                styles=np.concatenate(styles_acc), authors=np.array(authors))
        if save_spaced and spaced_acc and out_dir:
            np.savez_compressed(os.path.join(out_dir, "spaced.npz"),
                                **spaced_acc)
        if save_preds and pred_rows:
            with open(os.path.join(out_dir or ".", "preds.csv"), "w") as f:
                f.write("batch,index,author,gt,pred,cer\n")
                f.write("\n".join(pred_rows) + "\n")
        if save_nns and nn_styles:
            _write_nns(os.path.join(out_dir or ".", "nns.csv"),
                       np.concatenate(nn_styles), nn_authors)
        return out


def _write_nns(path: str, s: np.ndarray, authors: List[str]) -> None:
    """Each style's three nearest neighbours (L2, itself excluded)."""
    d = np.linalg.norm(s[:, None] - s[None, :], axis=-1)
    np.fill_diagonal(d, np.inf)
    order = np.argsort(d, axis=1)[:, :3]
    with open(path, "w") as f:
        f.write("index,author,nn1,nn1_author,nn1_dist,"
                "nn2,nn2_author,nn2_dist,nn3,nn3_author,nn3_dist\n")
        for i in range(s.shape[0]):
            cells = [str(i), f'"{authors[i]}"']
            for j in order[i]:
                cells += [str(j), f'"{authors[j]}"', f"{d[i, j]:.4f}"]
            f.write(",".join(cells) + "\n")
