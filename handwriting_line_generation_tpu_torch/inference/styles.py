"""Batched style extraction over datasets, the style bank's files, and
style-space statistics.

Counterpart of ``handwriting_line_generation_tpu/inference/styles.py``:
iterate a batcher, run ``HWWithStyle.extract_style`` per batch of author
groups, and keep one ``{styles, authors, ids}`` row per group; and the
served reconstruction (:meth:`StyleExtractor.reconstruct`), which the
evaluator and the ``spaced_loc`` cache run.  Banks are
``.npz`` files in the JAX package's layout, so they move between the two
packages.  ``umap_embed`` keeps JAX's try-UMAP-else-PCA, and
``plot_style_map`` draws its scatter on ``utils/raster_plot.py``'s canvas
where JAX draws with matplotlib.
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from handwriting_line_generation_tpu_torch.device import resolve_device
from handwriting_line_generation_tpu_torch.models.hw_with_style import (
    RECON_ROOT, HWWithStyle, pack_style,
)
from handwriting_line_generation_tpu_torch.utils.colormap import TAB20
from handwriting_line_generation_tpu_torch.utils.png import read_png_gray
from handwriting_line_generation_tpu_torch.utils.raster_plot import (
    Canvas, data_limits,
)
from handwriting_line_generation_tpu_torch.utils import tracing

# the JAX plot's figure: 8 x 8 in at 120 dpi; ``scatter(s=12)``: a dot of
# sqrt(12) points across; thumbnails at ``OffsetImage(zoom=0.25)``
STYLE_MAP_PX = 8 * 120
STYLE_DOT_RADIUS = 12 ** 0.5 / 2 * 120 / 72
THUMB_ZOOM = 0.25


class StyleExtractor:
    """A model on a device, extracting styles batch by batch.

    ``device`` defaults to ``cuda`` and raises without a GPU; pass
    ``device="cpu"`` to run on the CPU.  The model is moved there and put
    in eval mode.  ``tap(model, image, frames)``: extra device work run in
    the same ``inference_mode`` call as each batch's extraction (the
    quality harness's FID features); its per-batch outputs come back from
    :meth:`extract_dataset` under ``'tap'``."""

    def __init__(self, model: HWWithStyle, tap: Optional[Callable] = None,
                 device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.tap = tap

    @torch.inference_mode()
    def extract(self, image: torch.Tensor, frames: torch.Tensor,
                a_batch_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(packed style [B, D], pred [B, T, C])`` of device tensors; the
        recognizer frames past ``frames`` are masked to blank, as training
        masks them.  Tuple styles come packed ``[g | spacing | char.flat]``
        (identity for single styles)."""
        with tracing.span("style.extract"):
            style, pred = self.model.extract_style(image, a_batch_size,
                                                   frame_lengths=frames)
            with tracing.span("style.char_style"):
                return pack_style(style), pred

    @torch.inference_mode()
    def reconstruct(self, image: torch.Tensor, frames: torch.Tensor,
                    labels: torch.Tensor, label_lengths: torch.Tensor,
                    a_batch_size: int, generator: torch.Generator,
                    pred: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Each line regenerated in its writer's extracted style, in one
        :meth:`HWWithStyle.autoencode`: the recognizer once, its
        prediction masked past ``frames`` feeding both the style and the
        CTC forced alignment to ``labels``, then the generator, whose
        noise planes ``generator`` draws.  ``pred``: the recognizer's
        unmasked log-probs of ``image``, when the caller has them.

        Returns device tensors ``(recon [B, 64, 4T, 1], spaced_label [B,
        T], packed style [B/a, D])``, one style row an author."""
        with tracing.span(RECON_ROOT):
            recon, aux = self.model.autoencode(
                image, labels, label_lengths, a_batch_size,
                frame_lengths=frames, pred=pred, generator=generator)
            return (recon, aux["spaced_label"],
                    pack_style(aux["style"])[::a_batch_size])

    def extract_dataset(self, batcher, max_batches: Optional[int] = None,
                        through_emb: bool = False, on_batch=None,
                        with_pred: bool = False) -> Dict:
        """-> ``{'styles': [N, D], 'authors': [N], 'ids': [N]}``, one row
        per author group in the batcher's unshuffled order.

        ``through_emb``: pass the styles through the generator's style MLP.
        ``on_batch(batch)``: called on every batch consumed.
        ``with_pred``: also return each batch's frame-masked recognizer
        log-probs under ``'pred'``.  With a ``tap``, its outputs come under
        ``'tap'``.  A group's id is its records' ids joined by ";" (so a
        bank row can be kept from the lines it came from), or
        ``<author>_<batch>_<row>`` when the records have none.  The loop
        only enqueues device work; the host waits once, at the end."""
        styles, authors, ids, preds, taps = [], [], [], [], []
        rng = np.random.default_rng(0)
        for i, batch in enumerate(batcher.batches(rng, shuffle=False)):
            if max_batches is not None and i >= max_batches:
                break
            if on_batch is not None:
                on_batch(batch)
            a = batch.get("a_batch_size", 1)
            image = torch.as_tensor(batch["image"]).to(self.device)
            width = torch.as_tensor(batch["width"]).to(self.device)
            frames = torch.clamp((width + 3) // 4, 1, image.shape[2] // 4)
            with torch.inference_mode():
                style, pred = self.extract(image, frames, a)
                if self.tap is not None:
                    taps.append(self.tap(self.model, image, frames))
            if with_pred:
                preds.append(pred)
            if through_emb:
                with torch.inference_mode():
                    style = self.model.generator.style_mlp(style)
            styles.append(style[::a])
            authors.extend(batch["author"][::a])
            rids = batch.get("rid")
            for j in range(0, len(batch["author"]), a):
                if rids and any(rids[j:j + a]):
                    ids.append(";".join(rids[j:j + a]))
                else:
                    ids.append(f"{batch['author'][j]}_{i}_{j}")
        out = {"styles": torch.cat(styles).float().cpu().numpy(),
               "authors": authors, "ids": ids}
        if self.tap is not None:
            out["tap"] = [t.cpu().numpy() for t in taps]
        if with_pred:
            out["pred"] = [p.cpu().numpy() for p in preds]
        return out


def save_styles(path: str, data: Dict) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    np.savez_compressed(path, styles=data["styles"],
                        authors=np.array(data["authors"]),
                        ids=np.array(data["ids"]))


def load_styles(path: str) -> Dict:
    z = np.load(path, allow_pickle=True)
    return {"styles": z["styles"], "authors": list(z["authors"]),
            "ids": list(z["ids"])}


def styles_by_author(data: Dict) -> Dict[str, np.ndarray]:
    """Author -> ``[n_i, D]`` stack of that author's styles."""
    by: Dict[str, List[np.ndarray]] = defaultdict(list)
    for s, a in zip(data["styles"], data["authors"]):
        by[str(a)].append(s)
    return {a: np.stack(v) for a, v in by.items()}


def _distances(styles: np.ndarray, metric: str) -> np.ndarray:
    if metric == "l1":
        return np.sum(np.abs(styles[:, None] - styles[None, :]), axis=-1)
    return np.linalg.norm(styles[:, None] - styles[None, :], axis=-1)


def inter_intra_distances(data: Dict, metric: str = "l2") -> Dict[str, float]:
    """Mean and std of the style distances between lines of one author
    (intra) and of different authors (inter)."""
    authors = np.asarray(data["authors"])
    d = _distances(np.asarray(data["styles"]), metric)
    same = authors[:, None] == authors[None, :]
    triu = np.triu(np.ones_like(same, bool), 1)
    intra = d[same & triu]
    inter = d[~same & triu]
    return {"intra_mean": float(intra.mean()) if intra.size else 0.0,
            "intra_std": float(intra.std()) if intra.size else 0.0,
            "inter_mean": float(inter.mean()) if inter.size else 0.0,
            "inter_std": float(inter.std()) if inter.size else 0.0}


def writer_id_retrieval(data: Dict, metric: str = "l2",
                        ks: Tuple[int, ...] = (1, 5, 20)) -> Dict[str, float]:
    """Top-k same-author retrieval rate of each style's nearest neighbours,
    and the mean rank of the first same-author one."""
    authors = np.asarray(data["authors"])
    d = _distances(np.asarray(data["styles"]), metric)
    n = len(d)
    np.fill_diagonal(d, np.inf)
    order = np.argsort(d, axis=1)
    same = authors[order] == authors[:, None]
    out = {f"top{k}": float(np.mean(same[:, :k].any(axis=1))) for k in ks}
    first_hit = np.argmax(same, axis=1)
    has_hit = same.any(axis=1)
    out["mean_rank"] = float(np.mean(np.where(has_hit, first_hit, n)))
    return out


def umap_embed(data: Dict, n_components: int = 2) -> np.ndarray:
    """2-D embedding of the styles for plotting: UMAP when the ``umap``
    package is installed, else PCA by numpy's SVD (float64)."""
    styles = np.asarray(data["styles"], np.float64)
    try:
        import umap                                     # pragma: no cover
        return umap.UMAP(n_components=n_components).fit_transform(styles)
    except ImportError:
        x = styles - styles.mean(0)
        _, _, vt = np.linalg.svd(x, full_matrices=False)
        return x @ vt[:n_components].T


def plot_style_map(data: Dict, path: str, author_mean: bool = False,
                   thumbnail_dir: Optional[str] = None) -> Dict:
    """The 2-D embedding of the styles (:func:`umap_embed`) as a 960 x
    960 RGB PNG, the JAX ``plot_style_map``'s figure: one dot a style
    in ``TAB20[i % 20]``, ``i`` its author's index in
    ``sorted(set(map(str, authors)))``; with ``author_mean``, one style
    an author (the mean of :func:`styles_by_author`); with
    ``thumbnail_dir``, each style's ``<id>.png`` (when it exists)
    area-averaged to a quarter and centred on its point; a legend of the
    authors when there are at most 20, in the corner that covers the
    fewest points. Returns the embedding and each author's index
    (``{"embedding", "author_index"}``)."""
    if author_mean:
        by = styles_by_author(data)
        data = {"styles": np.stack([v.mean(0) for v in by.values()]),
                "authors": list(by.keys()), "ids": list(by.keys())}
    emb = umap_embed(data)
    authors = np.asarray([str(a) for a in data["authors"]])
    uniq = sorted(set(authors.tolist()))
    canvas = Canvas(STYLE_MAP_PX, STYLE_MAP_PX, data_limits(emb[:, 0]),
                    data_limits(emb[:, 1]))
    canvas.frame()
    index = np.searchsorted(uniq, authors)
    for i, a in enumerate(uniq):
        m = index == i
        canvas.scatter(emb[m, 0], emb[m, 1], TAB20[i % 20],
                       STYLE_DOT_RADIUS)
    if thumbnail_dir:
        for j, sid in enumerate(map(str, data["ids"])):
            f = os.path.join(thumbnail_dir, f"{sid}.png")
            if os.path.exists(f):
                canvas.image(read_png_gray(f), emb[j, 0], emb[j, 1],
                             THUMB_ZOOM)
    if len(uniq) <= 20:
        canvas.legend([(a, TAB20[i % 20], "dot")
                       for i, a in enumerate(uniq)],
                      avoid=canvas.transform(emb[:, 0], emb[:, 1]))
    canvas.save(path)
    return {"embedding": emb, "author_index": index}
