"""The reference of a generation request, and the numbers that judge one.

A request is texts and styles rendered at ``spaced_len`` positions with a
noise seed, the program's ``GenerationSession.render_tensor``: the spacer
predicts each character's blanks and duplicates, ``insert_spaces`` rounds
them (no jitter) into a spaced class map, and the generator renders the
map in the style, its noise planes drawn from a ``torch.Generator`` seeded
with ``seed + 1`` in the compute type.

The judgement follows the program stage by stage:

* ``count_gap``: the widest gap between the program's counts (the
  spacer's output) and the reference's, over the characters of each line;
* ``spaced_mismatch``: the positions where the program's spaced map
  differs from the reference's ``insert_spaces`` of the program's counts
  (exact: rounding a count that sits on a half is a coin toss between two
  right answers, so the map is judged given the counts, which the first
  number judges);
* ``image_gap``: over the lines, the largest ``|img - ref| / |ref|`` (L2
  over the line's pixels), the reference rendering the program's spaced
  map in the same style with the same noise.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from reference.charset import Charset
from reference.ops import rows
from reference.ops.spacing import insert_spaces, onehot


def encode(charset: Charset, texts: Sequence[str], device):
    """Labels ``[B, L]`` (0-padded to the longest) and lengths."""
    labels = [charset.encode(t) for t in texts]
    L = max(max(len(l) for l in labels), 1)
    out = np.zeros((len(texts), L), np.int64)
    lens = np.zeros(len(texts), np.int64)
    for i, l in enumerate(labels):
        out[i, :len(l)] = l
        lens[i] = len(l)
    return (torch.from_numpy(out).to(device),
            torch.from_numpy(lens).to(device))


def noise_planes(model, batch: int, spaced_len: int, seed: int,
                 dtype: torch.dtype, device) -> List[torch.Tensor]:
    """The ten noise planes the generator draws for a request of ``batch``
    lines, in its order, from a generator seeded ``seed + 1``."""
    g = torch.Generator(device).manual_seed(seed + 1)
    out = []
    for h, w in model.generator.noise_shapes(spaced_len):
        for _ in range(2):
            out.append(rows.randn((batch, h, w), g, device=device,
                                  dtype=dtype))
    return out


@torch.no_grad()
def counts(model, label, lens, style) -> torch.Tensor:
    return model.spacer(onehot(label, model.cfg.num_class), style)


@torch.no_grad()
def spaced_from_counts(model, label, lens, cnt, spaced_len: int):
    spaced, _ = insert_spaces(label, lens, cnt.float(), None,
                              max_len=spaced_len, count_std=0.0,
                              dup_std=0.0,
                              count_duplicates=model.cfg.spacer
                              .count_duplicates)
    return spaced


@torch.no_grad()
def render(model, spaced, style, noise) -> torch.Tensor:
    return model.generator(onehot(spaced, model.cfg.num_class), style,
                           noise=noise)


@torch.no_grad()
def request(model, charset, texts, styles, seed: int, spaced_len: int,
            noise_dtype: torch.dtype, device, block: int = 128) -> Dict:
    """The whole request by the reference model, as the program runs it:
    ``{"image", "counts", "spaced"}`` (the control's output)."""
    label, lens = encode(charset, texts, device)
    style = torch.as_tensor(np.asarray(styles, np.float32), device=device)
    noise = noise_planes(model, len(texts), spaced_len, seed, noise_dtype,
                         device)
    imgs, cnts, sps = [], [], []
    for a in range(0, len(texts), block):
        sl = slice(a, a + block)
        c = counts(model, label[sl], lens[sl], style[sl])
        sp = spaced_from_counts(model, label[sl], lens[sl], c, spaced_len)
        imgs.append(render(model, sp, style[sl], [n[sl] for n in noise]))
        cnts.append(c)
        sps.append(sp)
    return {"image": torch.cat(imgs), "counts": torch.cat(cnts),
            "spaced": torch.cat(sps)}


@torch.no_grad()
def judge(model, charset, texts, styles, seed: int, spaced_len: int,
          noise_dtype: torch.dtype, out: Dict, device,
          block: int = 128) -> Dict[str, float]:
    """The three numbers for one request whose output (``image``,
    ``counts``, ``spaced``) is ``out``."""
    label, lens = encode(charset, texts, device)
    style = torch.as_tensor(np.asarray(styles, np.float32), device=device)
    noise = noise_planes(model, len(texts), spaced_len, seed, noise_dtype,
                         device)
    count_gap, mismatch, image_gap = 0.0, 0, 0.0
    for a in range(0, len(texts), block):
        sl = slice(a, a + block)
        c_prog = out["counts"][sl].float().to(device)
        c_ref = counts(model, label[sl], lens[sl], style[sl])
        valid = (torch.arange(label.shape[1], device=device)[None, :]
                 < lens[sl][:, None])[..., None]
        gap = torch.where(valid, (c_prog - c_ref).abs(), 0.0)
        count_gap = max(count_gap, float(gap.max()))
        sp_prog = out["spaced"][sl].long().to(device)
        sp_ref = spaced_from_counts(model, label[sl], lens[sl], c_prog,
                                    spaced_len)
        mismatch += int((sp_prog != sp_ref).sum())
        ref = render(model, sp_prog, style[sl], [n[sl] for n in noise])
        img = out["image"][sl].float().to(device)
        num = (img - ref).flatten(1).norm(dim=1)
        den = ref.flatten(1).norm(dim=1).clamp(min=1e-12)
        image_gap = max(image_gap, float((num / den).max()))
    return {"count_gap": count_gap, "spaced_mismatch": float(mismatch),
            "image_gap": image_gap}
