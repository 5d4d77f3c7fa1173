"""Blob masks and line-geometry extraction.

Counterpart of ``handwriting_line_generation_tpu/ops/masks.py``: max-pool
the ink image, fill it with cumulative maxima from all four directions
(``torch.cummax``, so the blob hull between strokes is covered), then the
morphology post-ops a config selects (``mask_post: ["thresh",
"dilateCircle", "errodeCircle"]`` in the paper GAN config).  Images are NHWC
``[B, H, W, 1]``, as in the JAX package.

As there, the ``dilate``/``errode`` convolutions are SAME-padded, so masks
keep the image's shape.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F


def _disk(radius: int, device=None) -> torch.Tensor:
    d = 2 * radius + 1
    yy, xx = torch.meshgrid(torch.arange(d, device=device),
                            torch.arange(d, device=device), indexing="ij")
    return (((yy - radius) ** 2 + (xx - radius) ** 2) <= radius ** 2
            ).float()


def _same_pad(k: int) -> Tuple[int, int]:
    """XLA's SAME padding of a stride-1 window of ``k``: (low, high)."""
    return (k - 1) // 2, k - 1 - (k - 1) // 2


def _conv_same(x: torch.Tensor, k2d: torch.Tensor) -> torch.Tensor:
    """``[B, H, W, 1]`` correlated with ``k2d``, zero SAME padding."""
    kh, kw = k2d.shape
    (t, b), (l, r) = _same_pad(kh), _same_pad(kw)
    y = F.conv2d(F.pad(x.permute(0, 3, 1, 2), (l, r, t, b)),
                 k2d[None, None].to(x))
    return y.permute(0, 2, 3, 1)


def _cummax(x: torch.Tensor, dim: int, reverse: bool = False
            ) -> torch.Tensor:
    if reverse:
        return torch.cummax(x.flip(dim), dim).values.flip(dim)
    return torch.cummax(x, dim).values


def make_mask(image: torch.Tensor, post: Optional[List[str]] = None,
              v_kernel: int = 7, h_kernel: int = 31,
              morph_kernel: int = 25) -> torch.Tensor:
    """Blob mask of the written line, ``[B, H, W, 1]`` in {0, 1}."""
    post = post or ["thresh", "dilateCircle", "errodeCircle"]
    (t, b), (l, r) = _same_pad(v_kernel), _same_pad(h_kernel)
    x = F.pad(image.permute(0, 3, 1, 2), (l, r, t, b),
              value=-float("inf"))
    x = F.max_pool2d(x, (v_kernel, h_kernel), stride=1).permute(0, 2, 3, 1)
    down, up = _cummax(x, 1), _cummax(x, 1, reverse=True)
    right, left = _cummax(x, 2), _cummax(x, 2, reverse=True)
    out = torch.minimum(torch.minimum(down, up), torch.minimum(right, left))

    radius = morph_kernel // 2
    for task in post:
        if task == "thresh":
            out = (out > 0.1).float()
        elif task == "smaller":
            radius = radius // 2
        elif task in ("dilate", "dilateCircle", "errode", "errodeCircle"):
            k = (_disk(radius, image.device) if "Circle" in task
                 else torch.ones((2 * radius + 1, 2 * radius + 1),
                                 device=image.device))
            y = _conv_same(out, k)
            out = ((y > 0.1) if task.startswith("dilate")
                   else (y >= k.sum() - 0.5)).float()
        else:
            raise ValueError(f"unknown mask post-op {task!r}")
    return out


def line_geometry(image: torch.Tensor, mask: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-column ``top_and_bottom [B, 2, W]`` ink extents (0 on empty
    columns) and ``center_line [B, W]``: the ink-mass-weighted mean row
    (H/2 on empty columns), smoothed by a 9-wide zero-padded box."""
    if mask is None:
        mask = (image > 0.1).float()
    m = mask[..., 0]                                   # [B, H, W]
    B, H, W = m.shape
    rows = torch.arange(H, device=image.device)[None, :, None]
    any_col = m.sum(dim=1) > 0                         # [B, W]
    top = torch.where(m > 0, rows, H).amin(dim=1)
    bottom = torch.where(m > 0, rows, -1).amax(dim=1)
    top = torch.where(any_col, top, 0)
    bottom = torch.where(any_col, bottom, 0)

    ink = image[..., 0].clamp(min=0.0)
    mass = ink.sum(dim=1)
    center = (ink * rows).sum(dim=1) / mass.clamp(min=1e-6)
    center = torch.where(mass > 1e-3, center, H / 2.0)
    box = torch.full((1, 1, 9), 1.0 / 9.0, device=image.device,
                     dtype=center.dtype)
    center = F.conv1d(center[:, None], box, padding=4)[:, 0]
    top_and_bottom = torch.stack([top, bottom], dim=1).float()
    return top_and_bottom, center
