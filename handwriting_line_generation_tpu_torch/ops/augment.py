"""Device-side augmentation for the HWR step.

Counterpart of the ``"warp"`` and ``"affine"`` kinds of
``handwriting_line_generation_tpu/ops/augment.py``, batched:

* :func:`tensmeyer_brightness` — per-image Otsu split, then separate
  foreground / background brightness shifts;
* :func:`grid_warp` — a coarse grid of normal offsets (std 1.5, 12 px
  spacing) upsampled bilinearly to a dense flow, then bilinear resampling;
* :func:`affine_slant_stretch` — horizontal shear about mid-height and a
  horizontal stretch, by inverse bilinear sampling;
* :func:`dequantize_image` — u8 pixels to the normalized range on the
  device, and :func:`quantize_image_u8` (numpy) back;
* :func:`fg_to_float` — a bool foreground mask to float32 on the device.

Images are normalized (``1 - px/128``: background -1, ink ~ +1), NHWC
``[B, H, W, 1]``, as in the JAX package.  Every random function takes a
``torch.Generator`` or its draws as tensors (``shifts=``, ``offsets=``,
``skew=``/``stretch=``), so tests can inject the JAX package's draws.  The
``"normalization"`` kind (deskew, skeletonize) and ``change_thickness`` are
not ported yet.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from handwriting_line_generation_tpu_torch.ops import rows


def _to_u8_scale(img: torch.Tensor) -> torch.Tensor:
    """normalized -> [0, 255] float (paper 255, ink 0)."""
    return torch.clamp((1.0 - img) * 128.0, 0.0, 255.0)


def _from_u8_scale(u8: torch.Tensor) -> torch.Tensor:
    return 1.0 - u8 / 128.0


def otsu_threshold(img_u8: torch.Tensor, nbins: int = 64) -> torch.Tensor:
    """Per-image Otsu threshold of ``[B, H, W, 1]`` [0, 255]-scaled images:
    ``[B]``, the centre of the bin that maximizes the between-class
    variance (the first, on ties)."""
    B = img_u8.shape[0]
    flat = img_u8.reshape(B, -1)
    edges = torch.linspace(0.0, 255.0, nbins + 1, device=img_u8.device)
    centers = (edges[:-1] + edges[1:]) / 2
    idx = torch.clamp((flat / (256.0 / nbins)).to(torch.int64), 0, nbins - 1)
    hist = torch.zeros((B, nbins), device=img_u8.device)
    hist.scatter_add_(1, idx, torch.ones_like(flat))
    w0 = torch.cumsum(hist, dim=1)
    w1 = w0[:, -1:] - w0
    s0 = torch.cumsum(hist * centers, dim=1)
    mu0 = s0 / torch.clamp(w0, min=1e-6)
    mu1 = (s0[:, -1:] - s0) / torch.clamp(w1, min=1e-6)
    between = w0 * w1 * (mu0 - mu1) ** 2
    return centers[torch.argmax(between, dim=1)]


def tensmeyer_brightness(img: torch.Tensor,
                         generator: Optional[torch.Generator] = None,
                         sigma: float = 30.0,
                         shifts: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Random foreground / background brightness shifts split at each
    image's Otsu threshold.  ``shifts``: ``[B, 2]`` standard normals
    (foreground, background), drawn from ``generator`` when None."""
    B = img.shape[0]
    if shifts is None:
        shifts = rows.randn((B, 2), generator, device=img.device)
    u8 = _to_u8_scale(img)
    th = otsu_threshold(u8)
    is_bg = (u8 > th[:, None, None, None]).to(img.dtype)
    fg = (sigma * shifts[:, 0])[:, None, None, None]
    bg = (sigma * shifts[:, 1])[:, None, None, None]
    out = u8 + (1.0 - is_bg) * fg + is_bg * bg
    return _from_u8_scale(torch.clamp(out, 0.0, 255.0))


def _bilinear_sample(im: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                     fill: float) -> torch.Tensor:
    """Sample ``im [B, H, W]`` at float coordinates ``ys, xs [B, H', W']``;
    taps outside the image read ``fill``."""
    B, H, W = im.shape
    y0 = torch.floor(ys).to(torch.int64)
    x0 = torch.floor(xs).to(torch.int64)
    dy = ys - y0
    dx = xs - x0
    flat = im.reshape(B, -1)

    def get(yy, xx):
        ok = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        i = torch.clamp(yy, 0, H - 1) * W + torch.clamp(xx, 0, W - 1)
        v = torch.gather(flat, 1, i.reshape(B, -1)).reshape(yy.shape)
        return torch.where(ok, v, fill)

    return ((1 - dy) * (1 - dx) * get(y0, x0)
            + (1 - dy) * dx * get(y0, x0 + 1)
            + dy * (1 - dx) * get(y0 + 1, x0)
            + dy * dx * get(y0 + 1, x0 + 1))


def _grid(H: int, W: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    ys = torch.arange(H, device=device, dtype=torch.float32)[:, None] \
        * torch.ones((1, W), device=device)
    xs = torch.ones((H, 1), device=device) \
        * torch.arange(W, device=device, dtype=torch.float32)[None, :]
    return ys, xs


def affine_slant_stretch(img: torch.Tensor, skew: torch.Tensor,
                         stretch: torch.Tensor,
                         fill: float = -1.0) -> torch.Tensor:
    """Shear about mid-height by ``tan(skew)`` and stretch horizontally by
    ``stretch`` (both ``[B]``) on a fixed canvas."""
    B, H, W, _ = img.shape
    ys, xs = _grid(H, W, img.device)
    m = torch.tan(skew)[:, None, None]
    src_x = (xs - m * (H / 2 - ys)) / stretch[:, None, None]
    return _bilinear_sample(img[..., 0], ys.expand(B, H, W), src_x,
                            fill)[..., None]


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(..., "bilinear")`` of NHWC ``x`` to ``(H, W)``
    when upsampling: half-pixel centres, edges clamped."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=size, mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1)


def grid_warp(img: torch.Tensor, generator: Optional[torch.Generator] = None,
              std: float = 1.5, spacing: int = 12, fill: float = -1.0,
              offsets: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mesh-distortion warp.  ``offsets``: ``[B, H//spacing + 2,
    W//spacing + 2, 2]`` standard normals (dy, dx) of the coarse grid,
    drawn from ``generator`` when None; scaled by ``std`` and upsampled
    bilinearly to the dense source displacement."""
    B, H, W, _ = img.shape
    if offsets is None:
        offsets = rows.randn((B, H // spacing + 2, W // spacing + 2, 2),
                             generator, device=img.device)
    flow = resize_bilinear(std * offsets, (H, W))
    ys = torch.arange(H, device=img.device)[:, None] + flow[..., 0]
    xs = torch.arange(W, device=img.device)[None, :] + flow[..., 1]
    return _bilinear_sample(img[..., 0], ys, xs, fill)[..., None]


def apply_augmentation(kind: Union[str, bool, None], img: torch.Tensor,
                       fg_mask: Optional[torch.Tensor],
                       generator: Optional[torch.Generator],
                       max_stretch: float = 0.4,
                       max_rot_rad: float = 45 / 180 * 3.14159265,
                       draws: Optional[Mapping[str, torch.Tensor]] = None
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                  torch.Tensor]:
    """Dispatch per ``DataConfig.augmentation``.  Returns ``(image, fg_mask,
    width_scale)``: ``"affine"`` shares one (skew, stretch) draw across the
    batch and reports the stretch; any other non-empty kind but
    ``"normalization"`` is brightness + warp, as is ``True``, which
    reference configs use to mean it.

    ``draws``: precomputed random draws in place of ``generator``'s, as
    tests inject the JAX package's: ``"stretch"`` and ``"skew"`` (scalars)
    for ``"affine"``; ``"shifts"`` and ``"offsets"`` (see
    :func:`tensmeyer_brightness`, :func:`grid_warp`) for brightness + warp."""
    d = draws or {}
    one = torch.ones((), device=img.device)
    if not kind:
        return img, fg_mask, one
    if isinstance(kind, str) and "normalization" in kind:
        raise NotImplementedError(
            "the 'normalization' augmentation (deskew + skeleton) is not "
            "ported yet (ROADMAP.md Queue 1 item 4)")
    B = img.shape[0]
    if isinstance(kind, str) and "affine" in kind:
        if "stretch" in d:
            stretch, skew = (torch.as_tensor(d[k], dtype=img.dtype,
                                             device=img.device)
                             for k in ("stretch", "skew"))
        else:
            u = torch.rand((2,), generator=rows.plain(generator),
                           device=img.device)
            stretch = (1 - max_stretch) + u[0] * (2 * max_stretch)
            skew = -max_rot_rad + u[1] * (2 * max_rot_rad)
        stretch_b, skew_b = stretch.expand(B), skew.expand(B)
        out = affine_slant_stretch(img, skew_b, stretch_b)
        if fg_mask is not None:
            fg_mask = affine_slant_stretch(fg_mask, skew_b, stretch_b,
                                           fill=0.0)
        return out, fg_mask, stretch
    out = tensmeyer_brightness(img, generator, shifts=d.get("shifts"))
    out = grid_warp(out, generator, offsets=d.get("offsets"))
    return out, fg_mask, one


def dequantize_image(img: torch.Tensor,
                     width: Optional[torch.Tensor] = None) -> torch.Tensor:
    """u8 pixels -> normalized float32 (``1 - px/128``); a float image
    passes through.  ``width``: per-sample ink widths; columns past them
    become exactly -1, the pad value u8 cannot hold."""
    if img.dtype != torch.uint8:
        return img
    x = 1.0 - img.float() / 128.0
    if width is not None:
        col = torch.arange(x.shape[2], device=x.device)
        x = torch.where(col[None, None, :, None]
                        < width.to(x.device)[:, None, None, None], x, -1.0)
    return x


def fg_to_float(fg: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A bool foreground mask -> float32 on its device; a float mask (or
    None) passes through."""
    if fg is not None and fg.dtype == torch.bool:
        return fg.float()
    return fg


def quantize_image_u8(img_f32: np.ndarray) -> np.ndarray:
    """Normalized float image -> u8 pixels (inverse of ``1 - px/128``,
    exact for images whose pixels came from u8 sources)."""
    return np.clip(np.rint((1.0 - img_f32) * 128.0), 0, 255).astype(
        np.uint8)
