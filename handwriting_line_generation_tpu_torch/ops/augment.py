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
* :func:`fg_to_float` — a bool foreground mask to float32 on the device;
* the ``"normalization"`` kind: :func:`deskew` (the slant that maximizes
  the variance of the column profile, among 31 candidate shears at once),
  then :func:`normalize_line` (Otsu, :func:`skeletonize` — Zhang-Suen
  thinning by neighbour shifts, 16 iterations —, a cross dilation and a
  3x3 box blur);
* :func:`change_thickness` — ink dilated or eroded by a per-sample radius,
  shaded, blurred and noised (no kind of the dispatch reaches it, in
  either package).

Images are normalized (``1 - px/128``: background -1, ink ~ +1), NHWC
``[B, H, W, 1]``, as in the JAX package.  Every random function takes a
``torch.Generator`` or its draws as tensors (``shifts=``, ``offsets=``,
``skew=``/``stretch=``, ``noise=``), so tests can inject the JAX package's
draws.
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


def change_thickness(img: torch.Tensor, size: torch.Tensor,
                     fg_shade: torch.Tensor, bg_shade: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     blur_size: int = 3, noise_sigma: float = 0.02,
                     noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stroke thickness and shade: each image's Otsu ink (``[B]`` ``size``
    in [-4, 4]: > 0 dilates by a square of radius ``size``, < 0 erodes),
    painted ``fg_shade`` on ``bg_shade`` (``[B]``, in [0, 1]), a
    ``blur_size`` box blur, plus ``noise_sigma`` times ``noise`` (``[B, H,
    W, 1]`` standard normals, drawn from ``generator`` when None), clipped
    to [0, 1] and mapped to [-1, 1]."""
    B = img.shape[0]
    if noise is None:
        noise = rows.randn(img.shape, generator, device=img.device)
    u8 = _to_u8_scale(img)
    th = otsu_threshold(u8)
    ink = (u8 <= th[:, None, None, None]).float().permute(0, 3, 1, 2)
    sz = size.to(img.device).reshape(B, 1, 1, 1)
    r = sz.abs()
    grown, shrunk = ink, ink
    for radius in (1, 2, 3, 4):
        k = 2 * radius + 1
        grown = torch.where((sz > 0) & (r >= radius),
                            F.max_pool2d(ink, k, 1, radius), grown)
        shrunk = torch.where((sz < 0) & (r >= radius),
                             -F.max_pool2d(-ink, k, 1, radius), shrunk)
    out = torch.where(sz > 0, grown, torch.where(sz < 0, shrunk, ink))
    fg = fg_shade.to(img.device).reshape(B, 1, 1, 1)
    bg = bg_shade.to(img.device).reshape(B, 1, 1, 1)
    out = out * (fg - bg) + bg
    box = torch.full((1, 1, blur_size, blur_size), 1.0 / blur_size ** 2,
                     device=img.device)
    out = F.conv2d(out, box, padding=blur_size // 2).permute(0, 2, 3, 1)
    out = out + noise_sigma * noise
    return torch.clamp(out, 0.0, 1.0) * 2.0 - 1.0


def deskew(img: torch.Tensor, n_angles: int = 31, max_slant: float = 1.0,
           fill: float = -1.0) -> torch.Tensor:
    """Remove each image's slant: among ``n_angles`` shears ``m`` in
    [-max_slant, max_slant] about mid-height, the one whose sheared ink
    (the positive part, out-of-image taps 0) has the largest variance of
    its column sums (the first on ties), applied to the image (taps
    outside it read ``fill``)."""
    B, H, W, _ = img.shape
    ys, xs = _grid(H, W, img.device)
    ys, xs = ys.expand(B, H, W), xs.expand(B, H, W)
    ink = torch.clamp(img[..., 0], min=0.0)
    slants = torch.linspace(-max_slant, max_slant, n_angles,
                            device=img.device)
    var = torch.stack([
        _bilinear_sample(ink, ys, xs - m * (H / 2 - ys), 0.0).sum(1)
        .var(dim=1, unbiased=False) for m in slants], dim=1)   # [B, A]
    best = slants[torch.argmax(var, dim=1)][:, None, None]
    return _bilinear_sample(img[..., 0], ys, xs - best * (H / 2 - ys),
                            fill)[..., None]


def _shift2d(m: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Zero-border shift of ``[B, H, W]``: ``out[y, x] = m[y + dy, x +
    dx]``."""
    _, H, W = m.shape
    p = F.pad(m, (1, 1, 1, 1))
    return p[:, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]


def skeletonize(ink: torch.Tensor, iters: int = 16) -> torch.Tensor:
    """Zhang-Suen thinning of a ``[B, H, W]`` {0, 1} map: ``iters``
    iterations of its two sub-passes, each deleting, all at once, the ink
    pixels with 2-6 ink neighbours, one 0 -> 1 transition around them, and
    the sub-pass's two products of neighbours zero.  Returns int32."""
    im = ink.to(torch.int32)

    def sub(im, phase):
        # neighbours clockwise from north: P2..P9 (Zhang-Suen numbering)
        P = [_shift2d(im, -1, 0), _shift2d(im, -1, 1), _shift2d(im, 0, 1),
             _shift2d(im, 1, 1), _shift2d(im, 1, 0), _shift2d(im, 1, -1),
             _shift2d(im, 0, -1), _shift2d(im, -1, -1)]
        n = sum(P)
        seq = P + [P[0]]
        a = sum(((seq[i] == 0) & (seq[i + 1] == 1)).to(torch.int32)
                for i in range(8))
        cond = (im == 1) & (n >= 2) & (n <= 6) & (a == 1)
        if phase == 0:
            cond &= (P[0] * P[2] * P[4] == 0) & (P[2] * P[4] * P[6] == 0)
        else:
            cond &= (P[0] * P[2] * P[6] == 0) & (P[0] * P[4] * P[6] == 0)
        return im * (1 - cond.to(torch.int32))

    for _ in range(iters):
        im = sub(sub(im, 0), 1)
    return im


def normalize_line(img: torch.Tensor) -> torch.Tensor:
    """Strokes to a uniform thickness: each image's Otsu ink, thinned to a
    skeleton, dilated by a 3x3 cross, clipped to 1, box-blurred 3x3, mapped
    to [-1, 1] (ink +1)."""
    u8 = _to_u8_scale(img)
    th = otsu_threshold(u8)
    ink = (u8[..., 0] <= th[:, None, None]).to(torch.int32)
    sk = skeletonize(ink).float()[:, None]
    cross = torch.tensor([[0., 1., 0.], [1., 1., 1.], [0., 1., 0.]],
                         device=img.device)
    d = torch.clamp(F.conv2d(sk, cross[None, None], padding=1), 0.0, 1.0)
    box = torch.full((1, 1, 3, 3), 1.0 / 9.0, device=img.device)
    out = F.conv2d(d, box, padding=1).permute(0, 2, 3, 1)
    return out * 2.0 - 1.0


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
    batch and reports the stretch; ``"normalization"`` deskews and
    normalizes the strokes (no draws); any other non-empty kind is
    brightness + warp, as is ``True``, which reference configs use to mean
    it.

    ``draws``: precomputed random draws in place of ``generator``'s, as
    tests inject the JAX package's: ``"stretch"`` and ``"skew"`` (scalars)
    for ``"affine"``; ``"shifts"`` and ``"offsets"`` (see
    :func:`tensmeyer_brightness`, :func:`grid_warp`) for brightness + warp."""
    d = draws or {}
    one = torch.ones((), device=img.device)
    if not kind:
        return img, fg_mask, one
    if isinstance(kind, str) and "normalization" in kind:
        return normalize_line(deskew(img)), fg_mask, one
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
