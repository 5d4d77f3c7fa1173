"""Building blocks of the generation, recognition and style slices, as
``torch.nn`` modules.

Counterpart of ``handwriting_line_generation_tpu/models/layers.py``.
Images are NCHW inside (the generator keeps them in ``channels_last``
memory, so an NHWC view is contiguous); 1-D sequences are ``[B, C, L]``.
Every layer takes the compute dtype and casts its parameters to it at use,
the way flax's ``dtype=`` promotes them; statistics stay float32.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from handwriting_line_generation_tpu_torch.ops import rows


def group_count(channels: int) -> int:
    """Number of GroupNorm groups per the reference's rule: 8 when divisible
    for >= 32 channels, else 4, else the nearest prime factor."""
    if channels <= 1:
        return 1
    goal = 8 if channels >= 32 else 4
    if channels % goal == 0:
        return goal
    n, factors = channels, []
    d = 2
    while d * d <= n:
        while n % d == 0:
            factors.append(d)
            n //= d
        d += 1
    if n > 1:
        factors.append(n)
    return int(min(factors, key=lambda f: (abs(f - goal), -f)))


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm`` semantics: eps 1e-6 (torch's default is 1e-5)
    and the one-pass variance ``max(E[x^2] - E[x]^2, 0)`` in float32;
    ``y = (x - mean) * (rstd * scale) + bias``, cast to the compute dtype."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32,
                 eps: float = 1e-6):
        super().__init__()
        self.groups = group_count(channels)
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C = x.shape[:2]
        xf = x.float()
        xg = xf.reshape(B, self.groups, -1)
        mean = xg.mean(-1)
        var = torch.clamp((xg * xg).mean(-1) - mean * mean, min=0.0)
        rstd = torch.rsqrt(var + self.eps)
        rep = C // self.groups
        mean = mean.repeat_interleave(rep, dim=1)
        mul = rstd.repeat_interleave(rep, dim=1) * self.weight.float()
        shape = (B, C) + (1,) * (x.ndim - 2)
        y = (xf - mean.reshape(shape)) * mul.reshape(shape) \
            + self.bias.float().reshape((1, C) + (1,) * (x.ndim - 2))
        return y.to(self.dtype)


def instance_stats(x: torch.Tensor, eps: float = 1e-5
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-sweep float32 ``(mean, rstd)`` over H, W of NCHW: ``[B, C, 1, 1]``
    each, with the one-pass ``max(E[x^2] - E[x]^2, 0)`` variance."""
    xf = x.float()
    mean = xf.mean(dim=(2, 3), keepdim=True)
    mean_sq = (xf * xf).mean(dim=(2, 3), keepdim=True)
    var = torch.clamp(mean_sq - mean * mean, min=0.0)
    return mean, torch.rsqrt(var + eps)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mean, rstd = instance_stats(x, eps)
    return ((x.float() - mean) * rstd).to(x.dtype)


def pixel_norm(x: torch.Tensor) -> torch.Tensor:
    """``x / sqrt(mean(x^2) + 1e-8)`` over the last axis, in float32."""
    xf = x.float()
    return (xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-8)
            ).to(x.dtype)


def dense(x: torch.Tensor, linear: nn.Linear, dtype: torch.dtype
          ) -> torch.Tensor:
    """flax ``nn.Dense(dtype=...)``: input and params cast to ``dtype``."""
    return F.linear(x.to(dtype), linear.weight.to(dtype),
                    linear.bias.to(dtype))


def conv(x: torch.Tensor, layer: nn.Module, dtype: torch.dtype,
         padding=0, dilation=1, bias: bool = True) -> torch.Tensor:
    """flax ``nn.Conv(dtype=...)`` through a ``Conv1d``/``Conv2d``'s
    params: input, kernel and bias cast to ``dtype``.  ``bias=False`` leaves
    the bias out, for a caller that adds it later."""
    fn = F.conv2d if layer.weight.ndim == 4 else F.conv1d
    return fn(x.to(dtype), layer.weight.to(dtype),
              layer.bias.to(dtype) if bias else None,
              padding=padding, dilation=dilation)


def _same_pads(size: int, window: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of XLA's ``SAME`` for one dimension."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def _pad2d(x: torch.Tensor, pad: Tuple[int, int, int, int],
           mode: str) -> torch.Tensor:
    """Pad NCHW by ``(top, bottom, left, right)`` with zeros ("zero"), the
    edge value ("replicate") or a mirror without the edge ("reflect")."""
    t, b, l, r = pad
    if mode == "zero":
        return F.pad(x, (l, r, t, b))
    if mode in ("replicate", "reflect"):
        return F.pad(x, (l, r, t, b), mode=mode)
    raise ValueError(f"unknown pad mode {mode}")


def activation(name: str) -> Optional[Callable]:
    return {
        "relu": F.relu,
        "lrelu": lambda x: F.leaky_relu(x, 0.2),
        "lrelu01": lambda x: F.leaky_relu(x, 0.1),
        "tanh": torch.tanh,
        "selu": F.selu,
        "logsoftmax": lambda x: F.log_softmax(x, dim=1),
        "none": None,
    }[name]


class ConvBlock(nn.Module):
    """Pad, a VALID conv with stride, an optional norm and activation.

    ``norm``: "group" or "batch" (mapped to group norm, as in the JAX
    package), "instance" (no affine), or "none".  NCHW in and out."""

    def __init__(self, in_ch: int, features: int,
                 kernel: Tuple[int, int] = (3, 3),
                 stride: Tuple[int, int] = (1, 1),
                 padding: Tuple[int, int, int, int] = (0, 0, 0, 0),
                 norm: str = "none", act: str = "relu",
                 pad_type: str = "zero", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride, self.padding, self.pad_type = stride, padding, pad_type
        self.norm_kind, self.act, self.dtype = norm, activation(act), dtype
        self.conv = nn.Conv2d(in_ch, features, kernel)
        self.norm = GroupNorm(features, dtype) \
            if norm in ("group", "batch") else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _pad2d(x, self.padding, self.pad_type)
        x = F.conv2d(x.to(self.dtype), self.conv.weight.to(self.dtype),
                     self.conv.bias.to(self.dtype), stride=self.stride)
        if self.norm is not None:
            x = self.norm(x)
        elif self.norm_kind == "instance":
            x = instance_norm(x)
        return x if self.act is None else self.act(x)


def conv_transpose(x: torch.Tensor, layer: nn.ConvTranspose2d,
                   dtype: torch.dtype,
                   padding: Tuple[Tuple[int, int], Tuple[int, int]]
                   ) -> torch.Tensor:
    """flax ``nn.ConvTranspose(dtype=..., padding=...)`` through a
    ``ConvTranspose2d``'s params (stride from the layer).

    flax's ``transpose_kernel=False`` runs ``lax.conv_transpose``: the
    stride-dilated input, padded by ``padding``, correlated with the kernel
    unflipped.  torch's ``conv_transpose2d`` flips its kernel, so ``weight``
    is stored ``[in, out, kh, kw]`` already flipped (``convert.py``), and a
    flax pad ``p`` of a ``k``-tap axis is torch's padding ``k - 1 - p``.
    Both sides of each axis must pad alike."""
    pads = []
    for (lo, hi), k in zip(padding, layer.kernel_size):
        if lo != hi or lo > k - 1:
            raise ValueError(f"flax padding {padding} has no torch "
                             f"conv_transpose2d equivalent for kernel "
                             f"{layer.kernel_size}")
        pads.append(k - 1 - lo)
    return F.conv_transpose2d(x.to(dtype), layer.weight.to(dtype),
                              layer.bias.to(dtype), stride=layer.stride,
                              padding=tuple(pads))


def avg_pool(x: torch.Tensor, window: Tuple[int, int]) -> torch.Tensor:
    """flax ``nn.avg_pool`` on NCHW: ``VALID``, stride = window."""
    return F.avg_pool2d(x, window)


def _l2normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v) + eps)


class SNConv(nn.Module):
    """Conv with spectral normalization by one power iteration per forward.

    ``u`` (``[out]``) is a buffer, flax's ``spectral/u``.  A forward takes
    ``v = n(W u)`` and ``u' = n(Wᵀ v)`` from the detached weight (``W`` the
    ``[out, in*kh*kw]`` matrix, ``n`` the l2 normalization), divides the
    weight by ``σ = u'ᵀ W v``, through which the gradient does flow, and,
    when ``update_u``, stores ``u'`` in the buffer (a new tensor copied in
    under ``no_grad``; no graph holds the buffer).  The conv pads by
    ``(top, bottom, left, right)`` with zeros and runs VALID in ``dtype``;
    the power iteration stays float32."""

    def __init__(self, in_ch: int, features: int,
                 kernel: Tuple[int, int] = (3, 3),
                 padding: Tuple[int, int, int, int] = (0, 0, 0, 0),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.padding, self.dtype = padding, dtype
        self.weight = nn.Parameter(torch.empty(features, in_ch, *kernel))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("u", torch.zeros(features))

    def normalized_weight(self, update_u: bool = True) -> torch.Tensor:
        w = self.weight.reshape(self.weight.shape[0], -1)     # [out, in*k*k]
        with torch.no_grad():
            wd = w.detach().float()
            v = _l2normalize(wd.t() @ self.u)
            u_new = _l2normalize(wd @ v)
            if update_u:
                self.u.copy_(u_new)
        sigma = torch.dot(u_new, w.float() @ v)
        return self.weight / (sigma + 1e-12)

    def forward(self, x: torch.Tensor, update_u: bool = True) -> torch.Tensor:
        w = self.normalized_weight(update_u)
        return F.conv2d(_pad2d(x.to(self.dtype), self.padding, "zero"),
                        w.to(self.dtype), self.bias.to(self.dtype))


def channel_dropout(x: torch.Tensor, rate: float,
                    generator: Optional[torch.Generator],
                    per_channel: bool) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each entry with probability ``1 - rate``
    and scale it by ``1 / (1 - rate)``; a no-op when ``generator`` is None
    (deterministic) or ``rate`` is 0.  ``per_channel``: one draw per
    (sample, channel), broadcast over the rest, as ``broadcast_dims=(1, 2)``
    on NHWC does; else one per entry.  The mask is drawn from
    ``generator``, so a seeded generator repeats it."""
    if generator is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = x.shape[:2] + (1,) * (x.ndim - 2) if per_channel else x.shape
    mask = rows.rand(shape, generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def max_pool(x: torch.Tensor, window: Tuple[int, int],
             stride: Optional[Tuple[int, int]] = None,
             padding: str = "VALID") -> torch.Tensor:
    """flax ``nn.max_pool`` on NCHW.  ``SAME`` pads with -inf as XLA does,
    which may be asymmetric (a (2, 2) window at stride (2, 1) pads W by
    (0, 1)); torch's ``max_pool2d`` pads only symmetrically, so the input is
    padded first."""
    stride = stride or window
    if padding == "SAME":
        (ht, hb), (wl, wr) = (_same_pads(x.shape[2], window[0], stride[0]),
                              _same_pads(x.shape[3], window[1], stride[1]))
        x = F.pad(x, (wl, wr, ht, hb), value=float("-inf"))
    elif padding != "VALID":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got "
                         f"{padding!r}")
    return F.max_pool2d(x, window, stride)


class EqualConv(nn.Module):
    """Conv with the equal-LR runtime scale ``sqrt(2 / fan_in)``.

    For 1x1 kernels a per-sample channel affine ``(in_scale, in_shift)``
    (each ``[B, C_in]``) folds into the contraction exactly:
    ``conv(x*s + t) == contract(x, w*s) + contract(t, w) + b``.  As in the
    flax layer, ``x`` is contracted in float32 against a kernel rounded to
    ``x``'s dtype, and the result is float32."""

    def __init__(self, in_ch: int, features: int, kernel: int = 1):
        super().__init__()
        self.kernel = kernel
        self.weight = nn.Parameter(torch.empty(features, in_ch, kernel,
                                               kernel))
        self.bias = nn.Parameter(torch.zeros(features))
        self.scale = math.sqrt(2.0 / (in_ch * kernel * kernel))

    def forward(self, x: torch.Tensor, in_scale: Optional[torch.Tensor] = None,
                in_shift: Optional[torch.Tensor] = None) -> torch.Tensor:
        if in_scale is None:
            return F.conv2d(x, (self.weight * self.scale).to(x.dtype),
                            self.bias.to(x.dtype), padding="same")
        if self.kernel != 1:
            raise ValueError("EqualConv affine folding is only exact for "
                             f"1x1 convs, got kernel {self.kernel}")
        if in_shift is None:
            raise ValueError("in_scale requires in_shift (pass zeros for a "
                             "pure scale)")
        w2d = (self.weight * self.scale)[:, :, 0, 0].t().float()   # [C_in, F]
        wk = (in_scale.float()[:, :, None] * w2d[None]).to(x.dtype)
        y = torch.einsum("bchw,bcf->bfhw", x.float(), wk.float())
        bias = in_shift.float() @ w2d + self.bias.float()
        return y + bias[:, :, None, None]


class AdaIN(nn.Module):
    """Instance norm, then a per-channel affine from the style.  The
    linear's bias starts at gamma = 1, beta = 0; ``normalize=False`` returns
    ``(x, gamma, beta)`` for callers that fold the affine elsewhere."""

    def __init__(self, features: int, style_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.features = features
        self.dtype = dtype
        self.linear = nn.Linear(style_dim, 2 * features)
        with torch.no_grad():
            self.linear.bias.copy_(torch.cat([torch.ones(features),
                                              torch.zeros(features)]))

    def affine(self, style: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        h = dense(style, self.linear, self.dtype)
        return h[:, :self.features], h[:, self.features:]

    def forward(self, x: torch.Tensor, style: torch.Tensor,
                normalize: bool = True):
        gamma, beta = self.affine(style)
        if not normalize:
            return x, gamma, beta
        y = instance_norm(x)
        return gamma[:, :, None, None] * y + beta[:, :, None, None]


class NoiseInjection(nn.Module):
    """``x + sqrt(2) * w[c] * noise[b, h, w]``: the reference wraps the layer
    in equal-LR with fan_in 1, hence the sqrt(2).  Weight starts at 0.01."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.full((features,), 0.01))

    def forward(self, x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        w = (self.weight * math.sqrt(2.0)).to(x.dtype)
        return x + w[None, :, None, None] * noise.to(x.dtype)[:, None]


def blur3x3(x: torch.Tensor) -> torch.Tensor:
    """Depthwise zero-padded 3x3 binomial blur ((1,2,1) x (1,2,1) / 16)."""
    k = torch.tensor([1.0, 2.0, 1.0], device=x.device)
    k = (k[:, None] * k[None, :]) / 16.0
    c = x.shape[1]
    w = k.to(x.dtype).expand(c, 1, 3, 3)
    return F.conv2d(x, w, padding=1, groups=c)


def upsample_nearest(x: torch.Tensor, scale: Tuple[int, int]) -> torch.Tensor:
    """Nearest-neighbour upsample of NCHW by integer ``(sh, sw)``."""
    return F.interpolate(x, scale_factor=scale, mode="nearest")


class FusedUpsample(nn.Module):
    """Stride-2 transposed conv whose 4x4 kernel is the 4-tap average of the
    zero-padded, equal-LR-scaled 3x3 weight (StyleGAN's fused upsample).

    The flax layer runs ``lax.conv_transpose(stride 2, padding 2)``, which
    correlates the dilated input with the kernel unflipped; torch's
    ``conv_transpose2d(stride=2, padding=1)`` flips it.  So ``weight`` is
    stored ``[in, out, 3, 3]`` already flipped (``convert.py``), and the
    4-tap average, which commutes with the flip, is taken at run time.

    ``only_vertical``: stride (2, 1), flax padding ((2, 2), (1, 2)), so H
    doubles and W is kept.  The W padding is asymmetric, which
    ``conv_transpose2d`` cannot express: it runs with flax's (2, 2) (torch
    padding 1), one column wider, and the first column is cropped.

    The JAX layer's ``phase=True`` computes the same transposed conv by
    phase decomposition (a dense conv for the TPU's matrix unit, equal up
    to float association).  cuDNN's transposed conv reads no inserted
    zeros, so the port has one form for both."""

    def __init__(self, in_ch: int, features: int,
                 only_vertical: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_ch, features, 3, 3))
        self.bias = nn.Parameter(torch.zeros(features))
        self.mult = math.sqrt(2.0 / (in_ch * 9))
        self.only_vertical = only_vertical

    def forward(self, x: torch.Tensor, bias: bool = True) -> torch.Tensor:
        """``bias=False`` leaves the bias out, for a caller that adds it
        later."""
        wp = F.pad(self.weight * self.mult, (1, 1, 1, 1))
        w4 = (wp[:, :, 1:, 1:] + wp[:, :, :-1, 1:] + wp[:, :, 1:, :-1]
              + wp[:, :, :-1, :-1]) / 4.0
        b = self.bias.to(x.dtype) if bias else None
        if not self.only_vertical:
            return F.conv_transpose2d(x, w4.to(x.dtype), b, stride=2,
                                      padding=1)
        y = F.conv_transpose2d(x, w4.to(x.dtype), None, stride=(2, 1),
                               padding=1)[..., 1:]
        return y if b is None else y + b[:, None, None]


def phase_upsample_conv(x: torch.Tensor, layer: nn.Conv2d,
                        dtype: torch.dtype, bias: bool = True
                        ) -> torch.Tensor:
    """``conv(upsample_nearest(x, (2, 1)), layer, padding=1)`` without the
    upsampled tensor (the JAX package's ``_PhaseUpConv``): each output row
    of the 3x3 conv reads two source rows, ``y[2a] = w0 x[a-1] + (w1 + w2)
    x[a]`` and ``y[2a+1] = (w0 + w1) x[a] + w2 x[a+1]``, so one conv with a
    ``[2C, Cin, 2, 3]`` kernel (the two phases' taps, summed in float32)
    on the source padded by one row and column gives both phases, which
    interleave back by a reshape.  ``bias=False`` leaves the bias out."""
    B, _, H, W = x.shape
    w = layer.weight.float()                       # [C, Cin, 3, 3]
    C = w.shape[0]
    even = torch.stack([w[:, :, 0], w[:, :, 1] + w[:, :, 2]], dim=2)
    odd = torch.stack([w[:, :, 0] + w[:, :, 1], w[:, :, 2]], dim=2)
    wk = torch.cat([even, odd]).to(dtype)          # [2C, Cin, 2, 3]
    full = F.conv2d(F.pad(x.to(dtype), (1, 1, 1, 1)), wk)   # [B,2C,H+1,W]
    y = torch.stack([full[:, :C, :H], full[:, C:, 1:]], dim=3)
    y = y.reshape(B, C, 2 * H, W)
    return y + layer.bias.to(dtype)[:, None, None] if bias else y
