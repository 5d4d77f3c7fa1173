"""Perceptual autoencoder family: the second training phase's model.

Counterpart of ``handwriting_line_generation_tpu/models/autoencoder.py``.
The paper path is kind ``"2tight"``: :class:`Encoder2` (32) + the
reference's ``DecoderNoSkip`` (32), which is :class:`PyramidDecoder` with
its defaults, + the :class:`EHWR` CTC head on the bottleneck.
The GAN phase later freezes the encoder (:func:`build_encoder`) as its
perceptual-loss extractor, which reads both the bottleneck and the mid
features.

Layouts: :class:`Autoencoder` takes NHWC images ``[B, H, W, 1]`` and returns
the reconstruction in the same layout and ``[B, T, num_class]`` float32
log-probs, as the JAX package does.  The encoders, the decoders and
:class:`EHWR` work in NCHW: an encoder takes ``[B, 1, H, W]`` and returns
``(bottleneck, mid)``, e.g. ``[B, 32, 1, W/8]`` and ``[B, 64, H/4, W/4]``
for :class:`Encoder2`.  Every conv's width is ``SAME``, so the bottleneck
has exactly ``T = W/8`` frames (``W/4`` for kind ``"32"``) and the
reconstruction is exactly ``W`` wide.

Each module keeps its layers in ``convs``, ``convts`` and ``norms``, in the
order flax creates (and numbers) its ``Conv_<i>``, ``ConvTranspose_<i>`` and
``GroupNorm_<i>``, and its forward consumes them in that order.  Dropout
draws its masks from the ``generator`` passed to ``forward``: none means
deterministic.  The encoders' dropout is per (sample, channel), flax's
``broadcast_dims=(1, 2)`` on NHWC; :class:`EHWR`'s is per entry.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from reference.models.layers import (
    GroupNorm, avg_pool, channel_dropout, conv, conv_transpose, max_pool,
)

MaybeGenerator = Optional[torch.Generator]


class _Layers(nn.Module):
    """Holds ``convs``, ``convts`` and ``norms`` in flax's creation order,
    and hands them out in that order during a forward."""

    def __init__(self, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.convs = nn.ModuleList()
        self.convts = nn.ModuleList()
        self.norms = nn.ModuleList()

    def _conv(self, cin: int, cout: int, k) -> None:
        k = (k, k) if isinstance(k, int) else k
        self.convs.append(nn.Conv2d(cin, cout, k))

    def _convt(self, cin: int, cout: int, k, stride: int = 1) -> None:
        self.convts.append(nn.ConvTranspose2d(cin, cout, k, stride))

    def _norm(self, ch: int) -> None:
        self.norms.append(GroupNorm(ch, self.dtype))

    def _ops(self) -> Tuple[Callable, Callable, Callable]:
        """``conv(x, padding)``, ``convt(x, flax_padding)`` and ``norm(x)``,
        each taking the next layer of its list."""
        cs, ts, ns = iter(self.convs), iter(self.convts), iter(self.norms)
        return ((lambda x, padding: conv(x, next(cs), self.dtype, padding)),
                (lambda x, padding: conv_transpose(x, next(ts), self.dtype,
                                                   padding)),
                (lambda x: next(ns)(x)))


def _same(k: int) -> int:
    return (k - 1) // 2


class Encoder2(_Layers):
    """Three avg-pool stages with residual blocks, then the height collapsed
    8 -> 6 -> 1 by height-``VALID``, width-``SAME`` convs.  ``[B, 1, H, W]``
    -> ``(bottleneck [B, out_dim, 1, W/8], mid [B, 64, H/4, W/4])``."""

    def __init__(self, out_dim: int = 32, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__(dtype)
        self.out_dim, self.dropout = out_dim, dropout
        for cin, cout, k in ((1, 32, 5), (32, 32, 1), (32, 32, 3),
                             (32, 32, 3), (32, 64, 1), (64, 64, 3),
                             (64, 64, 3), (64, 128, 3),
                             (128, out_dim, (6, 3))):
            self._conv(cin, cout, k)
        for ch in (32, 32, 32, 64, 64, 64, 128):
            self._norm(ch)

    def forward(self, x: torch.Tensor, generator: MaybeGenerator = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        conv_, _, g = self._ops()
        drop = lambda v: channel_dropout(v, self.dropout, generator, True)
        x = x.to(self.dtype)
        # stage 1: 1 -> 32, H/2
        x = conv_(x, 2)
        x = F.relu(g(x))
        x = avg_pool(x, (2, 2))
        x = conv_(x, 0)
        res = x
        x = F.relu(x)
        x = conv_(x, 1)
        x = F.relu(drop(g(x)))
        x = conv_(x, 1)
        x = x + res
        # stage 2: 32 -> 64, H/4
        x = F.relu(g(x))
        x = avg_pool(x, (2, 2))
        x = conv_(x, 0)
        res = x
        x = F.relu(drop(g(x)))
        x = conv_(x, 1)
        x = F.relu(drop(g(x)))
        x = conv_(x, 1)
        x = x + res
        mid = x                                           # [B, 64, H/4, W/4]
        # stage 3: H/8, then 8 -> 6 -> 1
        x = F.relu(g(x))
        x = avg_pool(x, (2, 2))
        x = conv_(x, (0, 1))
        x = F.relu(drop(g(x)))
        x = conv_(x, (0, 1))
        return x, mid


class EHWR(nn.Module):
    """The CTC head on the bottleneck: four dilated 1-D convs (3/1, 3/2,
    3/4, 5/1) of 512, each followed by GroupNorm, dropout and ReLU, then a
    1x1 conv and a float32 log-softmax.  ``[B, in, 1, T]`` -> ``[B, T,
    num_class]``."""

    SPECS = ((3, 1), (3, 2), (3, 4), (5, 1))     # (kernel, dilation)

    def __init__(self, in_dim: int, num_class: int, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout, self.dtype = dropout, dtype
        self.convs = nn.ModuleList()
        cin = in_dim
        for k, _ in self.SPECS:
            self.convs.append(nn.Conv1d(cin, 512, k))
            cin = 512
        self.convs.append(nn.Conv1d(512, num_class, 1))
        self.norms = nn.ModuleList(GroupNorm(512, dtype) for _ in self.SPECS)

    def forward(self, bottleneck: torch.Tensor,
                generator: MaybeGenerator = None) -> torch.Tensor:
        x = bottleneck[:, :, 0, :].to(self.dtype)         # [B, in, T]
        for (k, dil), layer, norm in zip(self.SPECS, self.convs, self.norms):
            # SAME: dil * (k - 1) split evenly
            x = conv(x, layer, self.dtype, padding=dil * (k - 1) // 2,
                     dilation=dil)
            x = channel_dropout(norm(x), self.dropout, generator, False)
            x = F.relu(x)
        x = conv(x, self.convs[-1], self.dtype)
        return F.log_softmax(x.float(), dim=1).transpose(1, 2)


class PyramidEncoder(_Layers):
    """The non-paper encoders as one parametric 3-stage residual pyramid
    (``dims``, ``out_dim``, max or avg ``pool``, ``dropout``, the
    transition conv's ``trans_kernel``, ``first_pool=False`` for 32-px
    lines, ``tail`` "collapse" to H = 1 or "same" to keep H/8).  Returns
    ``(bottleneck, mid)`` like :class:`Encoder2`; mid has ``dims[2]``
    channels."""

    def __init__(self, dims: Tuple[int, int, int, int] = (32, 64, 128, 256),
                 out_dim: int = 512, pool: str = "max", dropout: float = 0.0,
                 trans_kernel: int = 3, first_pool: bool = True,
                 tail: str = "collapse", dtype: torch.dtype = torch.float32):
        super().__init__(dtype)
        self.dims, self.out_dim, self.dropout = dims, out_dim, dropout
        self.trans_kernel, self.first_pool, self.tail = (trans_kernel,
                                                         first_pool, tail)
        self.pool = max_pool if pool == "max" else avg_pool
        c0, c1, c2, c3 = dims
        self.stem = 5 if first_pool else 3
        last = (3, 3) if tail == "same" else (6, 3)
        for cin, cout, k in ((1, c0, self.stem), (c0, c1, trans_kernel),
                             (c1, c1, 3), (c1, c1, 3), (c1, c2, trans_kernel),
                             (c2, c2, 3), (c2, c2, 3), (c2, c3, 3),
                             (c3, out_dim, last)):
            self._conv(cin, cout, k)
        for ch in (c0, c1, c1, c1, c2, c2, c2, c3):
            self._norm(ch)

    def forward(self, x: torch.Tensor, generator: MaybeGenerator = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        conv_, _, g = self._ops()
        drop = lambda v: channel_dropout(v, self.dropout, generator, True)
        trans = _same(self.trans_kernel)

        def res_block(v):
            r = v
            v = F.relu(drop(g(v)))
            v = conv_(v, 1)
            v = F.relu(drop(g(v)))
            v = conv_(v, 1)
            return v + r

        x = x.to(self.dtype)
        x = conv_(x, _same(self.stem))
        x = F.relu(g(x))
        if self.first_pool:
            x = self.pool(x, (2, 2))
        x = res_block(conv_(x, trans))
        x = F.relu(g(x))
        x = self.pool(x, (2, 2))
        x = res_block(conv_(x, trans))
        mid = x
        x = F.relu(g(x))
        x = self.pool(x, (2, 2))
        if self.tail == "same":
            x = conv_(x, 1)
            x = F.relu(drop(g(x)))
            x = conv_(x, 1)
        else:
            x = conv_(x, (0, 1))                          # H 8 -> 6
            x = F.relu(drop(g(x)))
            x = conv_(x, (0, 1))                          # H -> 1
        return x, mid


class PyramidDecoder(_Layers):
    """Every decoder of the family: ``up_widths``, the mid features
    concatenated after the first upsample when ``skip`` (``mid_dim``
    channels), the H 1 -> 8 expansion when ``h_expand`` (else one SAME 3x3
    transposed conv on an H/8 bottleneck), and ``upsamples`` stride-2
    stages of the three (2 for 32-px lines; the rest are stride-1 3x3).
    With the defaults it is the reference's ``DecoderNoSkip``: bottleneck
    ``[B, in, 1, T]`` -> image ``[B, 1, 64, 8T]`` in tanh range
    (float32)."""

    def __init__(self, input_dim: int,
                 up_widths: Tuple[int, int, int, int] = (256, 128, 64, 32),
                 skip: bool = False, mid_dim: int = 0, h_expand: bool = True,
                 upsamples: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__(dtype)
        self.skip, self.h_expand, self.upsamples = skip, h_expand, upsamples
        w0 = up_widths[0]
        if h_expand:
            self._convt(input_dim, w0, (6, 3))
            self._convt(w0, w0, (3, 3))
            self._norm(w0)
            self._norm(w0)
        else:
            self._convt(input_dim, w0, (3, 3))
            self._norm(w0)
        cin = w0
        for i, f in enumerate(up_widths[1:]):
            stride = 2 if i < upsamples else 1
            self._convt(cin, f, (4, 4) if stride == 2 else (3, 3), stride)
            self._norm(f)
            self._conv(f + (mid_dim if i == 0 and skip else 0), f, 3)
            self._norm(f)
            cin = f
        self._conv(cin, 1, 3)

    def forward(self, x: torch.Tensor,
                mid: Optional[torch.Tensor] = None) -> torch.Tensor:
        conv_, convt, g = self._ops()
        x = F.relu(x.to(self.dtype))
        if self.h_expand:
            x = F.relu(g(convt(x, ((5, 5), (1, 1)))))
            x = F.relu(g(convt(x, ((2, 2), (1, 1)))))
        else:
            x = F.relu(g(convt(x, ((1, 1), (1, 1)))))
        for i in range(3):
            pad = ((2, 2), (2, 2)) if i < self.upsamples else ((1, 1), (1, 1))
            x = F.relu(g(convt(x, pad)))
            if i == 0 and self.skip and mid is not None:
                x = torch.cat([x, mid.to(self.dtype)], dim=1)
            x = F.relu(g(conv_(x, 1)))
        x = conv_(x, 1)
        return torch.tanh(x.float())


def _kinds() -> Dict[str, Tuple[Callable, Callable, int]]:
    """kind -> (encoder ctor, decoder ctor, bottleneck channels), each ctor
    taking the dtype: the reference's type dispatch, as ``_AE_KINDS``."""
    sm = dict(dims=(32, 32, 64, 128), trans_kernel=1)
    avg_sm = dict(sm, pool="avg", dropout=0.1)
    space = dict(avg_sm, tail="same")
    return {
        "skip": (lambda dt: PyramidEncoder(dtype=dt),
                 lambda dt: PyramidDecoder(512, skip=True, mid_dim=128,
                                           dtype=dt), 512),
        "small": (lambda dt: PyramidEncoder(out_dim=256, **sm, dtype=dt),
                  lambda dt: PyramidDecoder(256, (128, 64, 32, 32), skip=True,
                                            mid_dim=64, dtype=dt), 256),
        "no_skip": (lambda dt: PyramidEncoder(dtype=dt),
                    lambda dt: PyramidDecoder(512, dtype=dt), 512),
        "2": (lambda dt: Encoder2(256, dtype=dt),
              lambda dt: PyramidDecoder(256, dtype=dt), 256),
        "3": (lambda dt: PyramidEncoder(pool="avg", dropout=0.1, dtype=dt),
              lambda dt: PyramidDecoder(512, dtype=dt), 512),
        "2tight": (lambda dt: Encoder2(32, dtype=dt),
                   lambda dt: PyramidDecoder(32, dtype=dt), 32),
        "2tighter": (lambda dt: Encoder2(16, dtype=dt),
                     lambda dt: PyramidDecoder(16, dtype=dt), 16),
        "smallSpace": (lambda dt: PyramidEncoder(out_dim=4, **space, dtype=dt),
                       lambda dt: PyramidDecoder(4, h_expand=False, dtype=dt),
                       4),
        "space": (lambda dt: PyramidEncoder(out_dim=8, **space, dtype=dt),
                  lambda dt: PyramidDecoder(8, h_expand=False, dtype=dt), 8),
        "32": (lambda dt: PyramidEncoder(out_dim=256, first_pool=False,
                                         **avg_sm, dtype=dt),
               lambda dt: PyramidDecoder(256, upsamples=2, dtype=dt), 256),
    }


AE_KINDS = tuple(_kinds())


class Autoencoder(nn.Module):
    """Encoder + decoder (+ the :class:`EHWR` head when ``hwr_classes``) of
    one ``kind`` of :data:`AE_KINDS`.  The paper path is ``"2tight"``."""

    def __init__(self, kind: str = "2tight", hwr_classes: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        kinds = _kinds()
        if kind not in kinds:
            raise ValueError(f"unknown autoencoder kind {kind!r}")
        enc, dec, self.out_dim = kinds[kind]
        self.kind = kind
        self.encoder = enc(dtype)
        self.decoder = dec(dtype)
        self.hwr = (EHWR(self.out_dim, hwr_classes, dtype=dtype)
                    if hwr_classes else None)

    def forward(self, x: torch.Tensor, generator: MaybeGenerator = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """NHWC images -> ``(recon [B, H, W, 1] float32, log-probs [B, T,
        num_class] or None)``."""
        enc, mid = self.encode(x, generator)
        recon = self.decoder(enc, mid).permute(0, 2, 3, 1)
        if self.hwr is None:
            return recon, None
        # the head reads an H = 1 bottleneck; the space kinds keep H/8 and
        # are averaged over it first
        bott = enc if enc.shape[2] == 1 else enc.mean(2, keepdim=True)
        return recon, self.hwr(bott, generator)

    def encode(self, x: torch.Tensor, generator: MaybeGenerator = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """NHWC images -> the encoder's NCHW ``(bottleneck, mid)``."""
        return self.encoder(x.permute(0, 3, 1, 2), generator)


def build_encoder(kind: str, dtype: torch.dtype = torch.float32
                  ) -> nn.Module:
    """The perceptual encoder of ``TrainerConfig.encoder_type``: the
    ``encoder`` of an :class:`Autoencoder` of that kind (``Encoder2(32)``
    for an unknown kind).  Its weights come from an autoencoder checkpoint's
    ``encoder.*`` entries (``utils.checkpoint.extract_subtree``)."""
    kinds = _kinds()
    if kind in kinds:
        return kinds[kind][0](dtype)
    return Encoder2(32, dtype=dtype)
