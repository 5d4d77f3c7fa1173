"""Spaced-text conditioned StyleGAN-style generator.

Counterpart of ``handwriting_line_generation_tpu/models/generator.py``: the
spaced one-hot text ``[B, T, C]`` (plus the broadcast style when
``append_style``) is laid on a ``[B, C, 1, T]`` canvas and five styled conv
blocks grow it to a ``[B, 64, 4T, 1]`` image — two vertical-only x2
upsamples (nearest + conv), then two full x2 fused upsamples.  Each block is
conv -> noise -> leaky_relu -> AdaIN twice.  The last block defers its
second AdaIN into the final 1x1 equal conv.

With ``fused_epilogue`` each block's ``[blur] -> noise -> lrelu -> AdaIN``
runs as one :func:`ops.gen_epilogue.block_epilogue` call (the CUDA kernel on
the card): 9 calls per forward.  The conv before each call runs without its
bias and the epilogue adds it as it loads, so the bias costs no pass of its
own; the last block's second conv, which feeds the deferred AdaIN, keeps
its bias.  Activations stay in ``channels_last`` memory so the NHWC view
the kernel takes is contiguous, without a copy.

``small`` (the 32-px family's generator): the last block does not
upsample, so it has no blur and the image is ``[B, 32, 2T, 1]``.
``phase_upsample``: the vertical blocks' nearest x2 + conv runs as one
conv on the source rows (:func:`models.layers.phase_upsample_conv`, the
JAX package's ``_PhaseUpConv``); the fused blocks' transposed conv is the
same either way.  Both keep the parameter names and shapes, so a checkpoint
loads into either.

The JAX package cannot build ``small``: its non-upsampling block names
both convs ``Conv_0`` and flax refuses it (``NameInUseError``).  The port
names that block's convs ``Conv_0`` and ``Conv_1`` in the flax layout
(``convert.py``), as the nearest-upsample blocks do.

Inference only: dropout is the identity.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from handwriting_line_generation_tpu_torch.models.layers import (
    AdaIN, EqualConv, FusedUpsample, NoiseInjection, blur3x3, conv, dense,
    instance_stats, phase_upsample_conv, pixel_norm, upsample_nearest,
)
from handwriting_line_generation_tpu_torch.ops import rows
from handwriting_line_generation_tpu_torch.ops.gen_epilogue import \
    block_epilogue


def _noise_plane(x: torch.Tensor, given: Optional[torch.Tensor],
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """``[B, H, W]`` noise at x's resolution: the given plane (``[B, H, W]``
    or ``[B, H, W, 1]``) or a draw from ``generator`` in x's dtype."""
    if given is not None:
        return given[..., 0] if given.ndim == 4 else given
    if generator is None:
        raise ValueError("pass noise planes or a torch.Generator to draw "
                         "them from")
    B, _, H, W = x.shape
    return rows.randn((B, H, W), generator, device=x.device, dtype=x.dtype)


class StyledConvBlock(nn.Module):
    """conv1 -> noise -> lrelu -> AdaIN -> conv2 -> noise -> lrelu -> AdaIN.

    ``initial``: conv1 is flax's stride-1 ``ConvTranspose((4, 3),
    padding=((3, 3), (1, 1)))``, which does not flip its kernel: a plain
    correlation of the input padded by 3 rows and 1 column, so it is a
    ``conv2d`` here (H 1 -> 4, W kept).  ``upsample``: nearest x2 + 3x3
    conv (:func:`phase_upsample_conv` when ``phase_upsample`` and
    ``only_vertical``), or :class:`FusedUpsample` when ``fused``; then the
    3x3 blur.  Neither: a 3x3 conv, no blur.
    """

    def __init__(self, in_ch: int, features: int, style_dim: int, *,
                 initial: bool = False, upsample: bool = False,
                 only_vertical: bool = False, fused: bool = False,
                 defer_final_adain: bool = False,
                 phase_upsample: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.initial, self.upsample = initial, upsample
        self.phase_upsample = phase_upsample
        self.only_vertical, self.fused = only_vertical, fused
        self.defer_final_adain = defer_final_adain
        self.dtype = dtype
        if initial:
            self.conv1 = nn.Conv2d(in_ch, features, (4, 3))
        elif upsample and fused:
            self.conv1 = FusedUpsample(in_ch, features, only_vertical)
        else:
            self.conv1 = nn.Conv2d(in_ch, features, 3)
        self.noise1 = NoiseInjection(features)
        self.adain1 = AdaIN(features, style_dim, dtype)
        self.conv2 = nn.Conv2d(features, features, 3)
        self.noise2 = NoiseInjection(features)
        self.adain2 = AdaIN(features, style_dim, dtype)

    def _epilogue(self, x, style, noise, apply_blur, inj, ada, conv_layer):
        """``x`` came from ``conv_layer`` run without its bias; the kernel
        adds it."""
        gamma, beta = ada.affine(style)
        z = x.permute(0, 2, 3, 1).contiguous()   # free for channels_last x
        out = block_epilogue(z, noise, inj.weight, gamma, beta,
                             apply_blur=apply_blur,
                             bias=conv_layer.bias.to(self.dtype))
        return out.permute(0, 3, 1, 2)

    def _sequential(self, x, style, noise, inj, ada, normalize=True):
        x = F.leaky_relu(inj(x, noise), 0.2)
        return ada(x, style, normalize=normalize)

    def forward(self, x: torch.Tensor, style: torch.Tensor,
                noise: Optional[Sequence[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None,
                fused_epilogue: bool = False):
        blur_in_epilogue = fused_epilogue and self.upsample
        dt = self.dtype
        # with the fused epilogue, the conv bias moves into the kernel
        bias1 = not fused_epilogue
        bias2 = not fused_epilogue or self.defer_final_adain
        if self.initial:
            x = conv(F.pad(x, (1, 1, 3, 3)), self.conv1, dt, bias=bias1)
            x = x.contiguous(memory_format=torch.channels_last)
        elif self.upsample:
            if self.fused:
                x = self.conv1(x, bias=bias1)
            elif self.phase_upsample and self.only_vertical:
                x = phase_upsample_conv(x, self.conv1, dt, bias=bias1)
            else:
                scale = (2, 1) if self.only_vertical else (2, 2)
                x = conv(upsample_nearest(x, scale), self.conv1, dt, 1,
                         bias=bias1)
            if not blur_in_epilogue:
                x = blur3x3(x)
        else:
            x = conv(x, self.conv1, dt, 1, bias=bias1)

        n1 = _noise_plane(x, None if noise is None else noise[0], generator)
        if fused_epilogue:
            x = self._epilogue(x, style, n1, blur_in_epilogue, self.noise1,
                               self.adain1, self.conv1)
        else:
            x = self._sequential(x, style, n1, self.noise1, self.adain1)

        x = conv(x, self.conv2, dt, 1, bias=bias2)
        n2 = _noise_plane(x, None if noise is None else noise[1], generator)
        if fused_epilogue and not self.defer_final_adain:
            return self._epilogue(x, style, n2, False, self.noise2,
                                  self.adain2, self.conv2)
        return self._sequential(x, style, n2, self.noise2, self.adain2,
                                normalize=not self.defer_final_adain)


class StyleMLP(nn.Module):
    """PixelNorm + n x (Linear + LeakyReLU) style mapping."""

    def __init__(self, style_dim: int, n_layers: int = 6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.layers = nn.ModuleList(nn.Linear(style_dim, style_dim)
                                    for _ in range(n_layers))

    def forward(self, style: torch.Tensor) -> torch.Tensor:
        h = pixel_norm(style)
        for lin in self.layers:
            h = F.leaky_relu(dense(h, lin, self.dtype), 0.2)
        return h


class SpacedGenerator(nn.Module):
    """Spaced one-hot ``[B, T, C]`` + style ``[B, S]`` -> image
    ``[B, 64, 4T, 1]`` (``[B, 32, 2T, 1]`` when ``small``; float32, tanh
    range).

    ``char_style_dim > 0`` also takes ``spaced_style [B, T, char_style_dim]``
    (``HWWithStyle.space_style``) and appends it to the content channels.
    """

    def __init__(self, num_class: int, style_dim: int, dim: int = 256,
                 n_style_trans: int = 6, append_style: bool = True,
                 emb_dropout: float = 0.0, small: bool = False,
                 char_style_dim: int = 0, fused_epilogue: bool = False,
                 phase_upsample: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.style_dim, self.append_style = style_dim, append_style
        self.char_style_dim = char_style_dim
        self.fused_epilogue = fused_epilogue
        self.dtype = dtype
        self.style_mlp = StyleMLP(style_dim, n_style_trans, dtype)
        in_ch = num_class + (style_dim if append_style else 0) \
            + char_style_dim
        d = dim
        blk = lambda *a, **kw: StyledConvBlock(
            *a, style_dim=style_dim, phase_upsample=phase_upsample,
            dtype=dtype, **kw)
        self.blocks = nn.ModuleList([
            blk(in_ch, d, initial=True),                               # H4
            blk(d, d // 2, upsample=True, only_vertical=True),         # H8
            blk(d // 2, d // 4, upsample=True, only_vertical=True),    # H16
            blk(d // 4, d // 8, upsample=True, fused=True),        # H32 W2T
            blk(d // 8, d // 16, upsample=not small, fused=True,
                defer_final_adain=True),               # H64 W4T (small: H32)
        ])
        self.to_gray = EqualConv(d // 16, 1, kernel=1)

    def forward(self, spaced_onehot: torch.Tensor, style: torch.Tensor,
                noise: Optional[List[torch.Tensor]] = None,
                spaced_style: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``noise``: optional list of 10 planes ``[B, H, W(, 1)]``, two per
        block at its output resolution; otherwise drawn from
        ``generator``."""
        dt = self.dtype
        style = self.style_mlp(style.to(dt))
        x = spaced_onehot.to(dt).transpose(1, 2)[:, :, None, :]  # [B,C,1,T]
        B, _, _, T = x.shape
        if self.append_style:
            x = torch.cat([x, style[:, :, None, None].expand(
                B, self.style_dim, 1, T)], dim=1)
        if self.char_style_dim > 0:
            if spaced_style is None:
                raise ValueError("char_style_dim > 0 requires spaced_style")
            x = torch.cat(
                [x, spaced_style.to(dt).transpose(1, 2)[:, :, None, :]],
                dim=1)
        for i, block in enumerate(self.blocks):
            x = block(x, style,
                      None if noise is None else noise[2 * i:2 * i + 2],
                      generator, self.fused_epilogue)
        # the last block returned (x, gamma, beta) before normalization: the
        # per-channel affine folds exactly into the 1x1 equal conv, so the
        # normalized 64-row tensor is never materialized
        x, gamma, beta = x
        mean, rstd = instance_stats(x)
        mean, rstd = mean[:, :, 0, 0], rstd[:, :, 0, 0]            # [B, C]
        g32 = gamma.float() * rstd
        x = self.to_gray(x, in_scale=g32, in_shift=beta.float() - mean * g32)
        return torch.tanh(x.float()).permute(0, 2, 3, 1)          # NHWC
