"""Generator block epilogue: ``[+bias] -> [blur] -> +noise -> leaky_relu
-> AdaIN``.

Counterpart of ``handwriting_line_generation_tpu/ops/gen_epilogue.py``.
:func:`block_epilogue` launches the hand-written CUDA kernel
``csrc/gen_epilogue.cu`` for a CUDA tensor and runs the plain PyTorch
version :func:`block_epilogue_reference` for a CPU tensor; any other
device raises.  Both compute, per sample and channel of an NHWC ``z``, in
float32 with bfloat16 rounding at the JAX kernel's points:

  x   = round(z + bias)                     (when a conv bias is given)
  y   = leaky_relu_0.2([blur3x3](x) + round(noise * round(sqrt(2) * w)))
  out = gamma * round((y - mean) * rstd) + beta

with one-pass float32 instance statistics ``var = max(E[y^2] - E[y]^2, 0)``
and ``rstd = 1 / sqrt(var + eps)``.  The bias is the preceding conv's: the
caller runs the conv without it, so the add costs no pass of its own.
Inference only: no backward.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
import torch.nn.functional as F

from handwriting_line_generation_tpu_torch import kernels

_DTYPES = (torch.float32, torch.bfloat16)


def _prepare(z, noise, nweight, gamma, beta, bias):
    """Inputs in z's dtype, the noise weight pre-scaled by sqrt(2) and
    rounded once, as the JAX wrapper does."""
    nw = (nweight.reshape(-1) * math.sqrt(2.0)).to(z.dtype)
    bias = None if bias is None else bias.reshape(-1).to(z.dtype)
    return (noise.to(z.dtype), nw, gamma.to(z.dtype), beta.to(z.dtype),
            bias)


def block_epilogue_reference(z: torch.Tensor, noise: torch.Tensor,
                             nweight: torch.Tensor, gamma: torch.Tensor,
                             beta: torch.Tensor, *, apply_blur: bool,
                             eps: float = 1e-5,
                             bias: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Plain PyTorch version of the kernel, op for op."""
    noise, nw, gamma, beta, bias = _prepare(z, noise, nweight, gamma, beta,
                                            bias)
    dt = z.dtype
    rnd = (lambda t: t.to(dt).float()) if dt != torch.float32 \
        else (lambda t: t)
    x = z.float()
    if bias is not None:
        x = rnd(x + bias.float())
    if apply_blur:
        xp = F.pad(x, (0, 0, 0, 0, 1, 1))                     # rows
        x = (xp[:, :-2] + 2.0 * xp[:, 1:-1] + xp[:, 2:]) * 0.25
        xp = F.pad(x, (0, 0, 1, 1))                           # columns
        x = (xp[:, :, :-2] + 2.0 * xp[:, :, 1:-1] + xp[:, :, 2:]) * 0.25
        x = rnd(x)
    x = x + rnd(noise.float()[..., None] * nw.float())
    x = rnd(torch.maximum(x, 0.2 * x))
    n = float(x.shape[1] * x.shape[2])
    mean = x.sum(dim=(1, 2)) / n                              # [B, C]
    var = torch.clamp(x.mul(x).sum(dim=(1, 2)) / n - mean * mean, min=0.0)
    rstd = 1.0 / torch.sqrt(var + eps)
    zn = rnd((x - mean[:, None, None]) * rstd[:, None, None])
    out = gamma.float()[:, None, None] * zn + beta.float()[:, None, None]
    return out.to(dt)


def _library() -> ctypes.CDLL:
    lib = kernels.load("gen_epilogue")
    fn = lib.gen_epilogue_forward
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    plan = lib.gen_epilogue_plan
    plan.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    plan.restype = ctypes.c_int
    return lib


def plan(shape, dtype: torch.dtype, apply_blur: bool) -> dict:
    """How the kernel cuts up a call on ``z`` of ``shape`` ``[B, H, W, C]``:
    cluster size, pixels per rank, threads, ring tile width (L2 mode with the
    blur), where phase 2 takes y from (``"smem"``: the band stays in shared
    memory; ``"L2"``: z re-read) and the shared memory per block.  Builds
    the kernel if needed."""
    _, H, W, C = shape
    out = (ctypes.c_longlong * 6)()
    err = _library().gen_epilogue_plan(H, W, C, int(dtype == torch.bfloat16),
                                       int(apply_blur), out)
    if err != 0:
        raise RuntimeError(f"gen_epilogue has no plan for {tuple(shape)}")
    return {"cluster": out[0], "pixels_per_rank": out[1], "threads": out[2],
            "tile_w": out[3], "y_from": "smem" if out[4] else "L2",
            "smem_bytes": out[5]}


def _check(z, noise, nw, gamma, beta, bias):
    if z.dtype not in _DTYPES:
        raise TypeError(f"block_epilogue takes float32 or bfloat16, "
                        f"got {z.dtype}")
    if z.ndim != 4:
        raise ValueError(f"z must be [B, H, W, C], got {tuple(z.shape)}")
    B, H, W, C = z.shape
    want = {"noise": (noise, (B, H, W)), "nweight": (nw, (C,)),
            "gamma": (gamma, (B, C)), "beta": (beta, (B, C))}
    if bias is not None:
        want["bias"] = (bias, (C,))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    for name, t in [("z", z)] + [(k, v[0]) for k, v in want.items()]:
        if t.device != z.device:
            raise ValueError(f"{name} is on {t.device}, z on {z.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if z.data_ptr() % 16:
        raise ValueError("z must be 16-byte aligned")


def _launch(z, noise, nw, gamma, beta, bias, apply_blur, eps):
    _check(z, noise, nw, gamma, beta, bias)
    B, H, W, C = z.shape
    out = torch.empty_like(z)
    stream = torch.cuda.current_stream(z.device).cuda_stream
    err = _library().gen_epilogue_forward(
        z.data_ptr(), noise.data_ptr(), nw.data_ptr(),
        None if bias is None else bias.data_ptr(), gamma.data_ptr(),
        beta.data_ptr(), out.data_ptr(), B, H, W, C,
        int(z.dtype == torch.bfloat16), int(apply_blur), float(eps), stream)
    if err != 0:
        raise RuntimeError(f"gen_epilogue kernel launch failed: CUDA error "
                           f"{err}")
    block_epilogue.launches += 1
    return out


def block_epilogue(z: torch.Tensor, noise: torch.Tensor,
                   nweight: torch.Tensor, gamma: torch.Tensor,
                   beta: torch.Tensor, *, apply_blur: bool,
                   eps: float = 1e-5,
                   bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[+bias] -> [blur] -> x + sqrt2*w*noise -> lrelu -> AdaIN`` on NHWC
    ``z``, in one kernel launch on the card.

    Args:
      z: ``[B, H, W, C]`` conv output (pre-noise), float32 or bfloat16.
      noise: ``[B, H, W]`` standard-normal plane shared across channels.
      nweight: ``[C]`` NoiseInjection weight (not yet sqrt(2)-scaled).
      gamma, beta: ``[B, C]`` AdaIN affine from the style.
      bias: optional ``[C]`` bias of the conv that made ``z`` without it;
        added first, rounded once to z's dtype.
    Returns ``[B, H, W, C]`` in z's dtype.  A CUDA tensor goes through the
    kernel (``block_epilogue.launches`` counts its launches); a CPU tensor
    through :func:`block_epilogue_reference`.
    """
    if z.device.type == "cpu":
        return block_epilogue_reference(z, noise, nweight, gamma, beta,
                                        apply_blur=apply_blur, eps=eps,
                                        bias=bias)
    if z.device.type != "cuda":
        raise ValueError(f"block_epilogue runs on cuda or cpu, not "
                         f"{z.device}")
    noise, nw, gamma, beta, bias = _prepare(z, noise, nweight, gamma, beta,
                                            bias)
    return _launch(z, noise.contiguous(), nw, gamma.contiguous(),
                   beta.contiguous(), bias, apply_blur, eps)


block_epilogue.launches = 0
