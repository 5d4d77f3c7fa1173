"""Generator block epilogue: ``[blur] -> +noise -> leaky_relu -> AdaIN``.

Counterpart of ``handwriting_line_generation_tpu/ops/gen_epilogue.py``.
:func:`block_epilogue` launches the hand-written CUDA kernel
``csrc/gen_epilogue.cu`` for a CUDA tensor and runs the plain PyTorch
version :func:`block_epilogue_reference` for a CPU tensor; any other
device raises.  Both compute, per sample and channel of an NHWC ``z``, in
float32 with bfloat16 rounding at the JAX kernel's points:

  y   = leaky_relu_0.2([blur3x3](z) + round(noise * round(sqrt(2) * w)))
  out = gamma * round((y - mean) * rstd) + beta

with one-pass float32 instance statistics ``var = max(E[y^2] - E[y]^2, 0)``
and ``rstd = 1 / sqrt(var + eps)``.  Inference only: no backward.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from handwriting_line_generation_tpu_torch import kernels

# elements of one sample that one block of the stats / apply passes covers
_CHUNK_ELEMS = 8192
_DTYPES = (torch.float32, torch.bfloat16)


def _prepare(z, noise, nweight, gamma, beta):
    """Inputs in z's dtype, the noise weight pre-scaled by sqrt(2) and
    rounded once, as the JAX wrapper does."""
    nw = (nweight.reshape(-1) * math.sqrt(2.0)).to(z.dtype)
    return noise.to(z.dtype), nw, gamma.to(z.dtype), beta.to(z.dtype)


def block_epilogue_reference(z: torch.Tensor, noise: torch.Tensor,
                             nweight: torch.Tensor, gamma: torch.Tensor,
                             beta: torch.Tensor, *, apply_blur: bool,
                             eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of the kernel, op for op."""
    noise, nw, gamma, beta = _prepare(z, noise, nweight, gamma, beta)
    dt = z.dtype
    rnd = (lambda t: t.to(dt).float()) if dt != torch.float32 \
        else (lambda t: t)
    x = z.float()
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
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _check(z, noise, nw, gamma, beta):
    if z.dtype not in _DTYPES:
        raise TypeError(f"block_epilogue takes float32 or bfloat16, "
                        f"got {z.dtype}")
    if z.ndim != 4:
        raise ValueError(f"z must be [B, H, W, C], got {tuple(z.shape)}")
    B, H, W, C = z.shape
    want = {"noise": (noise, (B, H, W)), "nweight": (nw, (C,)),
            "gamma": (gamma, (B, C)), "beta": (beta, (B, C))}
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


def _launch(z, noise, nw, gamma, beta, apply_blur, eps):
    _check(z, noise, nw, gamma, beta)
    B, H, W, C = z.shape
    pix_per_chunk = max(1, _CHUNK_ELEMS // C)
    nchunks = -(-(H * W) // pix_per_chunk)
    out = torch.empty_like(z)
    scratch = torch.empty(2 * B * nchunks * C + 2 * B * C,
                          dtype=torch.float32, device=z.device)
    stream = torch.cuda.current_stream(z.device).cuda_stream
    err = _library().gen_epilogue_forward(
        z.data_ptr(), noise.data_ptr(), nw.data_ptr(), gamma.data_ptr(),
        beta.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        B, H, W, C, int(z.dtype == torch.bfloat16), int(apply_blur),
        float(eps), pix_per_chunk, nchunks, stream)
    if err != 0:
        raise RuntimeError(f"gen_epilogue kernel launch failed: CUDA error "
                           f"{err}")
    block_epilogue.launches += 1
    return out


def block_epilogue(z: torch.Tensor, noise: torch.Tensor,
                   nweight: torch.Tensor, gamma: torch.Tensor,
                   beta: torch.Tensor, *, apply_blur: bool,
                   eps: float = 1e-5) -> torch.Tensor:
    """``[blur] -> x + sqrt2*w*noise -> lrelu -> AdaIN`` on NHWC ``z``.

    Args:
      z: ``[B, H, W, C]`` conv output (pre-noise), float32 or bfloat16.
      noise: ``[B, H, W]`` standard-normal plane shared across channels.
      nweight: ``[C]`` NoiseInjection weight (not yet sqrt(2)-scaled).
      gamma, beta: ``[B, C]`` AdaIN affine from the style.
    Returns ``[B, H, W, C]`` in z's dtype.  A CUDA tensor goes through the
    kernel (``block_epilogue.launches`` counts its launches); a CPU tensor
    through :func:`block_epilogue_reference`.
    """
    if z.device.type == "cpu":
        return block_epilogue_reference(z, noise, nweight, gamma, beta,
                                        apply_blur=apply_blur, eps=eps)
    if z.device.type != "cuda":
        raise ValueError(f"block_epilogue runs on cuda or cpu, not "
                         f"{z.device}")
    noise, nw, gamma, beta = _prepare(z, noise, nweight, gamma, beta)
    return _launch(z, noise.contiguous(), nw, gamma.contiguous(),
                   beta.contiguous(), apply_blur, eps)


block_epilogue.launches = 0
