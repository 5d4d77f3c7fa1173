"""Port parity: the plain PyTorch generator epilogue against the JAX
``block_epilogue`` (Pallas in interpret mode on the CPU)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from handwriting_line_generation_tpu.ops.gen_epilogue import \
    block_epilogue as jax_block_epilogue
from handwriting_line_generation_tpu_torch.ops.gen_epilogue import (
    block_epilogue, block_epilogue_reference,
)
from test_torch_threads import one_thread  # noqa: F401 (autouse)


def _inputs(C, seed=0, B=2, H=4, W=16, bias=False):
    """(z, noise, nweight, gamma, beta, conv bias or None)."""
    rng = np.random.default_rng(seed)
    arrs = (rng.normal(size=(B, H, W, C)).astype(np.float32),
            rng.normal(size=(B, H, W)).astype(np.float32),
            rng.normal(scale=0.3, size=(C,)).astype(np.float32),
            (1.0 + 0.5 * rng.normal(size=(B, C))).astype(np.float32),
            rng.normal(size=(B, C)).astype(np.float32))
    return arrs + ((rng.normal(scale=0.5, size=(C,)).astype(np.float32)
                    if bias else None),)


def _run_jax(arrs, dtype, blur):
    """The JAX epilogue of ``z + bias``, the add in z's dtype (as the conv's
    own bias add)."""
    z, n, w, g, b = (jnp.asarray(a, dtype) for a in arrs[:5])
    if arrs[5] is not None:
        z = z + jnp.asarray(arrs[5], dtype)
    out = jax_block_epilogue(z, n, w, g, b, apply_blur=blur, interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _run_torch(arrs, dtype, blur):
    z, n, w, g, b = (torch.from_numpy(a).to(dtype) for a in arrs[:5])
    bias = None if arrs[5] is None else torch.from_numpy(arrs[5]).to(dtype)
    return block_epilogue(z, n, w, g, b, apply_blur=blur,
                          bias=bias).float().numpy()


# (blur, C, bias); the cases without a bias keep their "blur-C" ids
_CASES = [pytest.param(blur, C, bias,
                       id=f"{blur}-{C}" + ("-bias" if bias else ""))
          for bias in (False, True) for blur in (False, True)
          for C in (16, 256)]


@pytest.mark.parametrize("blur,C,bias", _CASES)
def test_plain_matches_jax_f32(C, blur, bias):
    """Same op order in float32: agreement to 1e-5 (summation order of the
    instance statistics differs)."""
    arrs = _inputs(C, bias=bias)
    np.testing.assert_allclose(_run_torch(arrs, torch.float32, blur),
                               _run_jax(arrs, jnp.float32, blur),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("blur,C,bias", _CASES)
def test_plain_matches_jax_bf16(C, blur, bias):
    """bfloat16 rounds at the same points; a different summation order of
    the statistics may flip one rounding after normalization, one bf16 ulp
    (2^-8 relative): atol 3e-2 + rtol 2e-2, and at most 1% of the values
    differ at all."""
    arrs = _inputs(C, seed=1, bias=bias)
    a = _run_torch(arrs, torch.bfloat16, blur)
    b = _run_jax(arrs, jnp.bfloat16, blur)
    np.testing.assert_allclose(a, b, rtol=2e-2, atol=3e-2)
    assert np.mean(a != b) <= 0.01


def test_plain_bias_is_one_rounded_add_first():
    """With a bias, the plain version equals the one without a bias on
    ``round(z + bias)``, bit for bit, in bf16."""
    arrs = _inputs(16, seed=2, bias=True)
    z, n, w, g, b, bias = (torch.from_numpy(a).to(torch.bfloat16)
                           for a in arrs)
    for blur in (False, True):
        got = block_epilogue_reference(z, n, w, g, b, apply_blur=blur,
                                       bias=bias)
        want = block_epilogue_reference(z + bias, n, w, g, b,
                                        apply_blur=blur)
        assert torch.equal(got, want)


def test_dispatch_cpu_uses_plain_version_and_counts_no_launch():
    arrs = _inputs(16)
    z, n, w, g, b = (torch.from_numpy(a) for a in arrs[:5])
    before = block_epilogue.launches
    out = block_epilogue(z, n, w, g, b, apply_blur=True)
    ref = block_epilogue_reference(z, n, w, g, b, apply_blur=True)
    assert torch.equal(out, ref)
    assert block_epilogue.launches == before


def test_dispatch_other_device_raises():
    z = torch.empty((1, 2, 2, 4), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        block_epilogue(z, torch.empty((1, 2, 2), device="meta"),
                       torch.empty(4, device="meta"),
                       torch.empty((1, 4), device="meta"),
                       torch.empty((1, 4), device="meta"), apply_blur=False)
