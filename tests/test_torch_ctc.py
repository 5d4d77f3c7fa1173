"""Port parity for the CTC loss: the port's plain ``ctc_loss`` (the CPU path
and the CUDA kernel's plain version) against the JAX scan and the JAX
Pallas kernel in interpret mode, in value and in gradient w.r.t.
log_probs; plus the CPU dispatch of ``ctc_loss_fast``."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from handwriting_line_generation_tpu.ops.ctc import (
    ctc_loss as j_ctc_loss, mask_frames_to_blank as j_mask,
)
from handwriting_line_generation_tpu.ops.ctc_pallas import ctc_loss_pallas
from handwriting_line_generation_tpu_torch import kernels
from handwriting_line_generation_tpu_torch.ops import ctc as P
from test_torch_threads import one_thread  # noqa: F401 (autouse)

# as tests/test_ctc_pallas.py: the two JAX versions agree to these
VALUE_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)


def _case(seed, B=4, T=20, C=9, L=6, repeats=False):
    """Log-softmax inputs, labels with per-sample lengths in [1, L] (the
    last sample of length 0), frame lengths for masking."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, T, C)).astype(np.float32)
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), -1))
    llens = rng.integers(1, L + 1, size=B).astype(np.int32)
    llens[-1] = 0
    labels = np.zeros((B, L), np.int32)
    for b in range(B):
        labels[b, :llens[b]] = rng.integers(1, C, size=llens[b])
    if repeats:
        labels[0, :L] = [2, 2, 2, 5, 5, 1][:L]
        llens[0] = L
    frames = rng.integers(T // 2, T + 1, size=B).astype(np.int32)
    return lp, labels, llens, frames


def _jax_fn(which, labels, llens, reduction):
    if which == "scan":
        return lambda x: j_ctc_loss(
            x, jnp.asarray(labels), jnp.full((x.shape[0],), x.shape[1]),
            jnp.asarray(llens), reduction=reduction)
    return lambda x: ctc_loss_pallas(
        x, jnp.asarray(labels), jnp.full((x.shape[0],), x.shape[1]),
        jnp.asarray(llens), reduction=reduction, interpret=True)


def _port(lp, labels, llens, reduction, frames=None):
    x = torch.tensor(lp, requires_grad=True)
    y = x if frames is None else P.mask_frames_to_blank(
        x, torch.from_numpy(frames))
    B, T, _ = lp.shape
    out = P.ctc_loss(y, torch.from_numpy(labels), torch.full((B,), T),
                     torch.from_numpy(llens), reduction=reduction)
    return out, x


@pytest.mark.parametrize("which", ["scan", "pallas"])
@pytest.mark.parametrize("reduction", ["none", "sum", "mean"])
@pytest.mark.parametrize("seed", [0, 1])
def test_ctc_value_and_grad_match_jax(which, reduction, seed):
    lp, labels, llens, frames = _case(seed, repeats=seed == 1)
    fn = _jax_fn(which, labels, llens, reduction)

    def masked(x):
        return fn(j_mask(x, jnp.asarray(frames)))

    want = np.asarray(masked(jnp.asarray(lp)))
    got, x = _port(lp, labels, llens, reduction, frames)
    np.testing.assert_allclose(got.detach().numpy(), want, **VALUE_TOL)

    g_want = np.asarray(jax.grad(lambda x: jnp.sum(masked(x)))(
        jnp.asarray(lp)))
    got.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), g_want, **GRAD_TOL)


@pytest.mark.parametrize("which", ["scan", "pallas"])
def test_ctc_impossible_label_is_zero_with_zero_grad(which):
    rng = np.random.default_rng(7)
    C = 6
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(
        rng.standard_normal((2, 3, C)).astype(np.float32)), -1))
    labels = np.array([[1, 2, 3, 4], [1, 0, 0, 0]], np.int32)
    llens = np.array([4, 1], np.int32)
    want = np.asarray(_jax_fn(which, labels, llens, "none")(jnp.asarray(lp)))
    got, x = _port(lp, labels, llens, "none")
    assert want[0] == 0.0 and got[0].item() == 0.0
    np.testing.assert_allclose(got.detach().numpy(), want, **VALUE_TOL)
    got.sum().backward()
    assert torch.isfinite(x.grad).all()
    assert (x.grad[0] == 0).all() and (x.grad[1] != 0).any()


def test_mask_frames_to_blank_matches_jax():
    lp, _, _, frames = _case(3)
    want = np.asarray(j_mask(jnp.asarray(lp), jnp.asarray(frames)))
    got = P.mask_frames_to_blank(torch.tensor(lp), torch.from_numpy(frames))
    np.testing.assert_array_equal(got.numpy(), want)


def test_ctc_loss_fast_on_cpu_takes_the_plain_path(monkeypatch):
    """On a CPU tensor the dispatch runs the plain recursion and never
    loads (or builds) the kernel's library."""
    def no_load(name):
        raise AssertionError(f"kernel library {name!r} loaded on the CPU")
    monkeypatch.setattr(kernels, "load", no_load)
    before = P.ctc_loss_cuda.launches
    lp, labels, llens, _ = _case(4)
    B, T, _ = lp.shape
    got = P.ctc_loss_fast(torch.tensor(lp), torch.from_numpy(labels),
                          torch.from_numpy(llens))
    want = P.ctc_loss(torch.tensor(lp), torch.from_numpy(labels),
                      torch.full((B,), T), torch.from_numpy(llens))
    assert torch.equal(got, want)
    assert P.ctc_loss_cuda.launches == before


def test_ctc_loss_cuda_rejects_cpu_tensors():
    lp, labels, llens, _ = _case(5)
    with pytest.raises(ValueError, match="CUDA"):
        P.ctc_loss_cuda(torch.tensor(lp), torch.from_numpy(labels),
                        torch.from_numpy(llens))
