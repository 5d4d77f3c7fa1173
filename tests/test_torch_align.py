"""Port parity for the alignments (``ops/align.py``): ``viterbi_align`` and
``dtw_align`` equal to the JAX package's on the same log-probs, and the
Viterbi path optimal against brute force."""

import itertools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from handwriting_line_generation_tpu.ops import align as J
from handwriting_line_generation_tpu_torch.ops import align as P
from handwriting_line_generation_tpu_torch.ops.ctc import mask_frames_to_blank
from test_torch_kernels import VITERBI_CASES, _viterbi_case
from test_torch_threads import one_thread  # noqa: F401 (autouse)


def _log_probs(rng, B, T, C):
    logits = rng.standard_normal((B, T, C)).astype(np.float32)
    return np.array(jax.nn.log_softmax(jnp.asarray(logits), -1))


def _labels(rng, B, L, C, lens):
    labels = np.zeros((B, L), np.int32)
    for b in range(B):
        labels[b, :lens[b]] = rng.integers(1, C, size=lens[b])
    return labels


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_viterbi_equals_jax(seed):
    """B = 3, T = 40, L <= 12: repeated characters, lengths 0 and 1, and
    frames masked to blank past a per-sample length."""
    rng = np.random.default_rng(seed)
    B, T, C, L = 3, 40, 7, 12
    lp = _log_probs(rng, B, T, C)
    lens = np.array([12, [0, 1, 5][seed], 7], np.int32)
    labels = _labels(rng, B, L, C, lens)
    labels[0, :6] = [3, 3, 3, 5, 5, 1]
    frames = np.array([T, T - 9, 25], np.int32)
    lp = np.array(mask_frames_to_blank(torch.from_numpy(lp),
                                       torch.from_numpy(frames)))
    want = np.asarray(J.viterbi_align(jnp.asarray(lp), jnp.asarray(labels),
                                      jnp.asarray(lens)))
    got = P.viterbi_align(torch.from_numpy(lp), torch.from_numpy(labels),
                          torch.from_numpy(lens))
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, T)
    np.testing.assert_array_equal(got.numpy(), want)


def test_viterbi_equals_jax_below_big():
    """Labels longer than their unmasked frames: the path crosses masked
    frames and the alphas fall to -1e30 and below."""
    rng = np.random.default_rng(9)
    B, T, C, L = 4, 30, 6, 10
    lp = _log_probs(rng, B, T, C)
    lens = np.array([10, 9, 6, 3], np.int32)
    labels = _labels(rng, B, L, C, lens)
    labels[1, :4] = [2, 2, 4, 4]
    frames = np.array([5, 7, 3, 30], np.int32)
    lp = np.array(mask_frames_to_blank(torch.from_numpy(lp),
                                       torch.from_numpy(frames)))
    want = np.asarray(J.viterbi_align(jnp.asarray(lp), jnp.asarray(labels),
                                      jnp.asarray(lens)))
    got = P.viterbi_align(torch.from_numpy(lp), torch.from_numpy(labels),
                          torch.from_numpy(lens))
    np.testing.assert_array_equal(got.numpy(), want)


def test_viterbi_two_frames():
    rng = np.random.default_rng(5)
    lp = _log_probs(rng, 2, 2, 5)
    labels = np.array([[2], [0]], np.int32)
    lens = np.array([1, 0], np.int32)
    want = np.asarray(J.viterbi_align(jnp.asarray(lp), jnp.asarray(labels),
                                      jnp.asarray(lens)))
    got = P.viterbi_align(torch.from_numpy(lp), torch.from_numpy(labels),
                          torch.from_numpy(lens))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed,out_len", [(0, None), (1, None), (2, 30),
                                          (3, 90)])
def test_dtw_equals_jax(seed, out_len):
    rng = np.random.default_rng(seed)
    B, T, C, L = 3, 40, 7, 12
    lp = _log_probs(rng, B, T, C)
    labels = rng.integers(1, C, size=(B, L)).astype(np.int32)
    labels[1, :4] = [2, 2, 2, 4]
    want, wlen = J.dtw_align(jnp.asarray(lp), jnp.asarray(labels), out_len)
    got, glen = P.dtw_align(torch.from_numpy(lp), torch.from_numpy(labels),
                            out_len)
    np.testing.assert_array_equal(glen.numpy(), np.asarray(wlen))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32


def _collapse(seq):
    out, prev = [], -1
    for v in seq:
        if v != 0 and v != prev:
            out.append(int(v))
        prev = v
    return out


def test_viterbi_is_optimal_bruteforce():
    """The mirror of ``tests/test_align.py``'s check, on the port: no
    monotone CTC path that collapses to the label scores higher."""
    rng = np.random.default_rng(2)
    T, C = 6, 4
    label = np.array([[1, 2]], np.int32)
    lp = _log_probs(rng, 1, T, C)
    aligned = P.viterbi_align(torch.from_numpy(lp), torch.from_numpy(label),
                              torch.tensor([2])).numpy()[0]

    def score(seq):
        return sum(lp[0, t, seq[t]] for t in range(T))

    best_s = max(score(seq) for seq in itertools.product([0, 1, 2], repeat=T)
                 if _collapse(seq) == [1, 2])
    assert score(aligned) >= best_s - 1e-5
    assert _collapse(aligned) == [1, 2]


def test_viterbi_cpu_takes_the_plain_path():
    """A CPU tensor runs ``viterbi_moves`` + ``viterbi_backtrace`` and
    launches no kernel."""
    rng = np.random.default_rng(3)
    B, T, C, L = 3, 20, 6, 5
    lens = np.array([5, 0, 3], np.int32)
    lp = torch.from_numpy(_log_probs(rng, B, T, C))
    labels = torch.from_numpy(_labels(rng, B, L, C, lens))
    lens = torch.from_numpy(lens)
    before = P.viterbi_align_cuda.launches
    got = P.viterbi_align(lp, labels, lens)
    assert P.viterbi_align_cuda.launches == before
    assert got.dtype == labels.dtype
    assert torch.equal(got, P.viterbi_backtrace(*P.viterbi_moves(
        lp, labels, lens)))


@pytest.mark.parametrize("fn,device", [("viterbi_align", "meta"),
                                       ("viterbi_align_cuda", "cpu")])
def test_viterbi_refuses_a_device_it_does_not_run_on(fn, device):
    """Neither the CPU nor a CUDA tensor: ``viterbi_align`` raises, with
    no fallback; the kernel's wrapper takes CUDA tensors only."""
    lp = torch.zeros((2, 8, 5), device=device)
    labels = torch.ones((2, 3), dtype=torch.int32, device=device)
    before = P.viterbi_align_cuda.launches
    with pytest.raises(ValueError, match="(?i)cuda"):
        getattr(P, fn)(lp, labels, torch.tensor([3, 1]))
    assert P.viterbi_align_cuda.launches == before


def test_viterbi_kernel_source_is_built():
    """``csrc/viterbi.cu`` is among the sources ``kernels.build`` compiles,
    and exports the two entry points the wrapper binds."""
    from handwriting_line_generation_tpu_torch import kernels
    assert "viterbi" in kernels.SOURCES
    src = (kernels.CSRC_DIR / "viterbi.cu").read_text()
    for entry in ("viterbi_align(", "viterbi_scratch_bytes("):
        assert 'extern "C"' in src and entry in src


@pytest.mark.parametrize("case", VITERBI_CASES)
def test_viterbi_kernel_cases_equal_jax(case):
    """The inputs of every card case of ``test_viterbi_kernel_equals_plain``
    (the reconstruction cell's shape, each warp boundary, L = 0 and 511,
    T = 1 and 2, repeats, ties, lines too long, masked frames, bf16, int64,
    the global-scratch shape): the plain path equals the JAX package's
    ``viterbi_align`` on them, so the kernel, held bit for bit to the plain
    path on the card, is held to the reference too.

    Two inputs the JAX package does not take: labels of width 0 (its
    scan's carry changes shape), given instead as one zero column, whose
    states past ``2 len + 1 = 1`` no valid state reads; and T = 1 (its
    backtrace indexes an empty moves array), where the path is the final
    state alone, checked against the rule: the blank ``2 len`` when its
    first-frame score is >= the last label's, where only states 0 and 1
    have one."""
    lp, labels, lens = _viterbi_case(case)
    got = P.viterbi_align(lp, labels, lens)
    if lp.shape[1] == 1:
        with pytest.raises(IndexError):
            J.viterbi_align(jnp.asarray(lp.numpy()),
                            jnp.asarray(labels.numpy()),
                            jnp.asarray(lens.numpy()))
        ext = np.zeros((labels.shape[0], 2 * labels.shape[1] + 1), np.int64)
        ext[:, 1::2] = labels.numpy()
        for b, n in enumerate(lens.tolist()):
            a0 = [lp[b, 0, ext[b, s]].item() if s < 2 else -1e30
                  for s in range(2 * n + 1)]
            s = 2 * n if a0[2 * n] >= a0[max(2 * n - 1, 0)] else 2 * n - 1
            assert got[b, 0].item() == ext[b, s]
        return
    if labels.shape[1] == 0:
        labels = torch.zeros((labels.shape[0], 1), dtype=labels.dtype)
    lp_j = (jnp.asarray(lp.float().numpy()).astype(jnp.bfloat16)
            if lp.dtype == torch.bfloat16 else jnp.asarray(lp.numpy()))
    want = J.viterbi_align(lp_j, jnp.asarray(labels.numpy()),
                           jnp.asarray(lens.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
