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
