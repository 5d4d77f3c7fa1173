"""``Charset.encode_batch`` and ``GenerationSession.encode_texts``: one
vectorized pass over a batch of texts, held value for value and dtype for
dtype against the per-text ``Charset.encode`` loop kept here as the
reference, and against the JAX session's ``encode_texts``."""

import numpy as np
import pytest
import torch

from handwriting_line_generation_tpu.charset import (
    IAM_CHARSET as J_IAM, RIMES_CHARSET as J_RIMES,
)
from handwriting_line_generation_tpu.inference.generate import \
    GenerationSession as JGenerationSession
from handwriting_line_generation_tpu_torch.charset import (
    IAM_CHARSET, RIMES_CHARSET,
)
from handwriting_line_generation_tpu_torch.inference.generate import \
    GenerationSession
from test_torch_threads import one_thread  # noqa: F401 (autouse)

CHARSETS = {"iam": (IAM_CHARSET, J_IAM), "rimes": (RIMES_CHARSET, J_RIMES)}


def _random(chars, n, lo=20, hi=40, seed=0):
    rng = np.random.default_rng(seed)
    pool = list(chars)
    return ["".join(rng.choice(pool, int(rng.integers(lo, hi + 1))))
            for _ in range(n)]


IAM_512 = _random(IAM_CHARSET.chars, 512)
# unknown to IAM: an accent, NUL, a non-BMP emoji, code points above every
# IAM character ('{', '~', Cyrillic, the BMP's last), a lone surrogate
UNKNOWN = ["café au lait", "a\x00b", "smile \U0001F600 now",
           "{x}~y", "Жuk", "end\uffff", "s\ud800t", "plain"]
CASES = {
    "iam_random_512": ("iam", IAM_512, None),
    "unknown_chars": ("iam", UNKNOWN, None),
    "empty_text_among": ("iam", ["abc", "", "de f"], None),
    "no_known_char": ("iam", ["hi there", "éè\x00\U0001F600"],
                      None),
    "all_texts_empty": ("iam", ["", ""], None),
    "label_len_shorter": ("iam", IAM_512[:64] + UNKNOWN, 7),
    "label_len_longer": ("iam", IAM_512[:64] + UNKNOWN, 57),
    "single_text": ("iam", ["A single line, with 3 marks!"], None),
    "rimes_accents": ("rimes", _random(RIMES_CHARSET.chars, 96, 1, 30, 1)
                      + ["à la forêt, déjà °",
                         "Straße ü été #!"], None),
}


def _reference(charset, texts, label_len=None):
    """The per-text loop ``encode_texts`` ran before the batch pass."""
    labels = [charset.encode(t) for t in texts]
    L = label_len or max(max(len(l) for l in labels), 1)
    labels = [l[:L] for l in labels]
    out = np.zeros((len(texts), L), np.int64)
    lens = np.zeros(len(texts), np.int64)
    for i, l in enumerate(labels):
        out[i, :len(l)] = l
        lens[i] = len(l)
    return out, lens


def _session(charset):
    return GenerationSession(torch.nn.Identity(), charset, device="cpu")


@pytest.mark.parametrize("case", sorted(CASES))
def test_encode_batch_equals_per_text_loop(case):
    """``encode_batch`` and ``encode_texts``: the loop's labels and lengths,
    bit for bit, in the loop's shapes and int64."""
    name, texts, label_len = CASES[case]
    charset = CHARSETS[name][0]
    want_labels, want_lens = _reference(charset, texts, label_len)
    labels, lens = charset.encode_batch(texts, label_len)
    t_labels, t_lens = _session(charset).encode_texts(texts, label_len)
    for got, want in ((labels, want_labels), (lens, want_lens),
                      (t_labels.numpy(), want_labels),
                      (t_lens.numpy(), want_lens)):
        np.testing.assert_array_equal(got, want, strict=True)
    assert t_labels.device.type == t_lens.device.type == "cpu"


@pytest.mark.parametrize("case", sorted(CASES))
def test_encode_texts_matches_jax(case):
    """The port's ``encode_texts`` against the JAX session's (int32 there,
    int64 here): the same values and shapes."""
    name, texts, label_len = CASES[case]
    charset, j_charset = CHARSETS[name]
    j_labels, j_lens = JGenerationSession(None, None, j_charset).encode_texts(
        texts, label_len)
    labels, lens = _session(charset).encode_texts(texts, label_len)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(j_labels))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(j_lens))


@pytest.mark.parametrize("label_len", [None, 4])
def test_no_texts(label_len):
    """No texts: without ``label_len`` both raise ``ValueError``; with it,
    both give ``[0, L]`` labels and no lengths."""
    if label_len is None:
        with pytest.raises(ValueError):
            _reference(IAM_CHARSET, [])
        with pytest.raises(ValueError):
            IAM_CHARSET.encode_batch([])
        return
    for labels, lens in (_reference(IAM_CHARSET, [], label_len),
                         IAM_CHARSET.encode_batch([], label_len)):
        assert labels.shape == (0, label_len) and lens.shape == (0,)
        assert labels.dtype == lens.dtype == np.int64
