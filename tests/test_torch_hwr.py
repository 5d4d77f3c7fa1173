"""Port parity for the recognizer: ``CNNOnlyHWR`` log-probs against the
flax model on the same numpy params (float32), the param converter, and
``max_pool``'s ``SAME`` padding."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from handwriting_line_generation_tpu.models import layers as J
from handwriting_line_generation_tpu.models.hwr import \
    CNNOnlyHWR as JCNNOnlyHWR
from handwriting_line_generation_tpu_torch.config import HWRConfig
from handwriting_line_generation_tpu_torch.convert import convert_hwr_params
from handwriting_line_generation_tpu_torch.init import init_hwr_params
from handwriting_line_generation_tpu_torch.models import layers as P
from handwriting_line_generation_tpu_torch.models.hwr import (
    CNNOnlyHWR, build_hwr,
)

NUM_CLASS = 20
# float32 on both sides; 11 convs of up to 4608 terms each, summed in
# another order by XLA and by torch's CPU kernels
TOL = dict(rtol=1e-4, atol=1e-4)


def _params(hwr, seed=0):
    """Seeded params with GroupNorm scale/bias randomized, so the
    converter's norm mapping is exercised."""
    tree = init_hwr_params(hwr, NUM_CLASS, seed)
    rng = np.random.default_rng(seed + 100)
    for sub in (tree["params"], tree["params"]["_ConvTrunk_0"]):
        for name, leaf in sub.items():
            if name.startswith("GroupNorm_"):
                c = leaf["scale"].shape[0]
                leaf["scale"] = (1 + 0.2 * rng.standard_normal(c)).astype(
                    np.float32)
                leaf["bias"] = (0.1 * rng.standard_normal(c)).astype(
                    np.float32)
    return tree


@pytest.mark.parametrize("pad,small,norm", [("none", False, "group"),
                                            ("less", False, "group"),
                                            ("none", True, "group"),
                                            ("pad", False, "none")])
def test_cnn_only_hwr_matches_jax(pad, small, norm):
    hwr = HWRConfig(kind="cnn_only", norm=norm, small=small, pad=pad)
    tree = _params(hwr)
    x = np.random.default_rng(1).uniform(-1, 1, (2, 64, 64, 1)).astype(
        np.float32)
    jm = JCNNOnlyHWR(num_class=NUM_CLASS, norm=norm, small=small, pad=pad)
    want = np.asarray(jm.apply(tree, jnp.asarray(x)))
    model = build_hwr("cnn_only", NUM_CLASS, norm, small, pad)
    model.load_state_dict(convert_hwr_params(tree))
    got = model(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape
    if not small and pad == "none":
        assert got.shape == (2, 16, NUM_CLASS)       # T = W / 4
    np.testing.assert_allclose(got, want, **TOL)


def test_convert_hwr_params_rejects_unknown_keys():
    tree = init_hwr_params(HWRConfig(norm="group"), NUM_CLASS)
    tree["params"]["Dense_0"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError):
        convert_hwr_params(tree)
    tree = init_hwr_params(HWRConfig(norm="group"), NUM_CLASS)
    tree["params"]["_ConvTrunk_0"]["Conv_0"]["extra"] = np.zeros(1)
    with pytest.raises(KeyError):
        convert_hwr_params(tree)


def test_convert_hwr_params_fills_every_parameter():
    model = CNNOnlyHWR(NUM_CLASS)
    sd = convert_hwr_params(init_hwr_params(HWRConfig(norm="group"),
                                            NUM_CLASS))
    assert set(sd) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert sd[k].shape == v.shape, k


def test_build_hwr_crnn_not_ported():
    """Ported since: ``crnn`` and ``small_crnn`` build their modules
    (``tests/test_torch_model_variants.py`` holds them against JAX); an
    unknown kind is refused."""
    from handwriting_line_generation_tpu_torch.models.hwr import (
        CRNN, SmallCRNN,
    )
    assert isinstance(build_hwr("crnn", NUM_CLASS), CRNN)
    assert isinstance(build_hwr("small_crnn", NUM_CLASS), SmallCRNN)
    assert build_hwr("none", NUM_CLASS) is None
    with pytest.raises(ValueError, match="unknown hwr kind"):
        build_hwr("lstm", NUM_CLASS)


@pytest.mark.parametrize("W", [7, 8, 13, 16])
@pytest.mark.parametrize("window,stride,padding", [
    ((2, 2), None, "VALID"), ((2, 2), (2, 1), "SAME"),
    ((3, 3), (2, 2), "SAME")])
def test_max_pool_matches_flax(W, window, stride, padding):
    x = np.random.default_rng(W).standard_normal((2, 6, W, 3)).astype(
        np.float32)
    want = np.asarray(J.max_pool(jnp.asarray(x), window, stride, padding))
    got = P.max_pool(torch.from_numpy(x).permute(0, 3, 1, 2), window, stride,
                     padding).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)
