"""The frozen FLOP counter and the kernels' bounds."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from counts import bounds
from counts.flops import count


def _stack():
    torch.manual_seed(0)
    return torch.nn.Sequential(
        torch.nn.Conv2d(3, 8, 3, padding=1), torch.nn.ReLU(),
        torch.nn.ConvTranspose2d(8, 4, 4, stride=2, padding=1),
        torch.nn.Conv2d(4, 2, 3, stride=2, groups=2),
        torch.nn.Flatten(), torch.nn.Linear(2 * 15 * 15, 5))


@pytest.mark.parametrize("backward", [False, True])
def test_counter_equals_torch_flop_counter(backward):
    m = _stack()
    x = torch.randn(2, 3, 16, 16, requires_grad=backward)

    def run():
        y = m(x).sum()
        if backward:
            y.backward()
    _, n = count(run)
    with FlopCounterMode(display=False) as fc:
        run()
    assert n == fc.get_total_flops() > 0


def test_transposed_conv_counts_no_inserted_zeros():
    """A stride-2 transposed conv counts its input positions, not the
    dilated ones: a quarter of XLA's direct convolution count."""
    m = torch.nn.ConvTranspose2d(8, 4, 3, stride=2, padding=1,
                                 output_padding=1, bias=False)
    x = torch.randn(1, 8, 10, 10)
    _, n = count(lambda: m(x))
    assert n == 2 * 10 * 10 * 9 * 8 * 4


def test_epilogue_bound_matches_the_recorded_one():
    """The nine calls of a B = 512, T = 192 bf16 forward: 1.7092 ms."""
    assert len(bounds.epilogue_calls(256, 192)) == 9
    ms = bounds.epilogue_forward_s(512, 192, 256, 2) * 1e3
    assert ms == pytest.approx(1.7092, abs=5e-5)
    assert bounds.epilogue_forward_s(512, 500, 256, 2) * 1e3 == \
        pytest.approx(4.4500, abs=5e-5)


def test_ctc_bound_matches_the_recorded_one():
    """(4, 500, 96) at 80 classes, forward and backward: 0.00038 ms."""
    ms = bounds.ctc_launch_s(4, 500, 96, 80, 4 * 500 * 3) * 1e3
    assert ms == pytest.approx(0.00038, abs=5e-6)
