"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU with ``nvcc``: every test skips without one.  This file
imports no JAX, so on the GPU machine it runs without the JAX test
configuration:

    python -m pytest --noconftest tests/test_torch_kernels.py
"""

import pytest
import torch

from handwriting_line_generation_tpu_torch.ops import gen_epilogue as ge

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=1e-4, rtol=0.0),
       torch.bfloat16: dict(atol=3e-2, rtol=2e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, B, H, W, C, dtype, seed=0):
    g = torch.Generator(dev).manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=g, device=dev)
    return ((2.0 * rn(B, H, W, C)).to(dtype), rn(B, H, W).to(dtype),
            (0.3 * rn(C)).to(dtype), (1.0 + 0.5 * rn(B, C)).to(dtype),
            rn(B, C).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("blur", [False, True])
@pytest.mark.parametrize("C,H,W", [(256, 4, 24), (16, 64, 96), (6, 5, 7),
                                   (2, 3, 33), (48, 8, 20)])
def test_gen_epilogue_matches_plain(cuda, dtype, blur, C, H, W):
    args = _inputs(cuda, 3, H, W, C, dtype)
    before = ge.block_epilogue.launches
    got = ge.block_epilogue(*args, apply_blur=blur)
    torch.cuda.synchronize()
    assert ge.block_epilogue.launches == before + 1
    want = ge.block_epilogue_reference(*args, apply_blur=blur)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def test_gen_epilogue_repeats_bit_for_bit(cuda):
    args = _inputs(cuda, 4, 16, 64, 32, torch.bfloat16, seed=1)
    a = ge.block_epilogue(*args, apply_blur=True)
    b = ge.block_epilogue(*args, apply_blur=True)
    assert torch.equal(a, b)


def test_gen_epilogue_rejects_bad_inputs(cuda):
    z, n, w, g, b = _inputs(cuda, 2, 4, 8, 16, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        ge.block_epilogue(z.transpose(1, 2), n.transpose(1, 2), w, g, b,
                          apply_blur=False)
    with pytest.raises(TypeError):
        ge.block_epilogue(z.half(), n, w, g, b, apply_blur=False)
    with pytest.raises(ValueError, match="noise"):
        ge.block_epilogue(z, n[:, :2], w, g, b, apply_blur=False)
