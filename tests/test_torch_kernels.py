"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU with ``nvcc``: every test skips without one.  This file
imports no JAX, so on the GPU machine it runs without the JAX test
configuration:

    python -m pytest --noconftest tests/test_torch_kernels.py
"""

import pytest
import torch

from handwriting_line_generation_tpu_torch.ops import ctc
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


def _bias(dev, C, dtype, seed=5):
    g = torch.Generator(dev).manual_seed(seed)
    return (0.5 * torch.randn(C, generator=g, device=dev)).to(dtype)


def _check_epilogue(dev, dtype, blur, C, H, W, B=3, bias=False):
    args = _inputs(dev, B, H, W, C, dtype)
    kw = dict(apply_blur=blur, bias=_bias(dev, C, dtype) if bias else None)
    before = ge.block_epilogue.launches
    got = ge.block_epilogue(*args, **kw)
    torch.cuda.synchronize()
    assert ge.block_epilogue.launches == before + 1
    want = ge.block_epilogue_reference(*args, **kw)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


SHAPES = [(256, 4, 24), (16, 64, 96), (6, 5, 7), (2, 3, 33), (48, 8, 20)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("blur", [False, True])
@pytest.mark.parametrize("C,H,W", SHAPES)
def test_gen_epilogue_matches_plain(cuda, dtype, blur, C, H, W):
    _check_epilogue(cuda, dtype, blur, C, H, W)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("blur", [False, True])
@pytest.mark.parametrize("C,H,W", SHAPES)
def test_gen_epilogue_with_bias_matches_plain(cuda, dtype, blur, C, H, W):
    _check_epilogue(cuda, dtype, blur, C, H, W, bias=True)


# the generator's last block: one sample is 1.5 MB in bf16 and 3 MB in f32,
# far more than one block's 227 KB of shared memory.  bf16 keeps the sample
# in the cluster's shared memory; f32 does not fit and re-reads z from L2
@pytest.mark.parametrize("dtype,y_from", [(torch.float32, "L2"),
                                          (torch.bfloat16, "smem")])
@pytest.mark.parametrize("blur", [False, True])
def test_gen_epilogue_sample_larger_than_a_block(cuda, dtype, y_from, blur):
    shape = (2, 64, 768, 16)
    plan = ge.plan(shape, dtype, blur)
    assert plan["cluster"] == 8 and plan["y_from"] == y_from
    _check_epilogue(cuda, dtype, blur, 16, 64, 768, B=2, bias=True)


# chip_smoke.py phase 19's thumbnails: the paper generator (dim 256) at T =
# 64 spaced positions over a 128-style bank, float32, the conv bias folded
THUMB_CALLS = [(256, 4, 64, False), (128, 8, 64, True), (128, 8, 64, False),
               (64, 16, 64, True), (64, 16, 64, False), (32, 32, 128, True),
               (32, 32, 128, False), (16, 64, 256, True)]


@pytest.mark.parametrize("C,H,W,blur", THUMB_CALLS)
def test_gen_epilogue_at_the_thumbnail_shapes(cuda, C, H, W, blur):
    _check_epilogue(cuda, torch.float32, blur, C, H, W, B=128, bias=True)


def test_gen_epilogue_repeats_bit_for_bit(cuda):
    args = _inputs(cuda, 4, 16, 64, 32, torch.bfloat16, seed=1)
    a = ge.block_epilogue(*args, apply_blur=True)
    b = ge.block_epilogue(*args, apply_blur=True)
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gen_epilogue_with_bias_repeats_bit_for_bit(cuda, dtype):
    args = _inputs(cuda, 2, 64, 768, 16, dtype, seed=2)
    bias = _bias(cuda, 16, dtype)
    a = ge.block_epilogue(*args, apply_blur=True, bias=bias)
    b = ge.block_epilogue(*args, apply_blur=True, bias=bias)
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


# CTC kernel vs the plain recursion on the card, both float32.  The NLLs
# agree to a few ulps (expf/logf against torch's exp/log).  The kernel's
# gradient is exp(alpha + beta - z_t), a difference of log-probabilities of
# magnitude ~1e3 at T = 256 that float32 carries to ~1e-4 after T steps of
# rounding (z_t, the row's own log-sum-exp, cancels what the row shares),
# so each entry has that relative error; the plain version's autograd
# never forms the difference.  The JAX package holds its own Pallas kernel
# to its scan within rtol 1e-3 for the same reason.
CTC_NLL_TOL = dict(rtol=1e-5, atol=1e-4)
CTC_GRAD_TOL = dict(rtol=2e-3, atol=1e-5)


def _ctc_inputs(dev, B, T, C, L, seed=0):
    """log-softmax inputs with about a third of the frames masked, label
    lengths in [1, L], plus a repeated-character label, a length-0 label
    and (where L > T allows it) an impossible one."""
    g = torch.Generator(dev).manual_seed(seed)
    logits = torch.randn((B, T, C), generator=g, device=dev)
    lp = torch.log_softmax(logits, -1)
    lens = torch.randint(1, L + 1, (B,), generator=g, device=dev,
                         dtype=torch.int32)
    labels = torch.randint(1, C, (B, L), generator=g, device=dev,
                           dtype=torch.int32)
    labels = torch.where(torch.arange(L, device=dev)[None] < lens[:, None],
                         labels, 0)
    rep = torch.tensor([3, 3, 3, 7, 7, 1])[:L]
    labels[0, :len(rep)] = rep
    lens[0] = max(int(lens[0]), len(rep))
    labels[1] = 0
    lens[1] = 0
    frames = torch.randint(2 * T // 3, T + 1, (B,), generator=g, device=dev)
    return lp, labels.contiguous(), lens, frames


def _ctc_both(lp, labels, lens, frames):
    """(nll, grad) of the kernel and of the plain version, the gradient
    of the mean loss w.r.t. the unmasked log-probs."""
    out = []
    for kernel in (True, False):
        x = lp.clone().requires_grad_(True)
        y = ctc.mask_frames_to_blank(x, frames)
        B, T, _ = lp.shape
        if kernel:
            nll = ctc.ctc_loss_cuda(y, labels, lens, reduction="none")
        else:
            nll = ctc.ctc_loss(y, labels, torch.full_like(lens, T), lens,
                               reduction="none")
        (nll / torch.clamp(lens, min=1)).mean().backward()
        out.append((nll.detach(), x.grad))
    return out


# the four buckets; S = 2L + 1 on each side of a multiple of 32: L = 15, 16
# (forward only, one warp of one state a lane, then two; with the gradient,
# one warp of two states a lane) and L = 31, 32 (with the gradient, one
# warp, then two); a recursion over 5 warps (L = 130) and over 8 warps with
# 4 states a lane (L = 511); and T = 1
CTC_SHAPES = [(48, 24), (256, 72), (336, 96), (5, 9), (40, 15), (40, 16),
              (80, 31), (80, 32), (200, 130), (336, 511), (1, 3)]


@pytest.mark.parametrize("T,L", CTC_SHAPES)
def test_ctc_matches_plain(cuda, T, L):
    lp, labels, lens, frames = _ctc_inputs(cuda, 8, T, 80, L)
    before = ctc.ctc_loss_cuda.launches
    (nll_k, g_k), (nll_p, g_p) = _ctc_both(lp, labels, lens, frames)
    torch.cuda.synchronize()
    assert ctc.ctc_loss_cuda.launches == before + 1
    torch.testing.assert_close(nll_k, nll_p, **CTC_NLL_TOL)
    torch.testing.assert_close(g_k, g_p, **CTC_GRAD_TOL)


def test_ctc_impossible_label_zero_loss_and_grad(cuda):
    lp, labels, lens, frames = _ctc_inputs(cuda, 4, 6, 20, 12)
    lens[2] = 12                                  # 12 labels in 6 frames
    labels[2] = torch.arange(1, 13, dtype=torch.int32, device=cuda)
    x = lp.clone().requires_grad_(True)
    nll = ctc.ctc_loss_cuda(x, labels, lens, reduction="none")
    nll.sum().backward()
    assert nll[2].item() == 0.0
    assert (x.grad[2] == 0).all() and torch.isfinite(x.grad).all()


def test_ctc_grad_repeats_bit_for_bit(cuda):
    lp, labels, lens, frames = _ctc_inputs(cuda, 16, 256, 80, 72, seed=3)
    grads = [_ctc_both(lp, labels, lens, frames)[0][1] for _ in range(2)]
    assert torch.equal(grads[0], grads[1])


@pytest.mark.parametrize("T,L", CTC_SHAPES)
def test_ctc_forward_only_when_no_grad(cuda, T, L):
    lp, labels, lens, frames = _ctc_inputs(cuda, 8, T, 80, L)
    lp = ctc.mask_frames_to_blank(lp, frames)
    before = ctc.ctc_loss_cuda.launches
    with torch.no_grad():
        a = ctc.ctc_loss_cuda(lp, labels, lens, reduction="none")
    b = ctc.ctc_loss(lp, labels, torch.full_like(lens, T), lens,
                     reduction="none")
    assert ctc.ctc_loss_cuda.launches == before + 1
    torch.testing.assert_close(a, b, **CTC_NLL_TOL)


def test_ctc_rejects_bad_inputs(cuda):
    lp, labels, lens, _ = _ctc_inputs(cuda, 4, 48, 80, 24)
    with pytest.raises(TypeError):
        ctc.ctc_loss_cuda(lp.double(), labels, lens)
    with pytest.raises(TypeError):
        ctc.ctc_loss_cuda(lp, labels.long(), lens)
    with pytest.raises(ValueError, match="contiguous"):
        ctc.ctc_loss_cuda(lp.transpose(0, 1).contiguous().transpose(0, 1),
                          labels, lens)
    with pytest.raises(ValueError):
        ctc.ctc_loss_cuda(lp, labels[:2], lens)


# -- the style path on the card: plain PyTorch around the epilogue kernel --


def _style_model():
    from handwriting_line_generation_tpu_torch.config import (
        DiscriminatorConfig, GeneratorConfig, HWRConfig, ModelConfig,
        SpacerConfig, StyleConfig,
    )
    from handwriting_line_generation_tpu_torch.init import (
        init_model, seed_conv_biases,
    )
    cfg = ModelConfig(
        num_class=12, style=StyleConfig(style_dim=16, dim=8, char_dim=16,
                                        char_capacity=4),
        generator=GeneratorConfig(dim=32, fused_epilogue=True),
        discriminator=DiscriminatorConfig(enabled=False),
        spacer=SpacerConfig(dim=32), hwr=HWRConfig(kind="cnn_only",
                                                   norm="group"))
    model = init_model(cfg, seed=0)
    seed_conv_biases(model.generator, seed=1)
    return model.eval()


@pytest.mark.parametrize("masked", [False, True])
def test_viterbi_align_card_equals_cpu(cuda, masked):
    from handwriting_line_generation_tpu_torch.ops.align import (
        viterbi_align, viterbi_align_cuda,
    )
    g = torch.Generator().manual_seed(3)
    B, T, C, L = 8, 64, 12, 20
    lp = torch.log_softmax(torch.randn((B, T, C), generator=g), -1)
    lens = torch.randint(0, L + 1, (B,), generator=g)
    labels = torch.randint(1, C, (B, L), generator=g, dtype=torch.int32)
    labels = torch.where(torch.arange(L) < lens[:, None], labels, 0)
    if masked:
        lp = ctc.mask_frames_to_blank(
            lp, torch.randint(1, T + 1, (B,), generator=g))
    want = viterbi_align(lp, labels, lens)
    before = viterbi_align_cuda.launches
    got = viterbi_align(lp.to(cuda), labels.to(cuda), lens.to(cuda))
    assert viterbi_align_cuda.launches == before + 1
    assert torch.equal(got.cpu(), want)


def _viterbi_inputs(B, T, C, L, seed, lens=None, frames=None):
    """Log-softmax of seeded normals ``[B, T, C]``, labels in ``[1, C)``
    zero past each length (one line at ``L`` unless ``lens`` is given), and
    frames past ``frames`` masked to blank when given."""
    g = torch.Generator().manual_seed(seed)
    lp = torch.log_softmax(torch.randn((B, T, C), generator=g), -1)
    if lens is None:
        lens = torch.randint(0, L + 1, (B,), generator=g)
        lens[0] = L
    labels = torch.randint(1, C, (B, L), generator=g, dtype=torch.int32)
    labels = torch.where(torch.arange(L) < lens[:, None], labels, 0)
    if frames is not None:
        lp = ctc.mask_frames_to_blank(lp, frames)
    return lp, labels, lens


def _viterbi_case(name):
    g = torch.Generator().manual_seed(11)
    if name == "cell":
        # the reconstruction cell: B = 64, T = 256, C = 80, L = 72,
        # transcripts of 24-72 characters, ink of 512-1024 px
        B, T, L = 64, 256, 72
        lens = torch.randint(24, L + 1, (B,), generator=g)
        width = torch.randint(512, 1025, (B,), generator=g)
        return _viterbi_inputs(B, T, 80, L, 1, lens, (width + 3) // 4)
    if name.startswith("L="):
        # S = 2L + 1 on either side of a lane's and a warp's states
        L = int(name[2:])
        return _viterbi_inputs(6, 2 * L + 24, 12, L, L)
    if name.startswith("T="):
        return _viterbi_inputs(5, int(name[2:]), 7, 5, 3)
    if name == "repeats":
        # runs of one character: the skip between them is forbidden
        lp, labels, lens = _viterbi_inputs(4, 48, 7, 12, 4,
                                           torch.tensor([12, 9, 6, 12]))
        labels[0] = torch.tensor([3, 3, 3, 5, 5, 1, 1, 1, 1, 2, 2, 3])
        labels[3] = 4
        return lp, labels, lens
    if name == "too_long":
        # lines that cannot fit their frames, with and without a mask
        lens = torch.tensor([24, 24, 20, 3, 24, 0])
        return _viterbi_inputs(6, 16, 9, 24, 5, lens,
                               torch.tensor([16, 6, 16, 2, 1, 16]))
    if name == "masked":
        return _viterbi_inputs(8, 96, 12, 30, 6, None,
                               torch.randint(1, 97, (8,), generator=g))
    if name == "ties":
        # three distinct log-probs a frame: ties at every comparison
        lp, labels, lens = _viterbi_inputs(8, 64, 5, 16, 7)
        q = torch.randint(0, 3, lp.shape, generator=g).float()
        return torch.log_softmax(q, -1), labels, lens
    if name == "bf16":
        lp, labels, lens = _viterbi_case("cell")
        lens[1] = 72
        lp = ctc.mask_frames_to_blank(lp, torch.tensor([256, 60] + [256] * 62))
        return lp.to(torch.bfloat16), labels, lens
    if name == "bf16_too_long":
        lp, labels, lens = _viterbi_case("too_long")
        return lp.to(torch.bfloat16), labels, lens
    if name == "int64":
        lp, labels, lens = _viterbi_case("masked")
        return lp, labels.long(), lens.long()
    if name == "global_scratch":
        # (T - 1) x 64 bytes of moves a line: more than shared memory holds
        return _viterbi_inputs(3, 4000, 20, 72, 8)
    if name == "max_states":
        return _viterbi_inputs(2, 40, 30, 511, 9,
                               torch.tensor([511, 300]))
    raise KeyError(name)


VITERBI_CASES = ["cell", "L=15", "L=16", "L=31", "L=32", "L=63", "L=64",
                 "L=127", "L=128", "L=300", "L=0", "T=1", "T=2", "repeats",
                 "too_long", "masked", "ties", "bf16", "bf16_too_long",
                 "int64", "global_scratch", "max_states"]


@pytest.mark.parametrize("case", VITERBI_CASES)
def test_viterbi_kernel_equals_plain(cuda, case):
    """One launch of ``csrc/viterbi.cu`` a call, its path bit for bit the
    plain version's, on the CPU and on the card; its last label is the
    plain recursion's final state's."""
    from handwriting_line_generation_tpu_torch.ops import align
    lp, labels, lens = _viterbi_case(case)
    before = align.viterbi_align_cuda.launches
    got = align.viterbi_align(lp.to(cuda), labels.to(cuda), lens.to(cuda))
    torch.cuda.synchronize()
    assert align.viterbi_align_cuda.launches == before + 1
    assert got.dtype == labels.dtype and got.shape == lp.shape[:2]
    moves, final, ext = align.viterbi_moves(lp, labels, lens)
    want = align.viterbi_backtrace(moves, final, ext)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got[:, -1].cpu(), ext.gather(1, final[:, None])[:, 0])
    on_card = align.viterbi_backtrace(*align.viterbi_moves(
        lp.to(cuda), labels.to(cuda), lens.to(cuda)))
    assert torch.equal(got, on_card)


def test_viterbi_kernel_repeats_and_rejects_bad_inputs(cuda):
    from handwriting_line_generation_tpu_torch.ops import align
    lp, labels, lens = (x.to(cuda) for x in _viterbi_case("cell"))
    first = align.viterbi_align_cuda(lp, labels, lens)
    assert torch.equal(align.viterbi_align_cuda(lp, labels, lens), first)
    with pytest.raises(TypeError):
        align.viterbi_align_cuda(lp.half(), labels, lens)
    with pytest.raises(TypeError):
        align.viterbi_align(lp.double(), labels, lens)
    with pytest.raises(ValueError):
        align.viterbi_align_cuda(lp, labels.cpu(), lens)
    with pytest.raises(ValueError):
        align.viterbi_align_cuda(lp, labels[:3], lens)
    wide = torch.ones((lp.shape[0], 512), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        align.viterbi_align_cuda(lp, wide, lens)


def test_autoencode_card_matches_cpu(cuda):
    """``autoencode`` (a = 2, frame lengths) on the card through the
    epilogue kernel, 9 launches, against the CPU's plain path on the same
    weights and noise planes."""
    model = _style_model()
    g = torch.Generator().manual_seed(4)
    B, W = 4, 96
    image = torch.rand((B, 64, W, 1), generator=g) * 2 - 1
    labels = torch.randint(1, 12, (B, 8), generator=g)
    lens = torch.tensor([8, 5, 3, 6])
    frames = torch.tensor([24, 20, 17, 24])
    T = W // 4
    sizes = [(4, T), (8, T), (16, T), (32, 2 * T), (64, 4 * T)]
    noise = [torch.randn((B, h, w), generator=g) for h, w in sizes
             for _ in range(2)]
    with torch.no_grad():
        want, waux = model.autoencode(image, labels, lens, 2,
                                      frame_lengths=frames, noise=noise)
        model.to(cuda)
        before = ge.block_epilogue.launches
        got, aux = model.autoencode(
            image.to(cuda), labels.to(cuda), lens.to(cuda), 2,
            frame_lengths=frames.to(cuda), noise=[n.to(cuda) for n in noise])
        torch.cuda.synchronize()
    assert ge.block_epilogue.launches == before + 9
    assert torch.equal(aux["spaced_label"].cpu(), waux["spaced_label"])
    torch.testing.assert_close(aux["style"].cpu(), waux["style"],
                               atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got.cpu(), want, atol=1e-3, rtol=0.0)


# -- the autoencoder path: the CTC kernel at T = W/8 ----------------------

# the 192-, 1024- and 1344-px buckets at the autoencoder's T = W/8 frames,
# with their 24/72/96 labels
AUTO_CTC_SHAPES = [(24, 24), (128, 72), (168, 96)]


@pytest.mark.parametrize("T,L", AUTO_CTC_SHAPES)
def test_ctc_matches_plain_at_autoencoder_buckets(cuda, T, L):
    lp, labels, lens, frames = _ctc_inputs(cuda, 28, T, 80, L, seed=T)
    lens[2] = L                                   # cannot align in T // 2
    labels[2] = torch.randint(1, 80, (L,), device=cuda, dtype=torch.int32)
    frames[2] = T // 2
    (nll_k, g_k), (nll_p, g_p) = _ctc_both(lp, labels, lens, frames)
    torch.testing.assert_close(nll_k, nll_p, **CTC_NLL_TOL)
    torch.testing.assert_close(g_k, g_p, **CTC_GRAD_TOL)
    assert nll_k[2].item() == 0.0 and (g_k[2] == 0).all()


def test_auto_trainer_step_kernel_matches_plain(cuda):
    """One ``AutoTrainer`` loss at the paper width (B = 4, 64 x 256, T =
    32) through the kernel, against the same forward and dropout masks
    with the plain CTC: the loss and every parameter gradient."""
    import pathlib
    from handwriting_line_generation_tpu_torch.config import load_config
    from handwriting_line_generation_tpu_torch.training.auto_trainer import \
        AutoTrainer
    cfg = load_config(str(pathlib.Path(__file__).resolve().parents[1]
                          / "configs/iam_auto_2tight.json"))
    tr = AutoTrainer(cfg, device=cuda)
    tr.init_state(seed=0)
    g = torch.Generator(cuda).manual_seed(1)
    B, W, L = 4, 256, 12
    image = torch.randint(0, 256, (B, 64, W, 1), generator=g, device=cuda,
                          dtype=torch.uint8)
    label = torch.randint(1, 80, (B, L), generator=g, device=cuda,
                          dtype=torch.int32)
    lens = torch.tensor([12, 9, 5, 1], device=cuda, dtype=torch.int32)
    width = torch.tensor([256, 200, 128, 64], device=cuda, dtype=torch.int32)
    before = ctc.ctc_loss_cuda.launches
    loss_k, aux = tr.loss(image, label, lens, width)
    assert ctc.ctc_loss_cuda.launches == before + 1
    params = list(tr.model.parameters())
    g_k = torch.autograd.grad(loss_k, params, retain_graph=True)
    logp = aux["logp"]
    loss_p = tr.w_auto * aux["autoLoss"] + tr.w_recog * ctc.ctc_loss(
        logp, label, torch.full((B,), W // 8, device=cuda), lens)
    g_p = torch.autograd.grad(loss_p, params)
    torch.testing.assert_close(loss_k, loss_p, rtol=1e-5, atol=0.0)
    for a, b in zip(g_k, g_p):
        torch.testing.assert_close(a, b, rtol=0.0,
                                   atol=1e-3 * b.abs().max().item())


# -- the GAN path: the CTC kernel at its buckets, the discriminator ---------

# genRecog on a generated line of min(500, 6 x 96) frames with labels at 96;
# reconRecog at T = W/4 = 256 with labels at 72; the GAN's B = 2 x 2
GAN_CTC_SHAPES = [(500, 96), (256, 72)]


@pytest.mark.parametrize("T,L", GAN_CTC_SHAPES)
def test_ctc_matches_plain_at_gan_buckets(cuda, T, L):
    lp, labels, lens, frames = _ctc_inputs(cuda, 4, T, 80, L, seed=T)
    lens[2] = L                                   # cannot align in L // 2
    labels[2] = torch.randint(1, 80, (L,), device=cuda, dtype=torch.int32)
    frames[2] = L // 2
    (nll_k, g_k), (nll_p, g_p) = _ctc_both(lp, labels, lens, frames)
    torch.testing.assert_close(nll_k, nll_p, **CTC_NLL_TOL)
    torch.testing.assert_close(g_k, g_p, **CTC_GRAD_TOL)
    assert nll_k[2].item() == 0.0 and (g_k[2] == 0).all()


@pytest.mark.parametrize("T,L", GAN_CTC_SHAPES)
def test_ctc_gradient_close_to_float64(cuda, T, L):
    """The kernel's gradient against the plain recursion in float64, per
    sample, relative to the sample's largest entry: within 5e-4 (each
    gradient row is normalized by its own log-sum-exp; before that the
    error common to a row reached 2e-3 at T = 500)."""
    lp, labels, lens, frames = _ctc_inputs(cuda, 4, T, 80, L, seed=T)
    (_, g_k), _ = _ctc_both(lp, labels, lens, frames)
    _, g_64 = _ctc_both_f64(lp, labels, lens, frames)
    err = ((g_k.double() - g_64).abs().amax((1, 2))
           / g_64.abs().amax((1, 2)).clamp(min=1e-30))
    print(f"ctc ({T}, {L}): kernel gradient vs float64, per sample "
          + " ".join(f"{e:.2e}" for e in err.tolist()))
    assert (err <= 5e-4).all(), err


def _ctc_both_f64(lp, labels, lens, frames):
    """(nll, grad) of the plain recursion in float64, as ``_ctc_both``."""
    x = lp.double().requires_grad_(True)
    T = lp.shape[1]
    nll = ctc.ctc_loss(ctc.mask_frames_to_blank(x, frames), labels,
                       torch.full_like(lens, T), lens, reduction="none")
    (nll / torch.clamp(lens, min=1)).mean().backward()
    return nll.detach(), x.grad


def test_paper_discriminator_forward_backward(cuda):
    """The paper discriminator (dim 64, medium and low heads) at B = 4,
    64 x 1024: scores and parameter gradients on the card against the CPU
    (TF32 off), and its forward + backward time by CUDA events."""
    from handwriting_line_generation_tpu_torch.config import ModelConfig
    from handwriting_line_generation_tpu_torch.init import init_model
    from handwriting_line_generation_tpu_torch.profiling import event_ms
    cpu = init_model(ModelConfig(), seed=0).discriminator
    dev = init_model(ModelConfig(), seed=0).discriminator.to(cuda)
    g = torch.Generator().manual_seed(0)
    real, fake = (torch.tanh(torch.randn((4, 64, 1024, 1), generator=g))
                  for _ in range(2))
    out = []
    for d, x, y in ((cpu, real, fake), (dev, real.to(cuda), fake.to(cuda))):
        r, f = d(x), d(y)
        loss = sum(torch.relu(1 - a).mean() + torch.relu(1 + b).mean()
                   for a, b in zip(r, f))
        grads = torch.autograd.grad(loss, list(d.parameters()))
        out.append(([s.detach().cpu() for s in r + f],
                    [gr.cpu() for gr in grads]))
    assert [tuple(s.shape) for s in out[1][0][:2]] == [(4, 128), (4, 32)]
    for a, b in zip(out[1][0], out[0][0]):
        torch.testing.assert_close(a, b, atol=1e-3, rtol=0.0)
    for a, b in zip(out[1][1], out[0][1]):
        torch.testing.assert_close(a, b, rtol=0.0,
                                   atol=1e-3 * b.abs().max().item())
    params = list(dev.parameters())
    x, y = real.to(cuda), fake.to(cuda)

    def step():
        loss = sum(torch.relu(1 - a).mean() + torch.relu(1 + b).mean()
                   for a, b in zip(dev(x), dev(y)))
        torch.autograd.grad(loss, params)
    ms = event_ms(step)
    print(f"paper discriminator forward + backward (real + fake), B = 4, "
          f"64 x 1024, f32: {ms:.3f} ms on {torch.cuda.get_device_name(0)}")
    assert 0.0 < ms < 1e4


GAN_PAPER_LESSONS = [["count"], ["no-step", "gen"], ["auto", "auto-gen"],
                     ["disc"], ["no-step", "gen"], ["auto", "auto-gen"],
                     ["disc"]]


def _tiny_gan_trainer(cuda):
    from handwriting_line_generation_tpu_torch.config import (
        Config, DataConfig, DiscriminatorConfig, GeneratorConfig, HWRConfig,
        ModelConfig, SpacerConfig, StyleConfig, TrainerConfig,
    )
    from handwriting_line_generation_tpu_torch.training.gan_trainer import \
        GanTrainer
    cfg = Config(name="t")
    cfg.data = DataConfig(batch_size=2, a_batch_size=2,
                          label_buckets=(12,), augmentation=None)
    cfg.model = ModelConfig(
        hwr=HWRConfig(kind="cnn_only", norm="group"),
        style=StyleConfig(style_dim=32, dim=16, char_dim=16,
                          char_capacity=4),
        generator=GeneratorConfig(dim=64),
        discriminator=DiscriminatorConfig(dim=16), spacer=SpacerConfig(dim=32))
    cfg.trainer = TrainerConfig(loss_weights={"reconRecog": 1e-6,
                                              "genRecog": 1e-4},
                                curriculum={"0": GAN_PAPER_LESSONS})
    tr = GanTrainer(cfg, device=cuda)
    tr.init_state(seed=0)
    return tr


def test_gan_lessons_kernel_match_plain(cuda, monkeypatch):
    """One gen and one auto lesson of two identically seeded trainers
    (B = 4, 64 x 192) with deterministic algorithms, one through the
    kernel, one through the plain CTC:
    the losses, and the saved, fresh and merged gradient groups within
    1e-3 of each tensor's largest entry."""
    from handwriting_line_generation_tpu_torch.training import \
        gan_trainer as gt
    g = torch.Generator(cuda).manual_seed(2)
    B, W, L = 4, 192, 12
    batch = dict(
        image=torch.randint(0, 256, (B, 64, W, 1), generator=g, device=cuda,
                            dtype=torch.uint8),
        label=torch.randint(1, 80, (B, L), generator=g, device=cuda,
                            dtype=torch.int32),
        label_lengths=torch.tensor([12, 9, 5, 3], device=cuda,
                                   dtype=torch.int32),
        width=torch.tensor([192, 160, 128, 96], device=cuda,
                           dtype=torch.int32))
    fg = torch.rand((B, 64, W, 1), generator=g, device=cuda) > 0.5

    def plain(logp, label, lens):
        return ctc.ctc_loss(logp, label, torch.full(
            (logp.shape[0],), logp.shape[1], device=logp.device), lens)
    outs = []
    # deterministic cuDNN algorithms: the CTC is all that differs
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for route in (gt.ctc_loss_fast, plain):
            monkeypatch.setattr(gt, "ctc_loss_fast", route)
            tr = _tiny_gan_trainer(cuda)
            before = ctc.ctc_loss_cuda.launches
            text = tr.text.get_batch(label_len=L)
            gen = tr.step_gen_nostep(text["label"], text["label_lengths"],
                                     tr.gen_spaced_len)
            auto = tr.step_auto(batch["image"], batch["label"],
                                batch["label_lengths"], fg, batch["width"], 2)
            outs.append((gen, auto, ctc.ctc_loss_cuda.launches - before))
    finally:
        torch.use_deterministic_algorithms(False)
    assert [o[2] for o in outs] == [2, 0]
    for k_out, p_out, keys in ((outs[0][0], outs[1][0],
                                ("recog_g", "adv_g")),
                               (outs[0][1], outs[1][1],
                                ("main_g", "adv_g", "recog_g", "merged"))):
        for k, v in p_out.items():
            if k.endswith("Loss"):
                torch.testing.assert_close(k_out[k], v, rtol=1e-5, atol=0.0)
        for key in keys:
            for name, a, b in zip(tr.state.names, k_out[key], p_out[key]):
                torch.testing.assert_close(
                    a, b, rtol=0.0, atol=1e-3 * b.abs().max().item(),
                    msg=lambda m: f"{key} {name}: {m}")


def _gan_batches(dev, n, seed=3, B=4, W=192, L=12):
    """``n`` seeded batch dicts of u8 lines on ``dev`` (2 lines an
    author), with text and fg masks."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(n):
        lens = torch.randint(3, L + 1, (B,), generator=g, dtype=torch.int32)
        label = torch.randint(1, 80, (B, L), generator=g, dtype=torch.int32)
        label[torch.arange(L)[None, :] >= lens[:, None]] = 0
        image = torch.randint(0, 256, (B, 64, W, 1), generator=g,
                              dtype=torch.uint8)
        out.append(dict(image=image.to(dev), label=label.to(dev),
                        label_lengths=lens.to(dev),
                        width=torch.randint(W // 2, W + 1, (B,), generator=g,
                                            dtype=torch.int32).to(dev),
                        gt=["abc"] * B, a_batch_size=2,
                        fg_mask=(image < 128).to(dev)))
    return out


def _flat(x, p=""):
    if isinstance(x, dict):
        return [kv for k, v in x.items() for kv in _flat(v, f"{p}/{k}")]
    if isinstance(x, (list, tuple)):
        return [kv for k, v in enumerate(x) for kv in _flat(v, f"{p}/{k}")]
    return [(p, x)]


def _assert_states_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert [k for k, _ in fa] == [k for k, _ in fb]
    for (k, x), (_, y) in zip(fa, fb):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x.cpu(), y.cpu()), k
        else:
            assert x == y, k


def test_gan_state_dict_round_trip_on_card(cuda, tmp_path):
    """A GAN state on the card mid-curriculum (saved groups held, the bank
    filling) through ``save_checkpoint``/``load_checkpoint`` into a fresh
    trainer: every tensor and number equal."""
    from handwriting_line_generation_tpu_torch.utils import checkpoint
    tr = _tiny_gan_trainer(cuda)
    it = iter(_gan_batches(cuda, 3))
    for i in range(5):
        tr.run_lesson(tr.curriculum.get_lesson(i), it, iteration=i)
    assert tr.state.have_saved and tr.state.bank_count == 2
    checkpoint.save_checkpoint(str(tmp_path), "x", tr.state_dict())
    other = _tiny_gan_trainer(cuda)
    other.load_state_dict(checkpoint.load_checkpoint(str(tmp_path), "x"))
    assert other.state.style_bank.device == tr.state.style_bank.device
    _assert_states_equal(tr.state_dict(), other.state_dict())


def test_gan_eval_step_card_matches_cpu(cuda):
    """``eval_step`` of the same weights and noise planes on the card and
    on the CPU (TF32 off): each loss within 1e-3 relative."""
    g = torch.Generator().manual_seed(4)
    T = 48
    shapes = [(4, h, w, 1) for h, w in [(4, T)] * 2 + [(8, T)] * 2
              + [(16, T)] * 2 + [(32, 2 * T)] * 2 + [(64, 4 * T)] * 2]
    noise = [torch.randn(s, generator=g) for s in shapes]
    batch = _gan_batches("cpu", 1)[0]
    outs = []
    for dev in (cuda, torch.device("cpu")):
        tr = _tiny_gan_trainer(dev)
        args = [batch[k].to(dev) for k in ("image", "label", "label_lengths",
                                           "width")]
        outs.append(tr.eval_step(*args, 2, {"noise": [n.to(dev)
                                                      for n in noise]}))
    card, cpu = outs
    assert {k for k in card if k.startswith("val_")} == {
        "val_autoLoss", "val_perceptualLoss", "val_countLoss"}
    for k, v in cpu.items():
        if k.startswith("val_"):
            torch.testing.assert_close(card[k].cpu(), v, rtol=1e-3, atol=0.0)


def test_gan_train_lessons_launch_the_ctc_kernel(cuda, tmp_path,
                                                 monkeypatch):
    """Four iterations of ``GanTrainer.train`` on the card (count, gen,
    auto, disc), with a validation and a sample dump at the fourth: the
    CTC kernel launches once in each gen and auto lesson and nowhere else."""
    tr = _tiny_gan_trainer(cuda)
    c = tr.cfg.trainer
    c.save_dir, c.val_step, c.print_every = str(tmp_path), 4, 4
    c.log_step, c.save_step, c.save_step_minor = 4, 10 ** 9, 4
    launches, run = [], tr.run_lesson

    def counted(*a, **k):
        n = ctc.ctc_loss_cuda.launches
        out = run(*a, **k)
        launches.append(ctc.ctc_loss_cuda.launches - n)
        return out
    monkeypatch.setattr(tr, "run_lesson", counted)
    batches = _gan_batches(cuda, 3)
    n = ctc.ctc_loss_cuda.launches
    log = tr.train(iter(batches), iterations=4, valid=batches[:1],
                   val_batches=1)
    assert launches == [0, 1, 1, 0] and ctc.ctc_loss_cuda.launches - n == 2
    assert {"val_gen_CER", "CER"} <= {k for e in log.entries for k in e}
    assert (tmp_path / tr.cfg.name / "samples" / "iter4_gen.png").exists()


def test_gan_train_resume_on_card(cuda, tmp_path):
    """``checkpoint-latest`` written by ``train`` on the card and read by a
    fresh trainer's ``train``: its state equals the writer's, and it goes
    on from there (lesson 4 pulls the third batch)."""
    batches = _gan_batches(cuda, 3)
    trs = []
    for _ in range(2):
        tr = _tiny_gan_trainer(cuda)
        c = tr.cfg.trainer
        c.save_dir, c.val_step, c.print_every = str(tmp_path), 0, 0
        c.save_step, c.save_step_minor = 10 ** 9, 3
        tr.train(iter(batches), iterations=3)
        trs.append(tr)
    _assert_states_equal(trs[0].state_dict(), trs[1].state_dict())
    trs[1].train(iter(batches[2:]), iterations=4)
    assert trs[1].step == 4
