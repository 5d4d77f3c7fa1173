#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``handwriting_line_generation_tpu_torch``)
on one NVIDIA GPU.  Run from the repository root:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. device  — the card's name and power limit (``nvidia-smi``);
2. build   — every CUDA source of the port, compiled by ``nvcc`` together;
3. kernels — the generator epilogue against its plain PyTorch version on
   the card, at the paper-width block shapes (B = 8), float32 (TF32 off)
   and bfloat16, with and without a conv bias;
4. main path, generation — ``GenerationSession.render`` of 512 lines at
   paper width (bf16, fused epilogue, seeded weights, the styled blocks'
   conv biases set non-zero): shape, finiteness, range, the epilogue's
   launch count (one launch per call), and agreement with the plain path
   in bf16 and in f32;
5. timing, generation — lines/s, and at each of the main path's epilogue
   calls (B = 512, bf16, with a bias) the kernel checked against its plain
   version, then its time beside the plain version's and its bound (CUDA
   events), their ratio, and where the kernel keeps y between its phases
   (``smem``: the cluster's shared memory; ``L2``: z re-read);
6. CTC kernel — against its plain recursion on the card (TF32 off), at
   B = 16, C = 80 and the smallest, main and largest default buckets
   (T, L) = (48, 24), (256, 72), (336, 96), plus a bucket with L > T: a
   third of the frames masked, repeated characters, a length-0 label and
   an impossible label; per-sample NLL and gradient, and two runs' grads
   bit-equal;
7. main path, training — ``HWRTrainer`` on ``configs/iam_hwr.json``
   (full-width ``CNNOnlyHWR``, group norm, warp augmentation, f32, seeded
   weights): 30 train steps and 1 eval step on a seeded batch of 16 u8
   lines of 64 x 1024, finite and falling loss, 31 CTC launches; then one
   step's loss and gradients through the kernel against the plain CTC;
8. timing, training and CTC — ms per train step and trained lines/s; the
   CTC kernel (forward + backward, forward only), its plain version and
   ``F.ctc_loss`` at the three buckets, beside the bound;
9. main path, style extraction and autoencode — the paper model
   (``configs/iam_gan_paper.json``'s ``model``: ``cnn_only`` recognizer,
   char style encoder, generator 256, spacer; f32, fused epilogue, seeded
   weights and conv biases) on B = 64 u8 glyph lines of 64 x 1024, 32
   author pairs: ``extract_style`` (finite [64, 128] style, equal rows per
   pair), ``viterbi_align`` on the card bit-equal to the CPU,
   ``autoencode`` with 9 epilogue launches against the plain epilogue path
   (max abs <= 1e-3), the card's styles against the CPU's (TF32 off), and
   ``StyleExtractor.extract_dataset`` over an ``AuthorBatcher`` behind a
   ``Prefetcher`` (one row per pair, in order, with its ids); then
   extracted and autoencoded lines/s (CUDA-event medians of 10 after 3
   warm-ups, TF32 on and off), ``trace_style``'s per-layer split and one
   profiled window's idle share;
10. main path, autoencoder pretraining — ``AutoTrainer.train`` on
    ``configs/iam_auto_2tight.json`` (``Encoder2(32)`` + the no-skip
    ``PyramidDecoder(32)`` + the ``EHWR`` head over 80 classes, Adam, f32, TF32 off, seeded
    weights) on seeded u8 lines of 64 x 1024 at B = 28: 30 train steps and a
    validation over 2 batches, finite and falling losses, 32 CTC launches
    at T = W/8 = 128 frames; ``checkpoint-latest`` resumed by a fresh
    trainer, whose next step equals the first trainer's; one step's loss
    and gradients through the kernel against the plain CTC; the CTC kernel
    against its plain version at the autoencoder's (T, L) = (24, 24),
    (128, 72), (168, 96), B = 28; then ``trace_auto``'s per-layer split,
    ms per step and autoencoder-trained lines/s (CUDA-event medians, TF32
    off and on), one profiled window's idle share, and the CTC kernel's
    times at (28, 128, 72);
11. main path, GAN training — ``GanTrainer`` on
    ``configs/iam_gan_paper.json`` (the paper model at full width with its
    discriminator, the frozen ``2tight`` perceptual encoder, f32, TF32 off,
    seeded weights), its recognizer loaded from a checkpoint of phase 7's
    ``HWRTrainer`` and its encoder from phase 10's ``checkpoint-latest``
    (each tensor held equal to the saved one): two 7-lesson cycles, the
    image lessons on seeded u8 glyph lines of 64 x 1024 as 2 author pairs
    (labels at 72), the text lessons on ``TextSampler`` labels at 96
    (generated lines of 500 frames): finite losses, the style bank
    growing, every spectral-norm ``u`` moved and of unit norm, the frozen
    recognizer and encoder bit-unchanged, the discriminator moved in its
    lessons only, 4 CTC launches a cycle; one gen and one auto lesson's
    saved and merged gradients through the kernel against the plain CTC;
    the CTC kernel against its plain version at (B, T, L) = (4, 500, 96)
    and (4, 256, 72); then ``trace_gan``'s lesson and cycle times, rates,
    per-layer split and idle share;
12. main path, the GAN's training run — ``GanTrainer.train`` on the same
    trainer setup for 14 lessons (two cycles), logging, validating over 2
    batches (and with the SWA weights once SWA has started), starting SWA,
    dumping sample strips and saving ``checkpoint-latest`` every 7, a
    numbered checkpoint at 14: finite log entries with CER/WER, every
    ``val_*`` and ``swa_val_*`` value finite, ``model_best`` written at the
    first validation with its ``val_gen_CER``, ``checkpoint-latest-swa``'s
    ``swa_n``, the PNG strips decoded (zlib) to their expected sizes, 8 CTC
    launches; the run directory as it stood after lesson 7 resumed by a
    fresh trainer (its loaded state equal to the saved one bit for bit, its
    first lesson's losses within ``RESUME_RTOL`` of the uninterrupted
    run's, the parameters' distance after lesson 14 printed); then
    GAN-trained lines/s through ``train`` against ``run_lesson`` cycles in
    alternated 7-lesson blocks (and the loop's own host time a block), ms
    per SWA step, ms per validation batch and validated lines/s, ms and
    bytes per ``checkpoint-latest`` save, ms per sample dump, and the run's
    peak device memory;
13. under ``torch.profiler``, one CUDA launch per epilogue call (9 in a
    generation forward);
14. training from a config — the port's CLI
    (``handwriting_line_generation_tpu_torch.train.main``) on the card at
    the configs' full model widths: first ``render_line_hard`` renders a
    second, ``read_png_gray``'s ms a fixture page by its row pass and by
    the wavefront pass (the two held equal), and ``make_batcher``'s ms per
    batch (``iam_lines``, ``iam_author`` with fg masks, ``syn_hwr3``) from
    cold; then ``configs/iam_hwr.json`` over ``tests/fixtures/mini_iam``
    (B = 4) for 30 steps and a validation (finite, falling loss), ``-r -i
    40`` going on from step 30; its trained lines/s in alternated blocks
    of 100 steps each: through the CLI, through ``HWRTrainer.train`` on
    the same iterator's batches assembled first (through a
    ``Prefetcher``, and handed directly), and ``train_step`` alone on
    them (as host u8 arrays, and on the card); the loop's idle share from
    two profiled CLI runs of different lengths (their difference,
    start-up cancelled);
    ``iam_auto_2tight`` for 20 steps and a validation;
    ``iam_gan_paper`` for 14 lessons on those two checkpoints
    (``-a data.text_data=``: the built-in text) with a validation; and
    ``syn_hwr3`` for 10 steps on the v3 synthetic corpus rendered on the
    fly (lines/s against ``train_step`` on pre-rendered batches, and the
    loop's idle share as above); every stage's CTC launches counted
    exactly, and the kernel against its plain version and timed at each
    stage's shape;
15. inference from a checkpoint — the port's CLIs on phase 14's
    ``iam_gan_paper`` run over the mini-IAM fixture with
    ``model.generator.fused_epilogue=true``: ``get_styles`` (train and
    valid banks, a row per author group, finite, the card's styles against
    the CPU's within 1e-3 of the largest, no epilogue launch), ``generate``
    in all eight modes (``from-to`` on two fixture crops written as PNGs;
    every PNG read back equal to ``to_uint8`` of the session's images),
    ``evaluate`` with every ``--save-*`` channel for each checkpoint the
    run wrote (and through the plain epilogue path: CER/WER equal,
    ``autoLoss`` within 1e-3, recon PNGs within 1e-3 mean abs), ``evaluate
    --quality`` through the kernel and the plain path (every metric
    finite, ``realism_gap = gen_CER - real_CER``), ``eval_writer_id`` and
    ``play_styles``, each call's epilogue launches 9 a generator forward;
    the kernel against its plain version at the evaluation path's shapes
    (T = 112, 240, 256; B = 2, 30, 32; f32, TF32 off) with its times; then
    on the paper model at full width (f32, seeded weights and conv biases)
    over 8 batches of 32 u8 glyph lines of 64 x 1024: evaluated lines/s
    with no channel and with every channel, kernel against plain, TF32 off
    and on; ``QualityEvaluator.run``'s stage seconds (256 texts); and
    generated lines/s through the ``generate`` CLI's render mode against
    ``GenerationSession`` alone;
16. multi-process training on the one card — the train CLI under
    ``torchrun`` through this script's rank wrapper (``--rank-run``; f32,
    TF32 off):
    (a) ``iam_hwr`` for 10 steps (``--profile``) and ``iam_gan_paper`` for
    14 lessons (on phase 14's checkpoints) on two gloo ranks sharing
    ``cuda:0``: both ranks log the same losses, rank 0 alone writes the run
    directory, each rank's CTC launches counted (a step and a local
    validation batch each; genRecog and reconRecog twice a cycle), the
    first step's averaged gradients and loss bit-equal on both ranks and
    within 1e-5 of each tensor's max of one process on the concatenated
    batch (the parameters at the end within the CPU tests' Adam bound of
    it, a side check), the two ranks' HWR checkpoint resumed in one
    process; (b)
    ``iam_hwr`` for 4 steps as a world of 1 on NCCL and (c) on a 1 x 2
    ``--fsdp 2`` grid of two gloo ranks (sharded Adam), each writing the
    plain run's ``checkpoint-latest`` bit for bit (deterministic
    algorithms); (d) ``graft_entry.dryrun_multichip(2)`` on the card; (e)
    each rank's profile names ``ctc_kernel``; then the gradient bucket's
    ``all_reduce`` ms and bytes at the paper GAN's 1, 2 and 3 groups,
    GAN-trained lines/s on 2 ranks against 1 (the second cycle) and each
    rank's peak memory (gloo through the host on one card: not a
    multi-card NCCL figure);
17. the synthetic pipeline — ``python -m
    handwriting_line_generation_tpu_torch.pipeline`` on the card at the
    configs' widths over 8 x 8 synthetic lines: ``--family iam3`` with 20
    recognizer steps, 20 autoencoder steps and 14 GAN lessons on the
    written corpus (exit 0, each stage's ``checkpoint-latest`` at its
    budget, each stage process's CTC launches exact), the same call again
    (every stage skipped, no launch), and ``--family rimes3 --through
    spaced --check-cache`` (the ``spaced_loc`` cache built, every cached
    row equal to the live alignment, a count and an auto lesson with and
    without the cache giving equal losses and gradient groups, and 7
    curriculum lessons of two same-seed trainers, one reading the cache and
    one aligning live, giving equal losses lesson by lesson, under
    deterministic algorithms); then the CTC kernel against its plain
    version and timed at each stage's shape;
18. every model variant and the JAX checkpoints (f32 and TF32 off unless
    named) — (1) the committed JAX checkpoint ``tests/fixtures/jax_ckpt``
    (``model_best.msgpack``, written by the JAX package) through
    ``load_model`` (the decoder's MB/s), rendered through the epilogue
    kernel on the fixture's spaced text, styles and noise, within 1e-4 of
    the JAX render stored beside it (9 launches); (2) the CRNN recognizer
    at full width (hidden 512, B = 16, 64 x 1024, Adam 1e-3): 30 steps and
    an eval step through the CTC kernel, the loss falling, 31 launches, a
    step's gradients against the plain CTC, the step's ms and its device
    split (conv, LSTM, CTC, other, idle) from a profile; SmallCRNN for 5
    steps on 24-row bands 512 wide; (3) the 32-px family at the paper's
    widths: a 512-line bf16 render of the ``small`` generator (9 launches,
    32 rows, 2T columns) against the plain path, and the GAN paper cycle's
    gen and disc lessons at B = 4 on 32-row lines through the CTC kernel
    (the count and auto lessons need the char style encoder, whose trunk
    needs 64 rows in both packages); (4) ``phase_upsample`` at the paper's
    width: 9 launches, lines/s in turns against the sequential generator,
    an f32 forward within 1e-3 of it; (5) the normalization augmentation
    on 16 lines of 64 x 1024, the card against the CPU; the epilogue and
    the CTC kernel against their plain versions and timed at each new
    path's shapes;
19. the plotting and dataset-dump CLIs, on numpy alone (f32, TF32 off)
    — a style bank of the paper model (seeded weights and conv biases)
    over 8 x 32 u8 lines of 64 x 1024 as 16 author pairs, one thumbnail a
    style rendered by ``GenerationSession`` through the epilogue kernel (9
    launches; the kernel against its plain version at that shape), then
    ``umap_styles --thumbnails`` and ``umap_styles`` (960 x 960; each
    uncovered dot's centre pixel in its author's ``tab20`` colour at the
    axis transform of the PCA embedding; the last thumbnail at its point),
    ``graph --csv`` of phase 14's ``iam_gan_paper`` log (every sample's
    pixel drawn), ``play_styles --heatmap`` (its pixels ``VIRIDIS[d]``,
    recomputed) and ``inspect_dataset --augment`` over the mini-IAM
    fixture (twice: the same ``_aug.png`` files) and ``syn_hwr3``'s
    synthetic records, the augmentation on the card; every file decoded by
    the port's reader at its size, no matplotlib, cv2, PIL or JAX in
    ``sys.modules``; each call's seconds;
20. bf16 mixed-precision training (``model.compute_dtype = "bfloat16"``,
    TF32 off) — (a) phase 7's HWR path in bf16: 30 steps and an eval
    step, finite and falling loss, 31 CTC launches, one step through the
    kernel against the plain CTC (deterministic algorithms), every
    parameter and Adam moment float32; (b) phase 10's autoencoder path in
    bf16 the same way (30 steps, a validation, 32 launches, the resume);
    (c) two GAN cycles in bf16 on phases 7 and 10's checkpoints as phase
    11 holds them (finite losses, every ``u`` moved and of unit norm, the
    frozen recognizer and encoder bit-unchanged, 8 launches, a gen and an
    auto lesson against the plain CTC), parameters, moments and ``u``'s
    float32; (d) phase 14's float32 ``iam_gan_paper`` run continued by
    the train CLI with ``-r -a model.compute_dtype=bfloat16`` for 14
    lessons beside a float32 continuation from a copy of the same
    checkpoint, each bf16 loss within the float32 run's min-max band
    widened by its spread (JAX's criterion for its bf16 continuation),
    8 launches each; then ``get_styles`` and ``generate -m render`` of the
    bf16 checkpoint in bf16 through the epilogue kernel (9 launches,
    against the plain path within the bf16 bound; the kernel against its
    plain version at the render's shapes); (e) ms per HWR and autoencoder
    step and per GAN cycle in float32 with TF32 off, on, and in bf16
    (``trace_train.by_precision``);
21. the JAX package's last tools (``PERF.md`` §2, §5) — (a)
    ``scripts/mfu_report.py``'s report on the GAN cell (``iam_gan_paper``,
    B = 2 x 2, 64 x 1024 over the mini-IAM fixture, seeded, f32 with TF32
    off): the auto lesson's FLOPs, ms and MFU, two timed 7-lesson cycles,
    the generation forward of 512 lines at 500 spaced positions in bf16,
    the CTC kernel once an auto lesson and 9 epilogue launches a forward
    (every launch of the run counted), the auto lesson's and an 8-line
    forward's FLOPs equal on the card and the CPU and the 512-line count
    64 times the 8-line one, each MFU in (0, 1]; (b) ``trace_gen`` on the
    bench session: each styled block alone (2, 2, 2, 2, 1 launches, the
    head 0), the four ``phase_upsample`` x ``fused_epilogue`` arms (9
    launches with the kernel, 0 without; each render within the bf16
    bound of the baseline's) and the attribution arms;
22. summary — one JSON line of kernels (the epilogue at generation, on
    the evaluation path, on phase 18's paths, at phase 19's thumbnails
    and at phase 20's render; the CTC kernel once for
    each path that runs it, with that path's launches and main-bucket
    times; the CLI's stages, the distributed runs' ranks, the pipeline's
    stages, phase 18's recognizers at their own shapes and phase 20's
    bf16 paths), then the device line last.

Imports nothing of JAX.  Exits non-zero without a CUDA device.
"""

import itertools
import json
import math
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

HBM_BYTES_PER_S = 3.35e12          # H100 SXM memory rate
F32_OPS_PER_S = 67e12              # H100 SXM float32 outside tensor cores
# float operations per element of the epilogue: the bias add and its
# rounding (2), the separable blur (3 row sums of 4 ops, 1 column sum of 4,
# 1 rounding), noise (2), leaky_relu (2), statistics (3), normalize and
# affine (4)
OPS_PER_ELEM = {True: 30, False: 13}
TOLERANCE = {                      # kernel vs plain, same inputs, on the card
    "float32": dict(atol=1e-4, rtol=0.0),
    # a different summation order of the statistics may flip one bf16
    # rounding after normalization
    "bfloat16": dict(atol=3e-2, rtol=2e-2),
}
CHECK_BATCH = 8
MAIN_BATCH = 512
BF16_MEAN_ABS_BOUND = 0.02         # kernel path vs plain path, bf16 render
F32_MAX_ABS_BOUND = 1e-3           # kernel path vs plain path, f32 forward

DEVICE = "cuda"                    # the card every phase drives
REPO = pathlib.Path(__file__).resolve().parent
HWR_CONFIG = REPO / "configs" / "iam_hwr.json"
CTC_BATCH, CTC_CLASSES = 16, 80
# (T, L): the smallest, main and largest default (width, label) buckets,
# 192/1024/1344 px wide with 24/72/96 labels; the main one comes second
CTC_BUCKETS = [(48, 24), (256, 72), (336, 96)]
CTC_MAIN = 1
CTC_IMPOSSIBLE_BUCKET = (8, 12)    # every label longer than the frames
# kernel vs plain, float32 on the card.  NLL: expf/logf against torch's
# exp/log.  Gradient: the kernel forms exp(alpha + beta - z_t) from
# log-probabilities of magnitude ~1e3, which float32 carries to ~1e-4
# relative within a row after T steps (z_t, the row's own log-sum-exp,
# cancels the error common to the row; the JAX package bounds its Pallas
# kernel against its scan by rtol 1e-3)
CTC_NLL_TOL = dict(rtol=1e-5, atol=1e-4)
CTC_GRAD_TOL = dict(rtol=2e-3, atol=1e-5)
# float operations per (t, s) state of the valid label: ~20 for the alpha
# step (3 max, 3 sub, 3 exp, adds, 1 log), ~20 more for the beta step and
# the occupancy with its class sum
CTC_OPS = {True: 40, False: 20}
TRAIN_STEPS = 30
# one step's parameter gradients, kernel vs plain CTC, relative to each
# tensor's largest entry: the same forward, but cuDNN may pick other
# backward algorithms (other summation orders, atomics) for the two runs
TRAIN_GRAD_RTOL = 1e-3
# the same in bf16 (phase 20): the kernel's gradient of the log-probs is
# the plain CTC's to float32 precision (held within 1e-3 of its max), but
# where it differs in the last float32 bits a bf16 rounding in the backward
# may flip, by one bf16 unit (2^-8 of the value), and flips compound
# through the bf16 layers of the backward (a tensor of a GAN group up to
# 2.8e-2 off at its max): the parameter gradients are held in relative L2
# over the step's tensors within one bf16 unit (measured ~9e-4), and a GAN
# lesson's groups, whose CTC gradient crosses the recognizer and the
# generator (~25 bf16 layers), within eight (measured 3.1e-3 to 1.0e-2 in
# three calls: the state before the check differs call to call)
BF16_GRAD_L2 = 2 ** -8
BF16_GAN_GRAD_L2 = 2 ** -5
# styles of the same lines on the card and on the CPU (TF32 off), max abs
# difference over max |style|: the recognizer's and the trunk's f32 convs
# sum in other orders on the two devices
STYLE_CPU_RTOL = 1e-3
STYLE_CPU_LINES = 4                # 2 author pairs
AUTO_CONFIG = REPO / "configs" / "iam_auto_2tight.json"
AUTO_STEPS = 30
AUTO_VAL_BATCHES = 2
# the autoencoder's CTC runs at T = W/8: the 192-, 1024- and 1344-px
# buckets with their 24/72/96 labels (at 192 px many samples cannot align)
AUTO_CTC_BUCKETS = [(24, 24), (128, 72), (168, 96)]
AUTO_CTC_MAIN = 1
# a resumed trainer's next step against the uninterrupted one's, relative:
# the same state and inputs (cuDNN's forward algorithms are deterministic,
# so they should be bit-equal)
RESUME_RTOL = 1e-6
GAN_CYCLES = 2
# the GAN's CTC buckets at its B = 4: genRecog on a generated line of
# gen_spaced_len = min(500, 6 x 96) frames with labels at 96 (the main
# one, first), reconRecog at T = W/4 = 256 with labels at 72
GAN_CTC_BUCKETS = [(500, 96), (256, 72)]
# one lesson's gradients, kernel vs plain CTC, from the same state and
# draws, relative to each tensor's largest entry (as TRAIN_GRAD_RTOL)
GAN_GRAD_RTOL = 1e-3
# the GAN training run: two 7-lesson cycles, logging, validating, starting
# SWA, dumping strips and saving checkpoint-latest every 7 lessons, a
# numbered checkpoint at 14; then alternated timing blocks
GAN_TRAIN_ITERS, GAN_TRAIN_STEP, GAN_TRAIN_VAL_BATCHES = 14, 7, 2
GAN_TIMING_BLOCKS = 8


def block_shapes(dim=256, t=192):
    """(C, H, W) of the five styled blocks at paper width."""
    return [(dim, 4, t), (dim // 2, 8, t), (dim // 4, 16, t),
            (dim // 8, 32, 2 * t), (dim // 16, 64, 4 * t)]


def epilogue_calls(dim=256, t=192):
    """(block, C, H, W, apply_blur) of the 9 epilogue calls of a forward:
    blur in the first half of the upsampling blocks 1-4, and the last
    block's second half deferred into the final 1x1 conv."""
    calls = []
    for i, (c, h, w) in enumerate(block_shapes(dim, t)):
        calls.append((i, c, h, w, i > 0))
        if i < 4:
            calls.append((i, c, h, w, False))
    return calls


def epilogue_inputs(torch, b, c, h, w, dtype, seed):
    """(z, noise, nweight, gamma, beta) and a conv bias, seeded."""
    g = torch.Generator("cuda").manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=g, device="cuda")
    return ((rn(b, h, w, c) * 2.0).to(dtype), rn(b, h, w).to(dtype),
            (rn(c) * 0.3).to(dtype), (1.0 + 0.5 * rn(b, c)).to(dtype),
            rn(b, c).to(dtype)), (rn(c) * 0.5).to(dtype)


def check_epilogue(torch, ge, args, blur, dname, label, bias=None):
    """Kernel against its plain version on the same inputs; raises past
    ``TOLERANCE[dname]``.  Returns the max abs error."""
    tol = TOLERANCE[dname]
    got = ge.block_epilogue(*args, apply_blur=blur, bias=bias).float()
    want = ge.block_epilogue_reference(*args, apply_blur=blur,
                                       bias=bias).float()
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    ok = torch.allclose(got, want, **tol)
    print(f"gen_epilogue {dname} {label} blur={blur} "
          f"bias={bias is not None}: max_abs_err {err:.3e} "
          f"(atol {tol['atol']}, rtol {tol['rtol']}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("gen_epilogue disagrees with its plain version")
    return err


def count_device_kernels(torch, name, fn):
    """How many kernels whose name holds ``name`` ran on the card in
    ``fn()``, by ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(evt.count for evt in prof.key_averages()
               if evt.device_type == torch.autograd.DeviceType.CUDA
               and name in evt.key)


def ctc_inputs(torch, ctc, B, T, C, L, seed):
    """Log-softmax inputs with about a third of the frames masked to blank
    (mean over samples), label lengths in [1, L], and three edge cases
    (those the batch has room for): sample 0 repeats characters, sample 1
    has length 0, sample 2 has more labels than unmasked frames
    (impossible).  Returns ``(masked log-probs, labels, label_lengths)``;
    the first requires grad."""
    g = torch.Generator(DEVICE).manual_seed(seed)
    lp = torch.log_softmax(torch.randn((B, T, C), generator=g,
                                       device=DEVICE), -1)
    lens = torch.randint(1, L + 1, (B,), generator=g, device=DEVICE,
                         dtype=torch.int32)
    labels = torch.randint(1, C, (B, L), generator=g, device=DEVICE,
                           dtype=torch.int32)
    frames = torch.randint(T // 3, T + 1, (B,), generator=g, device=DEVICE)
    rep = torch.tensor([3, 3, 3, 7, 7, 1][:L], device=DEVICE)
    labels[0, :len(rep)] = rep
    lens[0] = max(int(lens[0]), len(rep))
    if B > 1:
        lens[1] = 0
    if B > 2:
        lens[2] = L
        frames[2] = max(1, min(T, L // 2))
    labels = torch.where(torch.arange(L, device=DEVICE)[None] < lens[:, None],
                         labels, 0).contiguous()
    x = ctc.mask_frames_to_blank(lp, frames).detach().requires_grad_(True)
    return x, labels, lens


def ctc_both(torch, ctc, x, labels, lens):
    """Per-sample NLL and the gradient of the mean loss w.r.t. ``x``,
    through the kernel and through the plain recursion."""
    out = []
    B, T, _ = x.shape
    for kernel in (True, False):
        if kernel:
            nll = ctc.ctc_loss_cuda(x, labels, lens, reduction="none")
        else:
            nll = ctc.ctc_loss(x, labels, torch.full_like(lens, T), lens,
                               reduction="none")
        loss = (nll / torch.clamp(lens, min=1)).mean()
        out.append((nll.detach(), torch.autograd.grad(loss, x)[0]))
    return out


def check_ctc(torch, ctc, T, L, seed, batch=CTC_BATCH):
    """Kernel against plain at one bucket; raises past the tolerances, on
    a non-zero impossible sample, or on grads that differ between two
    runs.  Returns the max abs error (NLL or grad)."""
    x, labels, lens = ctc_inputs(torch, ctc, batch, T, CTC_CLASSES, L,
                                 seed)
    (nll_k, g_k), (nll_p, g_p) = ctc_both(torch, ctc, x, labels, lens)
    torch.cuda.synchronize()
    e_nll = (nll_k - nll_p).abs().max().item()
    e_grad = (g_k - g_p).abs().max().item()
    r_grad = ((g_k - g_p).abs() / g_p.abs().clamp(min=CTC_GRAD_TOL["atol"])
              ).max().item()
    ok = (torch.allclose(nll_k, nll_p, **CTC_NLL_TOL)
          and torch.allclose(g_k, g_p, **CTC_GRAD_TOL))
    # batches under 3 rows hold no impossible sample (ctc_inputs)
    imp = batch < 3 or (nll_k[2].item() == 0.0 and bool((g_k[2] == 0).all()))
    _, g_again = ctc_both(torch, ctc, x, labels, lens)[0]
    same = torch.equal(g_k, g_again)
    print(f"ctc B={batch} T={T} L={L} C={CTC_CLASSES}: nll max_abs_err "
          f"{e_nll:.3e} (rtol {CTC_NLL_TOL['rtol']}, atol "
          f"{CTC_NLL_TOL['atol']}), grad max_abs_err {e_grad:.3e}, max "
          f"rel {r_grad:.3e} (rtol {CTC_GRAD_TOL['rtol']}, atol "
          f"{CTC_GRAD_TOL['atol']}), impossible sample "
          f"{'skipped (B < 3)' if batch < 3 else f'zero {imp}'}, repeat "
          f"bit-equal {same} {'ok' if ok and imp and same else 'FAIL'}",
          flush=True)
    if not (ok and imp and same):
        raise AssertionError("ctc kernel disagrees with its plain version")
    return max(e_nll, e_grad)


def train_main_path(torch, tt, ctc, HWRTrainer, load_config,
                    dtype="float32"):
    """30 train steps and 1 eval step of the HWR trainer through the CTC
    kernel, the model in ``dtype``.  Returns (launches, trainer, batch on
    the card)."""
    cfg = load_config(str(HWR_CONFIG))
    cfg.model.compute_dtype = dtype
    print(f"training config {HWR_CONFIG.name}: hwr {cfg.model.hwr.kind}/"
          f"{cfg.model.hwr.norm}, augmentation {cfg.data.augmentation}, "
          f"lr {cfg.optimizer.lr}, betas {cfg.optimizer.betas}, "
          f"{cfg.model.compute_dtype}", flush=True)
    tr = HWRTrainer(cfg, device=DEVICE)
    tr.init_state(seed=0)
    batch = tt.batch(seed=0, device=DEVICE)
    ctc.ctc_loss_cuda.launches = 0
    losses = [tr.train_step(*batch)[0] for _ in range(TRAIN_STEPS)]
    eval_loss, eval_logp = tr.eval_step(*batch)
    launches = ctc.ctc_loss_cuda.launches
    losses = torch.stack(losses).tolist()
    print("train losses " + " ".join(f"{v:.4f}" for v in losses)
          + f"; eval loss {eval_loss.item():.4f}; ctc launches {launches}",
          flush=True)
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    if not all(math.isfinite(v) for v in losses + [eval_loss.item()]):
        raise AssertionError("a training loss is not finite")
    if not last < first:
        raise AssertionError(f"loss did not fall: first five {first:.4f}, "
                             f"last five {last:.4f}")
    if launches != TRAIN_STEPS + 1:
        raise AssertionError(f"expected {TRAIN_STEPS + 1} ctc launches, got "
                             f"{launches}")
    want = (tt.B, tt.W // 4, CTC_CLASSES)
    if tuple(eval_logp.shape) != want:
        raise AssertionError(f"log-probs {tuple(eval_logp.shape)}, want "
                             f"{want}")
    print(f"main path training: mean loss of the first five steps "
          f"{first:.4f}, of the last five {last:.4f}; log-probs "
          f"{tuple(eval_logp.shape)}", flush=True)
    return launches, tr, batch


def check_train_grads(torch, ctc, HWRTrainer, load_config, batch,
                      dtype="float32"):
    """One step's loss and gradients through the kernel and through the
    plain CTC, from the same weights and batch, augmentation off, the
    model in ``dtype`` (bf16 with deterministic cuDNN algorithms: a bf16
    gradient's rounding would show another algorithm's summation order)."""
    cfg = load_config(str(HWR_CONFIG))
    cfg.data.augmentation = None
    cfg.model.compute_dtype = dtype
    tr = HWRTrainer(cfg, device=DEVICE)
    tr.init_state(seed=0)
    params = list(tr.model.parameters())
    with _deterministic(torch, dtype != "float32"):
        loss_k, logp = tr.loss(*batch)
        g_k = torch.autograd.grad(loss_k, [logp] + params, retain_graph=True)
        B, T, _ = logp.shape
        loss_p = ctc.ctc_loss(logp, batch[1],
                              torch.full((B,), T, device=DEVICE), batch[2])
        g_p = torch.autograd.grad(loss_p, [logp] + params)
    _grads_agree(loss_k, loss_p, g_k, g_p, dtype, "one step")


class _deterministic:
    """cuDNN's deterministic algorithms and torch's deterministic mode
    while ``on``."""

    def __init__(self, torch, on=True):
        self.torch, self.on = torch, on

    def __enter__(self):
        if self.on:
            self.torch.backends.cudnn.deterministic = True
            self.torch.use_deterministic_algorithms(True, warn_only=True)

    def __exit__(self, *exc):
        if self.on:
            self.torch.backends.cudnn.deterministic = False
            self.torch.use_deterministic_algorithms(False)


def _rel_max(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


def _rel_l2(got, want):
    num = sum(float((a.double() - b.double()).square().sum())
              for a, b in zip(got, want))
    den = sum(float(b.double().square().sum()) for b in want)
    return math.sqrt(num / den) if den > 0 else math.sqrt(num)


def _grads_agree(loss_k, loss_p, g_k, g_p, dtype, what):
    """A step's loss and gradients (the log-probs' first, then each
    parameter's) through the kernel against the plain CTC; raises past
    the bounds (each parameter tensor within ``TRAIN_GRAD_RTOL`` of its
    max; in bf16 the parameters within ``BF16_GRAD_L2`` in relative
    L2)."""
    rel_loss = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    d_logp = _rel_max(g_k[0], g_p[0])
    worst = max(_rel_max(a, b) for a, b in zip(g_k[1:], g_p[1:]))
    l2 = _rel_l2(g_k[1:], g_p[1:])
    ok = rel_loss <= 1e-5 and d_logp <= TRAIN_GRAD_RTOL and (
        worst <= TRAIN_GRAD_RTOL if dtype == "float32"
        else l2 <= BF16_GRAD_L2)
    bounds = (f"bound {TRAIN_GRAD_RTOL}; relative L2 {l2:.2e}"
              if dtype == "float32" else
              f"relative L2 {l2:.2e}, bound {BF16_GRAD_L2:.3g}")
    print(f"{what} ({dtype}), kernel vs plain CTC: loss "
          f"{loss_k.item():.6f} vs {loss_p.item():.6f} (rel {rel_loss:.2e}, "
          f"bound 1e-5); log-probs' gradient max abs diff / max abs "
          f"{d_logp:.2e} (bound {TRAIN_GRAD_RTOL}); worst parameter "
          f"gradient {worst:.2e} ({bounds}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{what} through the kernel disagrees with "
                             f"the plain CTC")


def time_train(tt, tr, batch, iters=10, warmup=3):
    """ms per train step, by CUDA events around ``iters`` steps."""
    return tt.event_ms(lambda: tr.train_step(*batch), iters, warmup)


def time_ctc(torch, tt, F, ctc, T, L, card, batch=CTC_BATCH):
    """Kernel (forward + backward, forward only), plain and F.ctc_loss
    times at one bucket, and the bound.  Returns a dict of ms."""
    x, labels, lens = ctc_inputs(torch, ctc, batch, T, CTC_CLASSES, L,
                                 seed=T)
    m = x.detach().contiguous()
    B, C = batch, CTC_CLASSES
    t_k = tt.event_ms(lambda: ctc._launch(m, labels, lens, True), 50)
    t_f = tt.event_ms(lambda: ctc._launch(m, labels, lens, False), 50)
    tfull = torch.full_like(lens, T)
    t_p = tt.event_ms(lambda: torch.autograd.grad(ctc.ctc_loss(
        x, labels, tfull, lens, reduction="none").sum(), x), 3, warmup=1)
    xt = m.transpose(0, 1).detach().clone().requires_grad_(True)
    lab64, len64, t64 = labels.long(), lens.long(), tfull.long()
    lib = lambda: F.ctc_loss(xt, lab64, t64, len64, blank=0,
                             reduction="none", zero_infinity=True)
    t_l = tt.event_ms(lambda: torch.autograd.grad(lib().sum(), xt), 20)
    with torch.no_grad():
        # values only, over the possible samples: F.ctc_loss zeroes only
        # infinite losses, and the masked frames' -1e30 keeps an
        # impossible one finite (~1e30)
        got = ctc.ctc_loss_cuda(m, labels, lens, reduction="none")
        ref = lib()
        d_lib = torch.where(ref < 5e29, (ref - got).abs(), 0.0).max()
    cells = int((T * (2 * lens.long() + 1)).sum())
    bounds = {}
    for grad in (True, False):
        nbytes = (B * T * C * 4 * (2 if grad else 1)
                  + B * L * 4 + B * 4 + B * 4)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = cells * CTC_OPS[grad] / F32_OPS_PER_S * 1e3
        bounds[grad] = (max(t_bytes, t_ops),
                        "bytes" if t_bytes >= t_ops else "operations")
    print(f"ctc B={B} T={T} L={L} C={C}: kernel fwd+bwd {t_k:.4f} ms, "
          f"fwd {t_f:.4f} ms; plain fwd+bwd {t_p:.4f} ms; F.ctc_loss "
          f"fwd+bwd {t_l:.4f} ms (nll max abs diff to the kernel "
          f"{d_lib.item():.3e}); bound fwd+bwd {bounds[True][0]:.5f} ms "
          f"({bounds[True][1]}), fwd {bounds[False][0]:.5f} ms {card}",
          flush=True)
    return dict(ms=t_k, fwd_ms=t_f, plain_ms=t_p, library_ms=t_l,
                bound_ms=bounds[True][0], bound_by=bounds[True][1])


class _Prefetched:
    """A batcher whose batches come through a ``Prefetcher``."""

    def __init__(self, batcher, prefetcher):
        self.batcher, self.prefetcher = batcher, prefetcher

    def batches(self, rng, shuffle=True):
        return self.prefetcher(self.batcher.batches(rng, shuffle), depth=2)


def style_main_path(torch, np, ge, ts, card):
    """Phase 9: style extraction and autoencode on the paper model, its
    checks, rates and per-layer split."""
    from handwriting_line_generation_tpu_torch.charset import IAM_CHARSET
    from handwriting_line_generation_tpu_torch.config import DataConfig
    from handwriting_line_generation_tpu_torch.data.datasets import (
        AuthorBatcher, LineRecord, Prefetcher,
    )
    from handwriting_line_generation_tpu_torch.inference.styles import \
        StyleExtractor
    from handwriting_line_generation_tpu_torch.ops.align import \
        viterbi_align
    model = ts.paper_model(DEVICE)
    c = model.cfg
    print(f"style config {ts.CONFIG.name}: hwr {c.hwr.kind}/{c.hwr.norm}, "
          f"style {c.style.kind} dim {c.style.dim} char_dim "
          f"{c.style.char_dim} window {c.style.window} K "
          f"{c.style.char_capacity} style_dim {c.style.style_dim}, "
          f"generator {c.generator.dim}, {c.compute_dtype}, fused epilogue; "
          f"B={ts.B}, a={ts.A}, 64x{ts.tt.W}", flush=True)
    data = ts.inputs(DEVICE)
    image, label, lens, frames, width = data
    B, A = ts.B, ts.A
    noise = lambda: torch.Generator(DEVICE).manual_seed(0)
    with torch.inference_mode():
        style, pred = model.extract_style(image, A, frame_lengths=frames)
        spaced = viterbi_align(pred, label, lens)
        ge.block_epilogue.launches = 0
        recon, aux = model.autoencode(image, label, lens, A,
                                      frame_lengths=frames,
                                      generator=noise())
        launches = ge.block_epilogue.launches
        model.generator.fused_epilogue = False
        plain, _ = model.autoencode(image, label, lens, A,
                                    frame_lengths=frames, generator=noise())
        model.generator.fused_epilogue = True
    pairs_equal = torch.equal(style[0::2], style[1::2])
    print(f"extract_style: style {tuple(style.shape)}, finite "
          f"{bool(torch.isfinite(style).all())}, rows of each pair equal "
          f"{pairs_equal}, max |style| {style.abs().max().item():.4f}",
          flush=True)
    if tuple(style.shape) != (B, c.style.style_dim) or not pairs_equal \
            or not bool(torch.isfinite(style).all()):
        raise AssertionError("extract_style: bad style")
    spaced_cpu = viterbi_align(pred.cpu(), label.cpu(), lens.cpu())
    same = torch.equal(spaced.cpu(), spaced_cpu)
    print(f"viterbi_align [{B}, {pred.shape[1]}] card vs CPU: bit-equal "
          f"{same}", flush=True)
    if not same or not torch.equal(aux["spaced_label"], spaced):
        raise AssertionError("viterbi_align on the card differs from the "
                             "CPU")
    err = (recon - plain).abs().max().item()
    print(f"autoencode: image {tuple(recon.shape)}, gen_epilogue launches "
          f"{launches}; kernel vs plain epilogue path max abs diff "
          f"{err:.3e} (bound {F32_MAX_ABS_BOUND})", flush=True)
    if launches != 9:
        raise AssertionError(f"expected 9 gen_epilogue launches per "
                             f"autoencode forward, got {launches}")
    if tuple(recon.shape) != (B, 64, ts.tt.W, 1) \
            or not bool(torch.isfinite(recon).all()) \
            or recon.abs().max().item() > 1.0:
        raise AssertionError("autoencode: bad image")
    if not err <= F32_MAX_ABS_BOUND:
        raise AssertionError("autoencode through the kernel disagrees with "
                             "the plain path")

    # the same model on the CPU, on the first author pairs
    n = STYLE_CPU_LINES
    cpu_model = ts.paper_model("cpu")
    with torch.inference_mode():
        style_cpu, _ = cpu_model.extract_style(
            image[:n].cpu(), A, frame_lengths=frames[:n].cpu())
    del cpu_model
    rel = ((style[:n].cpu() - style_cpu).abs().max()
           / style_cpu.abs().max()).item()
    print(f"style, card (B={B}) vs CPU (first {n} lines), TF32 off: max abs "
          f"diff / max |style| {rel:.3e} (bound {STYLE_CPU_RTOL})",
          flush=True)
    if not rel <= STYLE_CPU_RTOL:
        raise AssertionError("styles on the card differ from the CPU's")

    # extract_dataset over in-memory records, behind a prefetcher
    img_np, wid = image.cpu().numpy(), width.cpu().numpy()
    lab_np, len_np = label.cpu().numpy(), lens.cpu().numpy()
    records = [LineRecord(
        author=f"a{i // A:02d}", gt=IAM_CHARSET.decode(lab_np[i, :len_np[i]]),
        load=lambda a=img_np[i, :, :wid[i], 0]: a, rid=f"line{i:02d}")
        for i in range(B)]
    batcher = AuthorBatcher(records, IAM_CHARSET, B // A, A,
                            DataConfig(width_buckets=(ts.tt.W,),
                                       label_buckets=(ts.tt.L,)),
                            with_fg=False)
    bank = StyleExtractor(model, device=DEVICE).extract_dataset(
        _Prefetched(batcher, Prefetcher))
    want_ids = [f"line{i:02d};line{i + 1:02d}" for i in range(0, B, A)]
    want_authors = [f"a{g:02d}" for g in range(B // A)]
    d = np.abs(bank["styles"] - style[::A].cpu().numpy()).max()
    scale = style.abs().max().item()
    in_order = bank["ids"] == want_ids and bank["authors"] == want_authors
    ok = (in_order and bank["styles"].shape == (B // A, c.style.style_dim)
          and d <= STYLE_CPU_RTOL * scale)
    print(f"extract_dataset: {len(bank['ids'])} rows, ids and authors in "
          f"batcher order {in_order}, max abs diff to extract_style "
          f"{d:.3e} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("extract_dataset: wrong rows")

    # rates (TF32 on here; off in the report), then the per-layer split
    # and one profiled window
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    on = ts.end_to_end(model, *data[:4])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"extract_style {on['extract_ms']:.3f} ms: "
          f"{on['extracted_lines_per_s']:.1f} extracted lines/s; autoencode "
          f"{on['autoencode_ms']:.3f} ms: "
          f"{on['autoencoded_lines_per_s']:.1f} autoencoded lines/s "
          f"(B={B}, 64x{ts.tt.W}, f32, TF32 on) {card}", flush=True)
    ts.report(model, data, card)
    del model
    torch.cuda.empty_cache()


def auto_batch(ta, seed):
    """A batch dict of ``trace_auto.B`` seeded u8 lines on the card, with
    the text of each label."""
    from handwriting_line_generation_tpu_torch.charset import IAM_CHARSET
    image, label, lens, width = ta.inputs(DEVICE, seed)
    lab, n = label.cpu().numpy(), lens.cpu().numpy()
    return dict(image=image, label=label, label_lengths=lens, width=width,
                gt=[IAM_CHARSET.decode(lab[b, :n[b]]) for b in range(len(n))])


def _args(batch):
    return [batch[k] for k in ("image", "label", "label_lengths", "width")]


def auto_main_path(torch, ctc, ta, load_config, run_dir, dtype="float32"):
    """30 steps of ``AutoTrainer.train`` with a validation over 2 batches
    at the end, checkpoints in ``run_dir``, the model in ``dtype``; then a
    fresh trainer resumes from ``checkpoint-latest`` and its next step is
    held against the first trainer's.  Returns (CTC launches, trainer,
    batch)."""
    from handwriting_line_generation_tpu_torch.training.auto_trainer import \
        AutoTrainer
    cfg = load_config(str(AUTO_CONFIG))
    cfg.model.compute_dtype = dtype
    ae = cfg.autoencoder
    print(f"autoencoder config {AUTO_CONFIG.name}: kind {ae.kind}, "
          f"{ae.hwr_classes} classes, lr {cfg.optimizer.lr}, betas "
          f"{cfg.optimizer.betas}, loss weights {cfg.trainer.loss_weights}, "
          f"{cfg.model.compute_dtype}; B={ta.B}, 64x{ta.tt.W}", flush=True)
    cfg.trainer.save_dir = run_dir
    cfg.trainer.log_step = 1
    cfg.trainer.val_step = cfg.trainer.save_step_minor = AUTO_STEPS
    tr = AutoTrainer(cfg, device=DEVICE)
    tr.init_state(seed=0)
    batch = auto_batch(ta, seed=0)
    valid = [auto_batch(ta, seed=s) for s in (1, 2)]
    entries = []
    ctc.ctc_loss_cuda.launches = 0
    tr.train(itertools.repeat(batch, AUTO_STEPS), iterations=AUTO_STEPS,
             valid=valid, val_batches=AUTO_VAL_BATCHES,
             on_log=entries.append)
    launches = ctc.ctc_loss_cuda.launches
    steps = [e for e in entries if "loss" in e]
    val = [e for e in entries if "val_CER" in e]
    losses = [e["loss"] for e in steps]
    print("autoencoder train losses " + " ".join(f"{v:.4f}" for v in losses)
          + f"; last autoLoss {steps[-1]['autoLoss']:.4f}, recogLoss "
          f"{steps[-1]['recogLoss']:.4f}; validation {val}; ctc launches "
          f"{launches}", flush=True)
    if len(steps) != AUTO_STEPS or len(val) != 1:
        raise AssertionError(f"{len(steps)} steps and {len(val)} "
                             f"validations logged")
    if not all(math.isfinite(e[k]) for e in steps
               for k in ("loss", "autoLoss", "recogLoss")) \
            or not all(math.isfinite(v) for v in val[0].values()):
        raise AssertionError("an autoencoder loss is not finite")
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    if not last < first:
        raise AssertionError(f"loss did not fall: first five {first:.4f}, "
                             f"last five {last:.4f}")
    if launches != AUTO_STEPS + AUTO_VAL_BATCHES:
        raise AssertionError(f"expected {AUTO_STEPS + AUTO_VAL_BATCHES} ctc "
                             f"launches, got {launches}")
    print(f"main path autoencoder: mean loss of the first five steps "
          f"{first:.4f}, of the last five {last:.4f}", flush=True)

    # resume: the uninterrupted trainer's step 31 against a fresh trainer
    # that reads checkpoint-latest (step 30) and takes step 31
    want = {k: float(v) for k, v in tr.train_step(*_args(batch)).items()
            if k != "logp"}
    again = AutoTrainer(cfg, device=DEVICE)
    again.init_state(seed=1)                  # the checkpoint decides
    got = []
    again.train([batch], iterations=AUTO_STEPS + 1, on_log=got.append,
                resume=True)
    rel = max(abs(got[-1][k] - v) / abs(v) for k, v in want.items())
    same = all(got[-1][k] == v for k, v in want.items())
    ok = again.step == AUTO_STEPS + 1 and rel <= RESUME_RTOL
    print(f"resume from checkpoint-latest: step {again.step}, next step "
          f"{got[-1]['loss']:.6f} vs uninterrupted {want['loss']:.6f} "
          f"(max rel diff {rel:.2e}, bound {RESUME_RTOL}; bit-equal {same}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("the resumed trainer's step differs")
    del again
    return launches, tr, batch


def check_auto_grads(torch, ctc, ta, batch, dtype="float32"):
    """One step's loss and gradients through the kernel and through the
    plain CTC, from the same weights, batch and dropout masks, the model
    in ``dtype`` (bf16 with deterministic algorithms, as
    ``check_train_grads``)."""
    tr = ta.trainer(DEVICE, dtype=dtype)
    params = list(tr.model.parameters())
    with _deterministic(torch, dtype != "float32"):
        loss_k, aux = tr.loss(*_args(batch))
        logp = aux["logp"]
        g_k = torch.autograd.grad(loss_k, [logp] + params, retain_graph=True)
        B, T, _ = logp.shape
        loss_p = tr.w_auto * aux["autoLoss"] + tr.w_recog * ctc.ctc_loss(
            logp, batch["label"], torch.full((B,), T, device=DEVICE),
            batch["label_lengths"])
        g_p = torch.autograd.grad(loss_p, [logp] + params)
    _grads_agree(loss_k, loss_p, g_k, g_p, dtype,
                 f"autoencoder step (T={T})")


def auto_phase(torch, tt, F, ctc, ta, load_config, card, run_dir):
    """Phase 10, its checkpoints in ``run_dir``.  Returns (CTC launches,
    max CTC error, the CTC times at the main bucket)."""
    launches, tr, batch = auto_main_path(torch, ctc, ta, load_config,
                                         run_dir)
    check_auto_grads(torch, ctc, ta, batch)
    err = max(check_ctc(torch, ctc, T, L, seed=T + L, batch=ta.B)
              for T, L in AUTO_CTC_BUCKETS)
    ta.report(tr, _args(batch), card)
    T, L = AUTO_CTC_BUCKETS[AUTO_CTC_MAIN]
    times = time_ctc(torch, tt, F, ctc, T, L, card, batch=ta.B)
    del tr
    torch.cuda.empty_cache()
    return launches, err, times


def _gan_snapshot(tr):
    """What a lesson reads and changes, apart from the optimizers."""
    s = tr.state
    return ({k: v.clone() for k, v in tr.model.state_dict().items()},
            [g.clone() for g in s.saved_recog + s.saved_adv],
            s.style_bank.clone(), s.bank_count, s.have_saved,
            s.generator.get_state(), tr.text.rng.bit_generator.state)


def _gan_restore(tr, snap):
    s = tr.state
    model, saved, bank, count, have, gen, text = snap
    tr.model.load_state_dict(model)
    for g, v in zip(s.saved_recog + s.saved_adv, saved):
        g.copy_(v)
    s.style_bank.copy_(bank)
    s.bank_count, s.have_saved = count, have
    s.generator.set_state(gen)
    tr.text.rng.bit_generator.state = text


def check_gan_grads(torch, ctc, tr, batch, bf16=False):
    """A gen lesson's saved groups and an auto lesson's groups and merged
    update, each lesson run twice from the same state and draws, with
    deterministic cuDNN algorithms (so that the CTC is all that differs):
    through the kernel, then through the plain CTC: the gradient the CTC
    hands the log-probs within ``TRAIN_GRAD_RTOL`` of its max, and each
    group's tensors within ``GAN_GRAD_RTOL`` of their max (in bf16, each
    group within ``BF16_GAN_GRAD_L2`` in relative L2).  Returns the worst
    relative difference held."""
    from handwriting_line_generation_tpu_torch.training import \
        gan_trainer as gt_mod
    kernel_ctc = gt_mod.ctc_loss_fast
    caught = []

    def plain_ctc(logp, label, lens):
        B, T, _ = logp.shape
        return ctc.ctc_loss(logp, label, torch.full((B,), T,
                                                    device=logp.device), lens)

    def catching(route):
        def fn(logp, *a):
            logp.register_hook(caught.append)
            return route(logp, *a)
        return fn

    def gen_lesson():
        tb = tr.text.get_batch(label_len=max(tr.cfg.data.label_buckets))
        return tr.step_gen_nostep(tb["label"], tb["label_lengths"],
                                  tr.gen_spaced_len)

    def auto_lesson():
        return tr.step_auto(batch["image"], batch["label"],
                            batch["label_lengths"], batch["fg_mask"],
                            batch["width"], batch["a_batch_size"])
    worst = 0.0
    for name, lesson, keys in (
            ("gen", gen_lesson, ("recog_g", "adv_g")),
            ("auto", auto_lesson, ("main_g", "adv_g", "recog_g",
                                   "merged"))):
        snap = _gan_snapshot(tr)
        outs, caught[:] = [], []
        for route in (kernel_ctc, plain_ctc):
            _gan_restore(tr, snap)
            gt_mod.ctc_loss_fast = catching(route)
            try:
                with _deterministic(torch):
                    outs.append(lesson())
            finally:
                gt_mod.ctc_loss_fast = kernel_ctc
        _gan_restore(tr, snap)
        d_logp = _rel_max(*caught)
        print(f"{name} lesson, kernel vs plain CTC: the log-probs' gradient "
              f"max abs diff / max abs {d_logp:.2e} (bound "
              f"{TRAIN_GRAD_RTOL})", flush=True)
        if len(caught) != 2 or not d_logp <= TRAIN_GRAD_RTOL:
            raise AssertionError(f"{name} lesson: the CTC kernel's gradient "
                                 f"disagrees with the plain CTC's")
        for k in keys:
            err = max(_rel_max(a, b) for a, b in zip(outs[0][k], outs[1][k])
                      if b.abs().max() > 0)
            l2 = _rel_l2(outs[0][k], outs[1][k])
            worst = max(worst, l2 if bf16 else err)
            print(f"{name} lesson, kernel vs plain CTC: {k} worst tensor "
                  f"max abs diff / max abs {err:.2e}"
                  + (f", relative L2 {l2:.2e} (bound "
                     f"{BF16_GAN_GRAD_L2:.3g})" if bf16
                     else f" (bound {GAN_GRAD_RTOL})"), flush=True)
    if not worst <= (BF16_GAN_GRAD_L2 if bf16 else GAN_GRAD_RTOL):
        raise AssertionError("a GAN lesson's gradients through the kernel "
                             "disagree with the plain CTC")
    return worst


def gan_main_path(torch, ctc, tg, hwr_ckpt, auto_ckpt, dtype="float32"):
    """Two 7-lesson cycles of the paper GAN with its pretrained recognizer
    and perceptual encoder loaded from the port's own checkpoints, the
    model in ``dtype``.  Returns (CTC launches, trainer, batches)."""
    from handwriting_line_generation_tpu_torch.utils.checkpoint import (
        extract_subtree,
    )
    tr = tg.trainer(DEVICE, seed=0, pretrained_hwr=hwr_ckpt,
                    encoder_weights=auto_ckpt, dtype=dtype)
    c = tr.cfg
    print(f"GAN config {tg.CONFIG.name} ({c.model.compute_dtype}): hwr "
          f"{c.model.hwr.kind}, style "
          f"{c.model.style.style_dim}, generator {c.model.generator.dim}, "
          f"discriminator {c.model.discriminator.dim}, encoder "
          f"{c.trainer.encoder_type}, augmentation {c.data.augmentation}, "
          f"loss weights {c.trainer.loss_weights}; B={tg.B}, 64x{tg.tt.W}; "
          f"gen_spaced_len {tr.gen_spaced_len}", flush=True)
    load = lambda p: torch.load(p + ".pt", map_location="cpu",
                                weights_only=True)["model"]
    for what, got, want in (
            ("recognizer", tr.model.hwr.state_dict(), load(hwr_ckpt)),
            ("perceptual encoder", tr.encoder.state_dict(),
             extract_subtree(load(auto_ckpt), "encoder"))):
        same = set(got) == set(want) and all(
            torch.equal(got[k].cpu(), want[k]) for k in want)
        print(f"{what} loaded from its checkpoint: {len(want)} tensors, "
              f"equal {same}", flush=True)
        if not same:
            raise AssertionError(f"the {what} differs from its checkpoint")
    s = tr.state
    frozen = [p.detach().clone() for p, l in zip(s.params, s.labels)
              if l == "frozen"]
    enc = [p.detach().clone() for p in tr.encoder.parameters()]
    disc = [p for p, l in zip(s.params, s.labels) if l == "disc"]
    sn = [m for m in tr.model.discriminator.sn]
    u0 = [m.u.clone() for m in sn]
    batches = itertools.cycle([tg.batch(DEVICE, seed) for seed in range(3)])
    ctc.ctc_loss_cuda.launches = 0
    n = len(tr.curriculum.stages[0][1])
    banks, moves = [], []
    for i in range(GAN_CYCLES * n):
        lesson = tr.curriculum.get_lesson(i)
        before = [p.detach().clone() for p in disc]
        out = tr.run_lesson(lesson, batches, iteration=i)
        vals = {k: float(v) for k, v in out.items()
                if k.endswith("Loss") or k.startswith("gnorm")}
        moved = any(not torch.equal(a, p) for a, p in zip(before, disc))
        moves.append(("disc" in lesson) == moved)
        banks.append(s.bank_count)
        print(f"lesson {i} {'+'.join(lesson)}: "
              + " ".join(f"{k} {v:.5g}" for k, v in vals.items())
              + f"; bank {s.bank_count}; discriminator moved {moved}",
              flush=True)
        if not all(math.isfinite(v) for v in vals.values()):
            raise AssertionError(f"lesson {i}: a loss is not finite")
    launches = ctc.ctc_loss_cuda.launches
    u_moved = all(not torch.equal(a, m.u) for a, m in zip(u0, sn)
                  if m.u.numel() > 1)
    u_norm = max(abs(m.u.norm().item() - 1.0) for m in sn)
    frozen_same = all(torch.equal(a, p) for a, p in zip(
        frozen, [p for p, l in zip(s.params, s.labels) if l == "frozen"]))
    enc_same = all(torch.equal(a, p)
                   for a, p in zip(enc, tr.encoder.parameters()))
    want_launches = 4 * GAN_CYCLES
    print(f"GAN, {GAN_CYCLES} cycles: bank counts {banks}; every u moved "
          f"{u_moved}, max |norm - 1| {u_norm:.2e}; recognizer and encoder "
          f"unchanged {frozen_same} {enc_same}; discriminator moved in its "
          f"lessons only {all(moves)}; ctc launches {launches} (want "
          f"{want_launches})", flush=True)
    if not (banks[-1] > banks[0] and banks == sorted(banks)):
        raise AssertionError("the style bank did not grow")
    if not (u_moved and u_norm <= 1e-5):
        raise AssertionError("a spectral-norm u did not move or lost its "
                             "unit norm")
    if not (frozen_same and enc_same):
        raise AssertionError("the frozen recognizer or encoder changed")
    if not all(moves):
        raise AssertionError("the discriminator moved outside its lessons "
                             "(or not in them)")
    if launches != want_launches:
        raise AssertionError(f"expected {want_launches} ctc launches, got "
                             f"{launches}")
    return launches, tr, batches


def gan_phase(torch, tt, F, ctc, card, hwr_ckpt, auto_ckpt):
    """Phase 11.  Returns (CTC launches, max CTC error, the CTC times at
    the main bucket)."""
    from handwriting_line_generation_tpu_torch import trace_gan as tg
    launches, tr, batches = gan_main_path(torch, ctc, tg, hwr_ckpt,
                                          auto_ckpt)
    check_gan_grads(torch, ctc, tr, next(batches))
    err = max(check_ctc(torch, ctc, T, L, seed=T + L, batch=tg.B)
              for T, L in GAN_CTC_BUCKETS)
    tg.report(tr, batches, card)
    T, L = GAN_CTC_BUCKETS[0]
    times = time_ctc(torch, tt, F, ctc, T, L, card, batch=tg.B)
    del tr
    torch.cuda.empty_cache()
    return launches, err, times


def _copy_run_at(batches, pull, src, dst):
    """``batches``, copying the run directory ``src`` to ``dst`` when the
    ``pull``-th batch is asked for: the run as it stood after the lesson
    before the one pulling it (its checkpoints, log and samples)."""
    import shutil
    for n, b in enumerate(batches):
        if n == pull:
            shutil.copytree(src, dst)
        yield b


def _recording(tr):
    """Keep each lesson's outputs (device tensors, read after the run)."""
    outs, run = [], tr.run_lesson

    def recorded(*a, **k):
        outs.append(run(*a, **k))
        return outs[-1]
    tr.run_lesson = recorded
    return outs


def _flat_state(x, prefix=""):
    if isinstance(x, dict):
        return [kv for k, v in x.items() for kv in _flat_state(v, f"{prefix}/{k}")]
    if isinstance(x, (list, tuple)):
        return [kv for k, v in enumerate(x)
                for kv in _flat_state(v, f"{prefix}/{k}")]
    return [(prefix, x)]


def _same_state(torch, a, b):
    """Names of the entries where two GAN state_dicts differ (tensors bit
    for bit, numbers and the samplers' states by value)."""
    fa, fb = _flat_state(a), _flat_state(b)
    if [k for k, _ in fa] != [k for k, _ in fb]:
        return ["(structure)"]
    return [k for (k, x), (_, y) in zip(fa, fb)
            if not (torch.equal(x.cpu(), y.cpu()) if isinstance(x, torch.Tensor)
                    else x == y)]


def gan_train_main_path(torch, ctc, tg, hwr_ckpt, auto_ckpt, run_dir):
    """``GanTrainer.train`` on the paper GAN for ``GAN_TRAIN_ITERS``
    lessons with validation, SWA, sample strips and checkpoints in
    ``run_dir``/a; the run directory as it stood after lesson 7 is copied
    to ``run_dir``/b and a fresh trainer resumes it to the end.  Returns
    (CTC launches, the first trainer, batches, validation batches)."""
    from handwriting_line_generation_tpu_torch.utils import checkpoint as ck
    from handwriting_line_generation_tpu_torch.utils.png import read_png_gray

    def trainer(save_dir):
        tr = tg.trainer(DEVICE, seed=0, pretrained_hwr=hwr_ckpt,
                        encoder_weights=auto_ckpt)
        t = tr.cfg.trainer
        t.save_dir, t.log_step, t.val_step = save_dir, GAN_TRAIN_STEP, \
            GAN_TRAIN_STEP
        t.print_every, t.swa, t.swa_start, t.swa_c_iters = \
            GAN_TRAIN_STEP, True, GAN_TRAIN_STEP, 1
        t.save_step_minor, t.save_step = GAN_TRAIN_STEP, GAN_TRAIN_ITERS
        return tr
    images = [tg.batch(DEVICE, seed) for seed in range(3)]
    valid = [tg.batch(DEVICE, seed) for seed in (10, 11)]
    tr = trainer(str(pathlib.Path(run_dir, "a")))
    name, K = tr.cfg.name, GAN_TRAIN_STEP
    run_a, run_b = (pathlib.Path(run_dir, d, name) for d in "ab")
    # the image lessons among 1-7 (count, auto, disc, auto, disc) pull 5
    # batches: the 6th is lesson 8's
    pulls = sum(1 for i in range(K) if not all(
        l[:3] == "gen" or l == "no-step" for l in tr.curriculum.get_lesson(i)))
    outs_a = _recording(tr)
    entries = []
    ctc.ctc_loss_cuda.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr.train(_copy_run_at(itertools.cycle(images), pulls, str(run_a),
                          str(run_b)),
             iterations=GAN_TRAIN_ITERS, valid=valid,
             val_batches=GAN_TRAIN_VAL_BATCHES, on_log=entries.append)
    wall = time.perf_counter() - t0
    launches = ctc.ctc_loss_cuda.launches
    peak = torch.cuda.max_memory_allocated()
    logs = [e for e in entries if "CER" in e]
    vals = [e for e in entries if "val_gen_CER" in e]
    print(f"GAN training run ({GAN_TRAIN_ITERS} lessons, validation over "
          f"{GAN_TRAIN_VAL_BATCHES} batches, SWA, strips and checkpoints "
          f"every {K}): {wall:.1f} s; ctc launches {launches} (want "
          f"{4 * GAN_TRAIN_ITERS // 7}); peak memory "
          f"{peak / 2 ** 30:.2f} GiB", flush=True)
    for e in logs + vals:
        print("  " + ", ".join(f"{k} {v:.5g}" if isinstance(v, float)
                              else f"{k} {v}" for k, v in e.items()),
              flush=True)
    keys = ["val_autoLoss", "val_perceptualLoss", "val_countLoss", "val_CER",
            "val_WER", "val_recon_CER", "val_gen_CER"]
    if [e["iteration"] for e in logs] != [K, 2 * K] or not all(
            math.isfinite(v) for e in logs for v in e.values()):
        raise AssertionError("log entries missing or not finite")
    if len(vals) != 2 or not all(
            math.isfinite(vals[i][k]) for i in range(2) for k in keys) \
            or not all(math.isfinite(vals[1]["swa_" + k]) for k in keys):
        raise AssertionError("a validation or SWA-validation value is "
                             "missing or not finite")
    best = ck.load_meta(str(run_b), "model_best")
    latest = ck.load_meta(str(run_a), "checkpoint-latest-swa")
    ok = (best["iteration"] == K and best["monitor_value"]
          == vals[0]["val_gen_CER"] and latest["swa_n"] == K + 1
          and ck.checkpoint_exists(str(run_a), "checkpoint-latest")
          and ck.checkpoint_exists(str(run_a),
                                   f"checkpoint-iteration{2 * K}-swa"))
    print(f"model_best at the first validation: iteration "
          f"{best['iteration']}, monitor_value {best['monitor_value']:.5g} "
          f"(val_gen_CER {vals[0]['val_gen_CER']:.5g}); "
          f"checkpoint-latest-swa swa_n {latest['swa_n']} (want {K + 1}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("the GAN run's checkpoints are not as expected")
    # a gen strip: per line 64 rows and a 6-row rule of 60; a recon strip:
    # the original, a 2-row rule of 128, the reconstruction, the 6-row rule
    B, H, T = tg.B, 64, tr.gen_spaced_len
    for it in (K, 2 * K):
        for kind, shape, rules in (
                ("gen", (B * (H + 6), 4 * T), [(H, H + 6, 60)]),
                ("recon", (B * (2 * H + 8), tg.tt.W),
                 [(H, H + 2, 128), (2 * H + 2, 2 * H + 8, 60)])):
            px = read_png_gray(str(run_a / "samples" /
                                   f"iter{it}_{kind}.png"))
            if px.shape != shape or not all((px[a:b] == v).all()
                                            for a, b, v in rules):
                raise AssertionError(f"strip iter{it}_{kind}: {px.shape}, "
                                     f"want {shape} and its rules")
    scores = (run_a / "samples" / "disc_scores.txt").read_text().splitlines()
    print(f"sample strips decode to {B * (H + 6)}x{4 * T} (gen) and "
          f"{B * (2 * H + 8)}x{tg.tt.W} (recon); disc_scores.txt: {scores}",
          flush=True)
    if len(scores) != 2:
        raise AssertionError("disc_scores.txt needs a line a dump")
    if launches != 4 * GAN_TRAIN_ITERS // 7:
        raise AssertionError(f"expected {4 * GAN_TRAIN_ITERS // 7} ctc "
                             f"launches, got {launches}")

    # resume: a fresh trainer reads the run as it stood after lesson 7
    again = trainer(str(pathlib.Path(run_dir, "b")))
    saved = ck.load_checkpoint(str(run_b), "checkpoint-latest")
    again.load_state_dict(saved)
    again._resume_side(str(run_b))
    swa = ck.load_checkpoint(str(run_b), "checkpoint-latest-swa")
    differ = _same_state(torch, again.state_dict(), saved) + [
        n for n, t in zip(again.state.names, again.swa)
        if not torch.equal(t.cpu(), swa[n])]
    print(f"resumed trainer after loading checkpoint-latest (iteration "
          f"{saved['step']}): {len(_flat_state(saved))} entries and "
          f"{len(swa)} SWA tensors, differing from the saved ones: "
          f"{differ or 'none'}", flush=True)
    if differ or saved["step"] != K:
        raise AssertionError("the loaded state differs from the saved one")
    outs_b = _recording(again)
    again.train(itertools.islice(itertools.cycle(images), pulls, None),
                iterations=GAN_TRAIN_ITERS, valid=valid,
                val_batches=GAN_TRAIN_VAL_BATCHES)
    first = {k: (float(v), float(outs_a[K][k]))
             for k, v in outs_b[0].items() if k.endswith("Loss")}
    rel = max(abs(a - b) / max(abs(b), 1e-30) for a, b in first.values())
    gap = max((p - q).abs().max().item()
              for p, q in zip(tr.state.params, again.state.params))
    scale = max(p.abs().max().item() for p in tr.state.params)
    print(f"resumed lesson {K + 1} vs the uninterrupted run's: "
          + ", ".join(f"{k} {a:.7g} vs {b:.7g}" for k, (a, b) in first.items())
          + f" (max rel {rel:.2e}, bound {RESUME_RTOL}); after lesson "
          f"{2 * K} the parameters differ by at most {gap:.3e} (largest "
          f"|parameter| {scale:.3g}); swa_n {again.swa_n}", flush=True)
    if not (rel <= RESUME_RTOL and again.step == GAN_TRAIN_ITERS
            and again.swa_n == tr.swa_n):
        raise AssertionError("the resumed run's first lesson differs")
    del again
    return launches, tr, images, valid


def time_gan_train(torch, tg, tr, images, valid, card):
    """Lines/s through ``GanTrainer.train`` (7-lesson blocks, no SWA,
    validation, dumps or saves, as the paper config trains between its
    log steps) against ``run_lesson`` cycles, alternated, CUDA events, and
    the loop's own host time a block; then ms per SWA step, per validation
    batch, per checkpoint-latest save (and its bytes) and per sample
    dump."""
    import statistics

    from handwriting_line_generation_tpu_torch.utils.checkpoint import \
        save_checkpoint
    batches = itertools.cycle(images)
    t = tr.cfg.trainer
    # the paper config's loop: no SWA (its step is timed on its own below),
    # no validation, dumps or saves inside the blocks
    t.swa = False
    t.val_step = t.print_every = t.save_step = t.save_step_minor = 0
    work = tempfile.mkdtemp(dir=t.save_dir)
    t.save_dir = work
    host, lesson = [], []
    run_lesson = tr.run_lesson

    def timed(*a, **k):
        t0 = time.perf_counter()
        out = run_lesson(*a, **k)
        lesson.append(time.perf_counter() - t0)
        return out
    tr.run_lesson = timed

    def events(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        end.synchronize()
        host.append(time.perf_counter() - t0)
        return start.elapsed_time(end)
    n = len(tr.curriculum.stages[0][1])
    run = {"run_lesson": lambda: tg.cycle(tr, batches),
           "train": lambda: tr.train(batches, iterations=tr.step + n,
                                     log_every=10 ** 9)}
    blocks = {k: [] for k in run}
    own = []            # a train block's host wall less its lessons' own
    for fn in run.values():                               # warm-ups
        fn()
    # alternated, each pair in the other order than the last (ABBA)
    for b in range(GAN_TIMING_BLOCKS):
        for k in (("run_lesson", "train") if b % 2 == 0
                  else ("train", "run_lesson")):
            del lesson[:]
            blocks[k].append(events(run[k]))
            if k == "train":
                own.append((host[-1] - sum(lesson)) * 1e3)
    tr.run_lesson = run_lesson
    rate = {k: tg.B * n * 1e3 / statistics.median(v)
            for k, v in blocks.items()}
    for k, v in blocks.items():
        print(f"GAN {k} blocks of {n} lessons (TF32 off): "
              + " ".join(f"{x:.3f}" for x in v) + f" ms; median "
              f"{statistics.median(v):.3f} ms, {rate[k]:.2f} GAN-trained "
              f"lines/s {card}", flush=True)
    ratio = rate["train"] / rate["run_lesson"]
    swa_ms = statistics.median(events(tr._swa_step) for _ in range(10))
    print(f"GanTrainer.train / run_lesson lines/s: {ratio:.4f}; the loop's "
          f"own host time a {n}-lesson block (its wall less its lessons'): "
          f"median {statistics.median(own):.3f} ms; SWA step "
          f"{swa_ms:.3f} ms {card}", flush=True)
    val_ms = statistics.median(events(lambda: tr.validate(
        iter(valid), GAN_TRAIN_VAL_BATCHES)) for _ in range(3))
    lines = tg.B * GAN_TRAIN_VAL_BATCHES
    path = pathlib.Path(work, "checkpoint-latest.pt")
    save_ms = statistics.median(events(lambda: save_checkpoint(
        work, "checkpoint-latest", tr.state_dict(), {"name": "timing"}))
        for _ in range(3))
    dump_ms = statistics.median(events(lambda: tr._dump_samples(
        tr.step, valid, work)) for _ in range(3))
    print(f"validation: {val_ms / GAN_TRAIN_VAL_BATCHES:.3f} ms a batch of "
          f"{tg.B} lines, {lines * 1e3 / val_ms:.2f} validated lines/s; "
          f"checkpoint-latest save {save_ms:.3f} ms, "
          f"{path.stat().st_size} bytes; sample dump {dump_ms:.3f} ms "
          f"{card}", flush=True)
    return rate


def gan_train_phase(torch, ctc, card, hwr_ckpt, auto_ckpt, run_dir):
    """Phase 12.  Returns the CTC launches of the training run."""
    from handwriting_line_generation_tpu_torch import trace_gan as tg
    launches, tr, images, valid = gan_train_main_path(
        torch, ctc, tg, hwr_ckpt, auto_ckpt, run_dir)
    time_gan_train(torch, tg, tr, images, valid, card)
    del tr
    torch.cuda.empty_cache()
    return launches


CLI_FIXTURE = REPO / "tests" / "fixtures" / "mini_iam"
CLI_BATCH = 4                      # the fixture's 8 training lines: 2 a batch
CLI_LOG = 10                       # log_step of the HWR and autoencoder runs
CLI_HWR_STEPS, CLI_HWR_RESUME_TO = 30, 40
CLI_AUTO_STEPS, CLI_GAN_LESSONS, CLI_SYN_STEPS = 20, 14, 10
CLI_RENDERS = 24                   # render_line_hard lines timed
CLI_PNG_READS = 5                  # decodes of each fixture page timed
CLI_TIMED_BATCHES = {"iam_lines": 8, "iam_author": 8, "syn_hwr3": 3}
CLI_TIMED_STEPS = 100              # steps of each timed arm, after warm-up
CLI_TIMING_BLOCKS = 5              # alternated blocks of the iam_hwr arms
CLI_SYN_DISTINCT = 4               # pre-rendered syn_hwr3 batches, cycled
CLI_IDLE_STEPS = {"iam_hwr": (CLI_LOG, CLI_LOG + CLI_TIMED_STEPS),
                  "syn_hwr3": (2, CLI_SYN_STEPS)}


def _config(name, overrides):
    from handwriting_line_generation_tpu_torch.config import (
        apply_overrides, load_config,
    )
    return apply_overrides(load_config(str(REPO / "configs" / name)),
                           overrides)


def _pairs(overrides):
    return [a for ov in overrides for a in ("-a", ov)]


def _cli_run(torch, ctc, cli, name, root, overrides, *flags, prof=False):
    """``train.main`` on the card; returns (CTC launches, seconds, device
    busy seconds or None)."""
    from torch.profiler import ProfilerActivity, profile
    from handwriting_line_generation_tpu_torch.trace_forward import \
        _device_us
    argv = ["-c", str(REPO / "configs" / name), "--device", DEVICE,
            *_pairs([f"trainer.save_dir={root}", *overrides]), *flags]
    print("train " + " ".join(argv[2:]), flush=True)
    ctc.ctc_loss_cuda.launches = 0
    busy = None
    if prof:                            # device activity only: no op records
        with profile(activities=[ProfilerActivity.CUDA]) as p:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rc = cli.main(argv)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        busy = sum(_device_us(e) for e in p.key_averages() if
                   e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
        if not busy > 0:
            raise AssertionError(f"the profiler saw no device time in "
                                 f"train -c {name}")
    else:
        t0 = time.perf_counter()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"train -c {name} exited {rc}")
    launches = ctc.ctc_loss_cuda.launches
    torch.cuda.empty_cache()
    return launches, secs, busy


def _split_log(run_dir):
    log = json.loads((run_dir / "train_log.json").read_text())
    steps = [e for e in log if not any(k.startswith("val_") for k in e)]
    vals = [e for e in log if any(k.startswith("val_") for k in e)]
    return steps, vals


def _val_batches(cfg, trainer_cls, shard=(1, 0)):
    """The batches one validation of ``cfg`` reads (on rank ``shard[1]`` of
    ``shard[0]``): the CTC kernel's launches in it for the HWR and
    autoencoder trainers."""
    from handwriting_line_generation_tpu_torch.data import datasets as D
    from handwriting_line_generation_tpu_torch.training.loop import \
        validation_batches
    return sum(1 for _ in itertools.islice(
        validation_batches(D.make_batcher(cfg.data, "valid", shard)),
        trainer_cls.VAL_BATCHES))


def _finite(entries, what):
    bad = [e for e in entries for v in e.values()
           if isinstance(v, float) and not math.isfinite(v)]
    if bad or not entries:
        raise AssertionError(f"{what}: missing or not finite: {bad}")


def cli_data_rates(card):
    """Host rates of the record sources: ``render_line_hard`` renders a
    second, ms a fixture page of ``read_png_gray`` by each unfilter pass,
    and ms per batch of ``make_batcher`` (pages decoded and lines rendered
    from cold)."""
    from handwriting_line_generation_tpu_torch.charset import IAM_CHARSET
    from handwriting_line_generation_tpu_torch.data import datasets as D
    from handwriting_line_generation_tpu_torch.data.synthetic import \
        SyntheticCorpus
    from handwriting_line_generation_tpu_torch.utils import png
    corpus = SyntheticCorpus(CLI_RENDERS, 1, IAM_CHARSET, 64, seed=11,
                             version=3)
    t0 = time.perf_counter()
    for i in range(CLI_RENDERS):
        corpus.get(i)
    dt = time.perf_counter() - t0
    print(f"render_line_hard (v3, one host thread): {CLI_RENDERS / dt:.2f} "
          f"renders/s ({dt / CLI_RENDERS * 1e3:.1f} ms a line) {card}",
          flush=True)
    # the fixture's pages (every row Sub) by the row pass, and by the
    # wavefront pass that pages with Average or Paeth rows take
    for path in sorted((CLI_FIXTURE / "forms").glob("*.png")):
        ms, pages = [], []
        for unfilter in (png._unfilter_rows, png._unfilter_wavefront):
            with mock.patch.object(png, "_unfilter_rows", unfilter):
                t0 = time.perf_counter()
                for _ in range(CLI_PNG_READS):
                    page = png.read_png_gray(str(path))
                ms.append((time.perf_counter() - t0) / CLI_PNG_READS * 1e3)
            pages.append(page)
        if not (pages[0] == pages[1]).all():
            raise AssertionError(f"{path.name}: the two passes disagree")
        print(f"read_png_gray {path.name} {pages[0].shape}: {ms[0]:.2f} ms "
              f"(row pass), {ms[1]:.2f} ms (wavefront pass) {card}",
              flush=True)
    fixture = [f"data.data_dir={CLI_FIXTURE}"]
    rates = {}
    for label, name, overrides in (
            ("iam_lines", "iam_hwr.json",
             fixture + [f"data.batch_size={CLI_BATCH}"]),
            ("iam_author", "iam_gan_paper.json", fixture),
            ("syn_hwr3", "syn_hwr3.json", [])):
        cfg = _config(name, overrides)
        D._imread_gray.cache_clear()
        it = D.forever(D.make_batcher(cfg.data, "train"),
                       seed=cfg.trainer.seed)
        n = CLI_TIMED_BATCHES[label]
        t0 = time.perf_counter()
        batches = [next(it) for _ in range(n)]
        ms = (time.perf_counter() - t0) / n * 1e3
        b = batches[0]
        fg = " with fg masks" if "fg_mask" in b else ""
        print(f"make_batcher {label}: {ms:.2f} ms per batch of "
              f"{len(b['gt'])} lines{fg}, image {b['image'].shape} "
              f"(from cold, {n} batches) {card}", flush=True)
        rates[label] = ms
    return rates


def _host_batches(cfg, n):
    """The first ``n`` batches of the CLI's training iterator over ``cfg``,
    as ``make_batcher`` gives them (float images)."""
    from handwriting_line_generation_tpu_torch.data import datasets as D
    it = D.forever(D.make_batcher(cfg.data, "train"), seed=cfg.trainer.seed)
    return [next(it) for _ in range(n)]


def _step_rate(torch, tr, batches, on_card):
    """Trained lines/s of ``train_step`` alone: ``CLI_TIMED_STEPS`` over
    ``batches`` (cycled) after 2 warm-ups, host clock, synchronized; the
    images as the loop hands them (u8), on the card or as host arrays."""
    from handwriting_line_generation_tpu_torch.ops.augment import \
        quantize_image_u8
    data = [[quantize_image_u8(b["image"]), b["label"], b["label_lengths"],
             b["width"]] for b in batches]
    if on_card:
        data = [[torch.as_tensor(a).to(DEVICE) for a in d] for d in data]
    for d in data[:2]:
        tr.train_step(*d)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(CLI_TIMED_STEPS):
        tr.train_step(*data[i % len(data)])
    torch.cuda.synchronize()
    return (len(batches[0]["gt"]) * CLI_TIMED_STEPS
            / (time.perf_counter() - t0))


def _window_rate(entries, B):
    """Lines/s over the log windows after the first (warm-up) one: B / the
    mean ``sec_per_iter``; each window ends at a log step's decode, which
    waits for the card."""
    spi = [e["sec_per_iter"] for e in entries[1:]]
    return B * len(spi) / sum(spi)


def _spread(rates):
    return (f"median {statistics.median(rates):.1f} (min {min(rates):.1f}, "
            f"max {max(rates):.1f}; " + ", ".join(f"{r:.1f}" for r in rates)
            + ")")


def _loop_idle(torch, ctc, cli, name, root, overrides, steps, card):
    """The CLI loop's idle share with start-up cancelled: two profiled runs
    of ``steps`` = (short, long) iterations; 1 - (busy difference) / (wall
    difference).  Returns the share; prints it beside the profiled lines/s
    of the difference (the profiler's cost, against the unprofiled rate)."""
    walls, busys = [], []
    for n in steps:
        _, secs, busy = _cli_run(
            torch, ctc, cli, name, root / f"idle{n}", overrides, "-i", str(n),
            prof=True)
        walls.append(secs)
        busys.append(busy)
    wall, busy = walls[1] - walls[0], busys[1] - busys[0]
    B = _config(name, overrides).data.batch_size
    rate = B * (steps[1] - steps[0]) / wall
    print(f"{name[:-len('.json')]} loop, profiled runs of {steps[0]} and "
          f"{steps[1]} iterations: {walls[0]:.3f}, {walls[1]:.3f} s wall, "
          f"device busy "
          f"{busys[0]:.3f}, {busys[1]:.3f} s; the {steps[1] - steps[0]} "
          f"steps between: {wall:.3f} s, busy {busy:.3f} s, idle share "
          f"{1 - busy / wall:.3f} (whole calls {1 - busys[0] / walls[0]:.3f},"
          f" {1 - busys[1] / walls[1]:.3f}), {rate:.1f} lines/s under the "
          f"profiler {card}", flush=True)
    return 1 - busy / wall


def hwr_cli_timing(torch, ctc, cli, root, overrides, card):
    """``iam_hwr`` at B = 4: trained lines/s of five arms in
    ``CLI_TIMING_BLOCKS`` blocks of ``CLI_TIMED_STEPS`` steps each,
    alternated (ABCDE, EDCBA, ...): the CLI (log windows after a warm-up
    one; the record sources assemble its batches on the prefetch thread),
    ``HWRTrainer.train`` over the same iterator's batches assembled first,
    handed through a ``Prefetcher`` (the thread without the assembly) and
    directly (the loop alone), and ``train_step`` alone on them as host
    u8 arrays and on the card."""
    from handwriting_line_generation_tpu_torch.data.datasets import \
        Prefetcher
    from handwriting_line_generation_tpu_torch.training.hwr_trainer import \
        HWRTrainer
    n = CLI_LOG + CLI_TIMED_STEPS
    timed = overrides + [f"trainer.log_step={CLI_LOG}", "trainer.val_step=0"]
    cfg = _config("iam_hwr.json", timed)
    B = cfg.data.batch_size
    batches = _host_batches(cfg, n)
    step_tr = HWRTrainer(cfg, device=DEVICE)
    step_tr.init_state(seed=0)

    def cli_arm(k):
        _cli_run(torch, ctc, cli, "iam_hwr.json", root / f"timing{k}",
                 timed, "-i", str(n))
        steps, _ = _split_log(root / f"timing{k}" / "iam_hwr")
        return _window_rate(steps, B)

    def loop_arm(k, thread):
        c = _config("iam_hwr.json", timed + [
            f"trainer.save_dir={root / f'loop{k}{thread}'}"])
        tr = HWRTrainer(c, device=DEVICE)
        it = Prefetcher(iter(batches)) if thread else iter(batches)
        log = tr.train(it, iterations=n, resume=False)
        torch.cuda.synchronize()
        if thread:
            it.close()
        del tr
        return _window_rate(log.entries, B)

    arms = {"CLI": cli_arm,
            "train loop through a Prefetcher": lambda k: loop_arm(k, True),
            "train loop": lambda k: loop_arm(k, False),
            "train_step on host u8": lambda k: _step_rate(
                torch, step_tr, batches, False),
            "train_step on the card": lambda k: _step_rate(
                torch, step_tr, batches, True)}
    rates = {a: [] for a in arms}
    order = list(arms)
    for k in range(CLI_TIMING_BLOCKS):
        for a in (order if k % 2 == 0 else order[::-1]):
            rates[a].append(arms[a](k))
    del step_tr
    torch.cuda.empty_cache()
    for a, r in rates.items():
        print(f"iam_hwr B={B} {a}: trained lines/s over {CLI_TIMED_STEPS} "
              f"steps a block, {CLI_TIMING_BLOCKS} alternated blocks: "
              f"{_spread(r)} {card}", flush=True)
    return rates


def cli_phase(torch, tt, F, ctc, card, root):
    """Phase 14.  Returns the kernels-line rows of the CLI's CTC paths."""
    from handwriting_line_generation_tpu_torch import train as cli
    from handwriting_line_generation_tpu_torch.data import datasets as D
    from handwriting_line_generation_tpu_torch.training.auto_trainer import \
        AutoTrainer
    from handwriting_line_generation_tpu_torch.training.hwr_trainer import \
        HWRTrainer
    from handwriting_line_generation_tpu_torch.utils.checkpoint import \
        load_meta
    root = pathlib.Path(root)
    cli_data_rates(card)
    fixture = [f"data.data_dir={CLI_FIXTURE}"]
    small = fixture + [f"data.batch_size={CLI_BATCH}"]
    launches = {}

    # iam_hwr: 30 steps and a validation, then -r to 40
    hwr = small + [f"trainer.log_step={CLI_LOG}",
                   f"trainer.val_step={CLI_HWR_STEPS}"]
    n, secs, _ = _cli_run(torch, ctc, cli, "iam_hwr.json", root,
                          hwr + [f"trainer.save_step_minor={CLI_HWR_STEPS}"],
                          "-i", str(CLI_HWR_STEPS))
    steps, vals = _split_log(root / "iam_hwr")
    _finite(steps + vals, "iam_hwr log")
    losses = [e["loss"] for e in steps]
    print(f"CLI iam_hwr: {secs:.1f} s, losses "
          + " ".join(f"{v:.4f}" for v in losses)
          + f"; validation {vals}; ctc launches {n}", flush=True)
    expect = CLI_HWR_STEPS + _val_batches(_config("iam_hwr.json", small),
                                          HWRTrainer)
    if not (losses[-1] < losses[0] and len(vals) == 1) or n != expect:
        raise AssertionError(f"iam_hwr through the CLI: loss not falling, "
                             f"no validation, or {n} CTC launches where "
                             f"{expect} were due (a step and a validation "
                             f"batch each)")
    hwr_launches = n
    n, secs, _ = _cli_run(torch, ctc, cli, "iam_hwr.json", root,
                          hwr + [f"trainer.save_step_minor={CLI_LOG}"], "-r",
                          "-i", str(CLI_HWR_RESUME_TO))
    steps, _ = _split_log(root / "iam_hwr")
    meta = load_meta(str(root / "iam_hwr"), "checkpoint-latest")
    its = [e["iteration"] for e in steps]
    print(f"CLI iam_hwr -r -i {CLI_HWR_RESUME_TO}: {secs:.2f} s, log "
          f"iterations {its}, checkpoint-latest at {meta['iteration']}, "
          f"ctc launches {n}", flush=True)
    if its != list(range(CLI_LOG, CLI_HWR_RESUME_TO + 1, CLI_LOG)) \
            or meta["iteration"] != CLI_HWR_RESUME_TO \
            or n != CLI_HWR_RESUME_TO - CLI_HWR_STEPS:
        raise AssertionError("the resumed iam_hwr run did not go on from "
                             f"step {CLI_HWR_STEPS}")
    launches["iam_hwr"] = hwr_launches + n
    hwr_cli_timing(torch, ctc, cli, root, small, card)
    _loop_idle(torch, ctc, cli, "iam_hwr.json", root,
               small + [f"trainer.log_step={CLI_LOG}", "trainer.val_step=0"],
               CLI_IDLE_STEPS["iam_hwr"], card)

    # iam_auto_2tight: 20 steps and a validation
    n, secs, _ = _cli_run(torch, ctc, cli, "iam_auto_2tight.json", root,
                          small + [f"trainer.log_step={CLI_LOG}",
                                   f"trainer.val_step={CLI_AUTO_STEPS}",
                                   f"trainer.save_step_minor="
                                   f"{CLI_AUTO_STEPS}"],
                          "-i", str(CLI_AUTO_STEPS))
    steps, vals = _split_log(root / "iam_auto_2tight")
    _finite(steps + vals, "iam_auto_2tight log")
    print(f"CLI iam_auto_2tight: {secs:.1f} s, log {steps}, validation "
          f"{vals}; ctc launches {n}", flush=True)
    expect = CLI_AUTO_STEPS + _val_batches(
        _config("iam_auto_2tight.json", small), AutoTrainer)
    if n != expect or len(vals) != 1:
        raise AssertionError(f"iam_auto_2tight through the CLI: {n} CTC "
                             f"launches where {expect} were due")
    launches["iam_auto_2tight"] = n

    # iam_gan_paper: 14 lessons on the two checkpoints above
    n, secs, _ = _cli_run(
        torch, ctc, cli, "iam_gan_paper.json", root, fixture + [
            f"model.pretrained_hwr={root}/iam_hwr/checkpoint-latest",
            f"trainer.encoder_weights={root}/iam_auto_2tight/"
            "checkpoint-latest",
            "data.text_data=", "trainer.log_step=7",
            f"trainer.val_step={CLI_GAN_LESSONS}", "trainer.save_step_minor=7"],
        "-i", str(CLI_GAN_LESSONS))
    steps, vals = _split_log(root / "iam_gan_paper")
    _finite(steps + vals, "iam_gan_paper log")
    meta = load_meta(str(root / "iam_gan_paper"), "checkpoint-latest")
    print(f"CLI iam_gan_paper: {secs:.1f} s, log {steps}, validation "
          f"{vals}; checkpoint-latest at {meta['iteration']}; ctc launches "
          f"{n}", flush=True)
    # genRecog and reconRecog twice a 7-lesson cycle, none in validation
    expect = 4 * CLI_GAN_LESSONS // 7
    if n != expect or len(vals) != 1 \
            or meta["iteration"] != CLI_GAN_LESSONS:
        raise AssertionError(f"iam_gan_paper through the CLI: {n} CTC "
                             f"launches where {expect} were due")
    launches["iam_gan_paper"] = n

    # syn_hwr3: 10 steps on the v3 synthetic corpus, rendered on the fly
    syn = [f"trainer.log_step={CLI_SYN_STEPS}",
           f"trainer.save_step_minor={CLI_SYN_STEPS}"]
    n, secs, _ = _cli_run(torch, ctc, cli, "syn_hwr3.json", root, syn,
                          "-i", str(CLI_SYN_STEPS))
    steps, _ = _split_log(root / "syn_hwr3")
    _finite(steps, "syn_hwr3 log")
    meta = load_meta(str(root / "syn_hwr3"), "checkpoint-latest")
    cfg = _config("syn_hwr3.json", [])
    syn_rate = cfg.data.batch_size / steps[-1]["sec_per_iter"]
    tr = HWRTrainer(cfg, device=DEVICE)
    tr.init_state(seed=0)
    pre = _host_batches(cfg, CLI_SYN_DISTINCT)
    alone, alone_host = (_step_rate(torch, tr, pre, True),
                         _step_rate(torch, tr, pre, False))
    del tr
    torch.cuda.empty_cache()
    print(f"CLI syn_hwr3: {secs:.1f} s, log {steps}; checkpoint-latest at "
          f"{meta['iteration']}; ctc launches {n}; {syn_rate:.1f} trained "
          f"lines/s through the CLI (first epoch, lines rendered on the "
          f"fly); train_step alone on {CLI_SYN_DISTINCT} pre-rendered "
          f"batches, {CLI_TIMED_STEPS} steps: {alone:.1f} (on the card), "
          f"{alone_host:.1f} (host u8 arrays) {card}", flush=True)
    if n != CLI_SYN_STEPS or meta["iteration"] != CLI_SYN_STEPS:
        raise AssertionError("syn_hwr3 through the CLI")
    launches["syn_hwr3"] = n
    _loop_idle(torch, ctc, cli, "syn_hwr3.json", root,
               [f"trainer.log_step={CLI_SYN_STEPS}"],
               CLI_IDLE_STEPS["syn_hwr3"], card)

    # the CTC kernel at each stage's shape (its first batch's buckets)
    rows = []
    for name, overrides, frames in (
            ("iam_hwr", small, 4), ("iam_auto_2tight", small, 8),
            ("iam_gan_paper", fixture, 4), ("syn_hwr3", [], 4)):
        cfg = _config(name + ".json", overrides)
        b = next(D.forever(D.make_batcher(cfg.data, "train")))
        B, T, L = len(b["gt"]), b["image"].shape[2] // frames, \
            b["label"].shape[1]
        if name == "iam_gan_paper":        # genRecog, the longest frames
            T, L = cfg.model.max_gen_length, max(cfg.data.label_buckets)
        err = check_ctc(torch, ctc, T, L, seed=T + L, batch=B)
        rows.append((f"CLI {name}", (B, T, L), launches[name], err,
                     time_ctc(torch, tt, F, ctc, T, L, card, batch=B)))
    return rows



# phase 15: inference from a checkpoint.  The CLI chain runs on phase 14's
# iam_gan_paper run directory over the mini-IAM fixture, the epilogue
# kernel switched on (trained configs leave it off)
INFER_OVERRIDES = [f"data.data_dir={CLI_FIXTURE}", "data.text_data=",
                   "model.generator.fused_epilogue=true"]
INFER_COUNT = 4                    # images of each generate mode
INFER_STRETCH = 5                  # stretch_sweep's factors: 5 forwards
INFER_CKPTS = ("checkpoint-latest", "model_best", "checkpoint-latest-swa")
EVAL_FLAGS = ("--save-images", "--save-styles", "--save-spaced",
              "--save-preds", "--save-nns", "--save-gen")
EVAL_CHANNELS = dict(save_images=True, save_styles=True, save_spaced=True,
                     save_preds=True, save_nns=True, save_gen=True)
# the same run through the kernel and the plain epilogue path, f32 TF32
# off: the reconstruction loss, and the recon PNGs' mean abs over 255
AUTO_LOSS_ATOL = 1e-3
RECON_MEAN_ABS_BOUND = 1e-3
QUALITY_KEYS = ("gen_CER", "gen_WER", "writer_id_top1", "style_intra_mean",
                "style_inter_mean", "fid_hwr", "real_CER", "real_WER",
                "realism_gap", "gen_CER_degraded", "realism_gap_degraded")
# the generator's T on the evaluation path: Evaluator's generate at W/4 of
# the fixture's 448-px lines and of 1024-px lines, the quality harness's
# ceil(6 L / 8) * 8 at L = 40; at B = 2, a padded chunk's 30 real rows, 32
EVAL_T = (112, 240, 256)
EVAL_B = (2, 30, 32)
EVAL_BATCHES, EVAL_B_MAIN = 8, 32  # the timed split: 8 batches of 32 lines
EVAL_ROUNDS = 2                    # alternated rounds of the timed arms
EVAL_TEXTS, EVAL_TEXT_LEN = 256, 40
GEN_CLI_LINES = 256


class _Fixed:
    """Batches assembled once, handed out again on every sweep."""

    def __init__(self, items):
        self.items = items

    def batches(self, rng, shuffle=True):
        return iter(self.items)

    def __len__(self):
        return len(self.items)


def _cli_call(torch, ge, cli, argv):
    """``cli.main(argv)`` with its stdout captured; returns (stdout,
    epilogue launches, seconds)."""
    import contextlib
    import io
    buf = io.StringIO()
    ge.block_epilogue.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"{cli.__name__} {argv} exited {rc}")
    return buf.getvalue(), ge.block_epilogue.launches, secs


def _json_of(text):
    return json.loads(text[text.index("{"):])


def _all_finite(metrics, keys, what):
    bad = [k for k in keys if k not in metrics
           or not math.isfinite(metrics[k])]
    if bad:
        raise AssertionError(f"{what}: missing or not finite: {bad}")


def _groups(batcher):
    """Author groups of an unshuffled sweep (a style-bank row each)."""
    import numpy as np
    return sum(len(b["gt"]) // b.get("a_batch_size", 1)
               for b in batcher.batches(np.random.default_rng(0),
                                        shuffle=False))


def infer_chain(torch, np, ge, run_dir, config, overrides, work):
    """Phase 15's CLI chain: ``get_styles`` -> ``generate`` (every mode)
    -> ``evaluate`` (each checkpoint layout the run wrote, every channel,
    the kernel against the plain path, ``--quality``) ->
    ``eval_writer_id`` / ``play_styles``, each call's epilogue launches
    held to 9 a generator forward.  Returns the chain's launches."""
    from handwriting_line_generation_tpu_torch import (
        eval_writer_id, evaluate, generate, get_styles, play_styles,
    )
    from handwriting_line_generation_tpu_torch.data import datasets as D
    from handwriting_line_generation_tpu_torch.inference.generate import (
        GenerationSession, to_uint8,
    )
    from handwriting_line_generation_tpu_torch.inference.load import \
        load_model
    from handwriting_line_generation_tpu_torch.inference.styles import (
        StyleExtractor, load_styles,
    )
    from handwriting_line_generation_tpu_torch.ops.augment import \
        quantize_image_u8
    from handwriting_line_generation_tpu_torch.utils.checkpoint import (
        checkpoint_exists, load_meta,
    )
    from handwriting_line_generation_tpu_torch.utils.png import (
        read_png_gray, write_png_gray,
    )
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    run_dir, work = pathlib.Path(run_dir), pathlib.Path(work)
    cfg = _config(config, overrides)
    base = ["-c", str(REPO / "configs" / config), "-k", str(run_dir),
            "--device", DEVICE]
    total = 0

    # get_styles: the bank of train and valid, no generator forward
    out, n, secs = _cli_call(torch, ge, get_styles,
                             base + _pairs(overrides) + ["-o", str(work)])
    step = load_meta(str(run_dir), "checkpoint-latest")["iteration"]
    banks = {}
    for split in ("train", "valid"):
        banks[split] = load_styles(str(work / f"{split}_styles_{step}.npz"))
        s = banks[split]["styles"]
        want = _groups(D.make_batcher(cfg.data, split))
        if s.shape != (want, cfg.model.style.style_dim) \
                or not np.isfinite(s).all():
            raise AssertionError(f"get_styles {split}: styles {s.shape}, "
                                 f"{want} groups due, or not finite")
    cpu_model, _ = load_model(cfg, str(run_dir), device="cpu")
    cpu = StyleExtractor(cpu_model, device="cpu").extract_dataset(
        D.make_batcher(cfg.data, "train"))["styles"]
    del cpu_model
    rel = float(np.abs(banks["train"]["styles"] - cpu).max()
                / np.abs(cpu).max())
    print(f"get_styles: {secs:.2f} s, train {banks['train']['styles'].shape}"
          f" valid {banks['valid']['styles'].shape} rows, epilogue launches "
          f"{n}; card vs CPU, TF32 off: max abs diff / max |style| "
          f"{rel:.3e} (bound {STYLE_CPU_RTOL})", flush=True)
    if n != 0 or not rel <= STYLE_CPU_RTOL:
        raise AssertionError("get_styles: epilogue launches, or styles off "
                             "the CPU's")
    bank_path = str(work / f"train_styles_{step}.npz")

    # generate: every mode; each PNG read back equal to the session's image
    pngs = []
    for i, rec in enumerate(D.iam_records(str(CLI_FIXTURE), "valid", 64,
                                          1300)[:2]):
        pngs.append(str(work / f"crop{i}.png"))
        write_png_gray(pngs[-1], quantize_image_u8(rec.load()))
    model, _ = load_model(cfg, str(run_dir), device=DEVICE)
    session = GenerationSession(model, D.get_charset(cfg.data),
                                device=DEVICE)
    render_mode = generate.render_mode
    gen_ov = [a for ov in overrides for a in ("--override", ov)]
    for mode in generate.MODES:
        argv = base + gen_ov + ["-m", mode, "-n", str(INFER_COUNT), "-o",
                                str(work / "gen")]
        if mode == "from-to":
            argv += ["--from-image", pngs[0], "--to-image", pngs[1]]
        elif mode != "vae":
            argv += ["-s", bank_path]
        seen = []

        def kept(*a, **k):
            seen.append(render_mode(*a, **k))
            return seen[-1]

        with mock.patch.object(generate, "render_mode", kept):
            out, n, secs = _cli_call(torch, ge, generate, argv)
        forwards = INFER_STRETCH if mode == "stretch" else 1
        want = seen[0]
        files = sorted((work / "gen").glob(f"{mode}_*.png"))
        same = len(files) == want.shape[0] and all(
            np.array_equal(read_png_gray(str(f)), to_uint8(w))
            for f, w in zip(files, want))
        # the same images from another load of the checkpoint
        args = generate.build_parser().parse_args(argv)
        again = render_mode(args, session, cfg, load_styles(
            bank_path) if args.styles else None)
        d = np.abs(to_uint8(again).astype(int) - to_uint8(want)).max()
        e = np.abs(again - want).max()
        print(f"generate -m {mode}: {secs:.2f} s, {len(files)} PNGs "
              f"{tuple(want.shape[1:3])}, read back equal to the session's "
              f"{same}, epilogue launches {n} (want {9 * forwards}); a "
              f"second load's render: max abs diff {e:.3e}, {d} grey "
              f"levels", flush=True)
        if not same or n != 9 * forwards:
            raise AssertionError(f"generate -m {mode}")
        total += n
    del model, session
    torch.cuda.empty_cache()

    # evaluate: every channel, each layout the run wrote
    n_valid = sum(1 for _ in D.make_batcher(cfg.data, "valid").batches(
        np.random.default_rng(0), shuffle=False))
    found = [c for c in INFER_CKPTS if checkpoint_exists(str(run_dir), c)]
    print(f"checkpoints in the run: {found} (of {list(INFER_CKPTS)})",
          flush=True)
    metrics = {}
    for name in found:
        out, n, secs = _cli_call(torch, ge, evaluate, base + _pairs(
            overrides) + ["--ckpt-name", name, "-o", str(work / name),
                          *EVAL_FLAGS])
        metrics[name] = m = _json_of(out)
        _all_finite(m, ("CER", "WER", "autoLoss"), f"evaluate {name}")
        files = {f.name for f in (work / name).iterdir()}
        missing = {"styles.npz", "spaced.npz", "preds.csv", "nns.csv",
                   "recon_0_0.png", "gen_0_0.png"} - files
        print(f"evaluate --ckpt-name {name}: {secs:.2f} s, {m}, "
              f"{len(files)} files, epilogue launches {n} (want "
              f"{18 * n_valid}: autoencode and generate a batch)",
              flush=True)
        if missing or n != 18 * n_valid:
            raise AssertionError(f"evaluate {name}: missing {missing} or "
                                 f"{n} launches")
        total += n
    out, n, secs = _cli_call(torch, ge, evaluate, base + _pairs(
        overrides + ["model.generator.fused_epilogue=false"]) + [
        "-o", str(work / "plain"), *EVAL_FLAGS])
    plain, fused = _json_of(out), metrics["checkpoint-latest"]
    recon = sorted(f.name for f in (work / "plain").glob("recon_*.png"))
    mad = max(float(np.abs(
        read_png_gray(str(work / "checkpoint-latest" / f)).astype(float)
        - read_png_gray(str(work / "plain" / f))).mean()) / 255.0
              for f in recon)
    print(f"evaluate, kernel vs plain epilogue: CER {fused['CER']} / "
          f"{plain['CER']}, WER {fused['WER']} / {plain['WER']}, autoLoss "
          f"{fused['autoLoss']:.6f} / {plain['autoLoss']:.6f} (atol "
          f"{AUTO_LOSS_ATOL}); {len(recon)} recon PNGs, largest mean abs "
          f"diff / 255 {mad:.3e} (bound {RECON_MEAN_ABS_BOUND}); plain "
          f"launches {n}", flush=True)
    if (fused["CER"], fused["WER"]) != (plain["CER"], plain["WER"]) \
            or abs(fused["autoLoss"] - plain["autoLoss"]) > AUTO_LOSS_ATOL \
            or not mad <= RECON_MEAN_ABS_BOUND or n != 0:
        raise AssertionError("evaluate through the kernel disagrees with "
                             "the plain path")

    # evaluate --quality, through the kernel and the plain path
    n_texts = sum(1 for b in D.make_batcher(cfg.data, "valid").batches(
        np.random.default_rng(0), shuffle=False) for t in b["gt"]
        if t != "$UNKOWN$")
    qual = {}
    for fused_on in (True, False):
        ov = overrides + [f"model.generator.fused_epilogue="
                          f"{str(fused_on).lower()}"]
        out, n, secs = _cli_call(torch, ge, evaluate, base + _pairs(ov) + [
            "--quality", "-o", str(work / f"quality_{fused_on}")])
        qual[fused_on] = m = _json_of(out)
        _all_finite(m, QUALITY_KEYS, "evaluate --quality")
        want = 9 * -(-min(n_texts, 256) // 32) if fused_on else 0
        gap = m["realism_gap"] - (m["gen_CER"] - m["real_CER"])
        print(f"evaluate --quality (epilogue kernel {fused_on}): {secs:.2f}"
              f" s, {m}; epilogue launches {n} (want {want})", flush=True)
        if n != want or abs(gap) > 1e-12:
            raise AssertionError("evaluate --quality")
        total += n
    print(f"gen_CER through the kernel {qual[True]['gen_CER']}, through the "
          f"plain path {qual[False]['gen_CER']}", flush=True)

    # the bank's statistics
    for cli in (eval_writer_id, play_styles):
        out, n, _ = _cli_call(torch, ge, cli, [bank_path, "--device",
                                               DEVICE])
        m = _json_of(out)
        _all_finite(m, [k for k in m if k != "n"], cli.__name__)
        print(f"{cli.__name__.rsplit('.', 1)[-1]}: {m}", flush=True)
    print(f"inference chain: {total} epilogue launches", flush=True)
    return total


def _eval_batches(np, tt):
    """``EVAL_BATCHES`` batch dicts of ``EVAL_B_MAIN`` seeded u8 glyph
    lines of 64 x 1024 (``trace_train.batch``), dequantized on the host,
    as 16 author pairs shared by every batch."""
    from handwriting_line_generation_tpu_torch.charset import IAM_CHARSET
    from handwriting_line_generation_tpu_torch.ops.augment import \
        dequantize_image
    out = []
    for i in range(EVAL_BATCHES):
        image, label, lens, width = tt.batch(seed=100 + i, device="cpu",
                                             n=EVAL_B_MAIN)
        lab, n = label.numpy(), lens.numpy()
        out.append(dict(
            image=dequantize_image(image, width).numpy(), label=lab,
            label_lengths=n, width=width.numpy(), a_batch_size=2,
            gt=[IAM_CHARSET.decode(lab[b, :n[b]]) for b in range(len(n))],
            author=[f"a{b // 2:02d}" for b in range(len(n))],
            rid=[f"b{i}-{b}" for b in range(len(n))]))
    return out


def _timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def infer_rates(torch, np, ge, tt, ts, card):
    """Phase 15's numbers on the paper model at full width (f32, seeded
    weights and conv biases): evaluated lines/s with no channel and with
    every channel, through the kernel and the plain epilogue path, TF32
    off and on, in alternated rounds; ``QualityEvaluator.run``'s stages;
    generated lines/s through the ``generate`` CLI's render mode against
    ``GenerationSession`` alone."""
    from handwriting_line_generation_tpu_torch import generate
    from handwriting_line_generation_tpu_torch.charset import IAM_CHARSET
    from handwriting_line_generation_tpu_torch.data.text_data import \
        TextSampler
    from handwriting_line_generation_tpu_torch.inference.eval import \
        Evaluator
    from handwriting_line_generation_tpu_torch.inference.generate import (
        GenerationSession, to_uint8,
    )
    from handwriting_line_generation_tpu_torch.inference.quality import \
        QualityEvaluator
    from handwriting_line_generation_tpu_torch.inference.styles import (
        StyleExtractor, save_styles,
    )
    from handwriting_line_generation_tpu_torch.utils.checkpoint import \
        save_checkpoint
    from handwriting_line_generation_tpu_torch.utils.png import \
        write_png_gray
    model = ts.paper_model(DEVICE)
    split = _Fixed(_eval_batches(np, tt))
    lines = EVAL_BATCHES * EVAL_B_MAIN
    ev = Evaluator(model, IAM_CHARSET, device=DEVICE)
    work = tempfile.TemporaryDirectory()
    gen = model.generator

    def arm(fused, channels):
        gen.fused_epilogue = fused
        kw = EVAL_CHANNELS if channels else {}
        return _timed(torch, lambda: ev.run(split, out_dir=work.name, **kw))

    arms = [(f, c) for c in (False, True) for f in (True, False)]
    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        for a in arms:                                   # warm-up
            arm(*a)
        secs = {a: [] for a in arms}
        metrics = {}
        for r in range(EVAL_ROUNDS):
            for a in (arms if r % 2 == 0 else arms[::-1]):
                s, metrics[a] = arm(*a)
                secs[a].append(s)
        for c in (False, True):
            rates = {f: [lines / s for s in secs[(f, c)]] for f in (True,
                                                                    False)}
            print(f"Evaluator.run, {lines} lines (B={EVAL_B_MAIN}, 64x"
                  f"{tt.W}, f32, TF32 {'on' if tf32 else 'off'}), "
                  f"{'every channel' if c else 'no channel'}: evaluated "
                  f"lines/s through the kernel "
                  + ", ".join(f"{v:.1f}" for v in rates[True])
                  + " (median "
                  f"{statistics.median(rates[True]):.1f}), plain epilogue "
                  + ", ".join(f"{v:.1f}" for v in rates[False])
                  + f" (median {statistics.median(rates[False]):.1f}) "
                  f"{card}", flush=True)
        k, p = metrics[(True, False)], metrics[(False, False)]
        print(f"  metrics kernel {k}, plain {p}", flush=True)
        if k["CER"] != p["CER"] or not abs(k["autoLoss"] - p["autoLoss"]) \
                <= AUTO_LOSS_ATOL:
            raise AssertionError("Evaluator through the kernel disagrees "
                                 "with the plain path")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen.fused_epilogue = True

    # the quality harness over the same split, 256 texts of up to 40
    texts = TextSampler(IAM_CHARSET, EVAL_TEXTS, max_len=EVAL_TEXT_LEN,
                        seed=0).get_batch()["gt"]
    qe = QualityEvaluator(model, IAM_CHARSET, device=DEVICE)
    for rep in range(2):                    # the first warms up
        wall, q = _timed(torch, lambda: qe.run(split, texts, gen_batch=32))
    _all_finite(q, QUALITY_KEYS, "QualityEvaluator.run")
    st = qe.stage_seconds
    print(f"QualityEvaluator.run: {lines} real lines, {len(texts)} texts "
          f"(longest {max(map(len, texts))}) at gen_batch 32, f32, TF32 off:"
          f" {wall:.3f} s; style sweep {st['style_sweep']:.3f} s, gen + "
          f"readback {st['gen_readback']:.3f} s, degraded readback (host) "
          f"{st['degrade']:.3f} s, FID (host, D=512) {st['fid']:.3f} s; "
          f"{q} {card}", flush=True)

    # the generate CLI's render mode against the session alone
    ckpt = pathlib.Path(work.name, "ckpt")
    save_checkpoint(str(ckpt), "checkpoint-latest",
                    {"model": model.state_dict(), "step": 0})
    bank = StyleExtractor(model, device=DEVICE).extract_dataset(split)
    bank_path = str(ckpt / "bank.npz")
    save_styles(bank_path, bank)
    argv = ["-c", str(ts.CONFIG), "-k", str(ckpt), "-s", bank_path, "-m",
            "render", "-n", str(GEN_CLI_LINES), "-o", str(ckpt / "out"),
            "--device", DEVICE, "--override",
            "model.generator.fused_epilogue=true", "--override",
            "model.compute_dtype=float32"]
    cli_secs = [_cli_call(torch, ge, generate, argv)[2] for _ in range(3)]
    session = GenerationSession(model, IAM_CHARSET, device=DEVICE)
    texts = [generate.build_parser().parse_args(argv).text] * GEN_CLI_LINES
    alone = [_timed(torch, lambda: session.random_interpolated(
        texts, bank["styles"], seed=0)) for _ in range(4)][1:]
    imgs = alone[-1][1]
    t0 = time.perf_counter()
    for i in range(imgs.shape[0]):
        write_png_gray(str(ckpt / "w.png"), to_uint8(imgs[i]))
    png_secs = time.perf_counter() - t0
    print(f"generate -m render, {GEN_CLI_LINES} lines of "
          f"{tuple(imgs.shape[1:3])} (f32, TF32 off): the CLI "
          + ", ".join(f"{GEN_CLI_LINES / s:.1f}" for s in cli_secs[1:])
          + " generated lines/s (first call "
          f"{GEN_CLI_LINES / cli_secs[0]:.1f}); GenerationSession alone "
          + ", ".join(f"{GEN_CLI_LINES / s:.1f}" for s, _ in alone)
          + f"; the PNG writes alone {png_secs:.3f} s {card}", flush=True)
    work.cleanup()
    del model, ev, qe, session
    torch.cuda.empty_cache()


def infer_phase(torch, np, ge, tt, ts, card, root):
    """Phase 15.  Returns the kernels-line entry of the evaluation path's
    epilogue (B = ``EVAL_B_MAIN``, T = ``EVAL_T[-1]``; its error the
    largest of every (B, T))."""
    with tempfile.TemporaryDirectory() as work:
        launches = infer_chain(torch, np, ge,
                               pathlib.Path(root) / "iam_gan_paper",
                               "iam_gan_paper.json", INFER_OVERRIDES, work)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    err, rows = 0.0, {}
    for t in EVAL_T:
        for b in EVAL_B:
            rows[(b, t)] = epilogue_row(
                torch, ge, tt, f"gen_epilogue (evaluation, B={b} T={t} "
                "float32)", epilogue_calls(t=t), b, torch.float32, launches,
                card)
            err = max(err, rows[(b, t)]["max_abs_err"])
    infer_rates(torch, np, ge, tt, ts, card)
    return dict(rows[(EVAL_B_MAIN, EVAL_T[-1])], max_abs_err=err)


# phase 16: multi-process training on the one card.  Every run is the
# port's train CLI under torchrun through this script's rank wrapper
# (``chip_smoke.py --rank-run OUT [--deterministic] -- TRAIN ARGS``), which
# counts the rank's CTC launches, its peak device memory and the files it
# replaced into place (every checkpoint, log and strip is written so), and
# keeps the first step's averaged gradients
DIST_HWR_STEPS, DIST_HWR_RESUME_TO = 10, 12
DIST_GAN_LESSONS = 14              # two cycles: the second one timed
DIST_EXACT_STEPS = 4               # (b), (c): runs held bit-equal
DIST_BUCKET_REPS = 3               # timed all_reduce_mean calls, after one
DIST_TIMEOUT = 600                 # s for one torchrun call
DIST_EXACT_BACKEND = "nccl"        # (b): a world of 1 on the card's NCCL
# the first step's averaged gradients against one process on the
# concatenated batch, of each tensor's largest entry: f32 rounding alone
# moves the count lesson's first style-extractor convs (sums of ~1e5
# cancelling terms) by up to 2.8e-4 of their max between two one-process
# CPU runs that differ only in their thread count, at the CPU tests' GAN
# widths; a faulty average (a sum not divided, groups balanced before
# averaging, the wrong rows' draws) is off by O(1)
DIST_GRAD_RTOL = 1e-3
# the GAN's gradient groups a paper cycle averages (count 1, gen 2, auto
# 3, disc 1, gen 2, auto 3, disc 1) and the lessons' group counts timed
DIST_CYCLE_GROUPS = 13
DIST_BUCKET_GROUPS = (1, 2, 3)


def rank_run(args):
    """One rank of a phase 16 run: ``train.main`` on the rest of the
    arguments (TF32 off), then ``OUT/rank<R>.json`` with its exit code,
    seconds, CTC launches, peak device memory, the paths it wrote, its log
    entries, its backend and its grid; ``OUT/grads<R>.pt``: the tensors of
    the trainer's first ``_average`` call after it (the first step's
    gradients and loss, averaged over the ranks)."""
    import os
    out, args = pathlib.Path(args[0]), args[1:]
    deterministic = args[:1] == ["--deterministic"]
    args = args[1:] if deterministic else args
    if args[:1] != ["--"]:
        raise SystemExit("chip_smoke.py --rank-run OUT [--deterministic] "
                         "-- TRAIN ARGS")
    if deterministic:                 # the exact runs (b) and (c)
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
    # f32 as in the other phases (and the one-process runs beside them)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from handwriting_line_generation_tpu_torch import train as cli
    from handwriting_line_generation_tpu_torch.ops import ctc
    from handwriting_line_generation_tpu_torch.training.loop import \
        CheckpointedTrainer as trainer
    rank = int(os.environ.get("RANK", "0"))
    out.mkdir(parents=True, exist_ok=True)
    written, replace = [], os.replace
    seen = dict(log=[], backend=None, grid=None)

    def recording(src, dst, *a, **kw):
        written.append(str(dst))
        return replace(src, dst, *a, **kw)

    def log_line(entry, show=cli.log_line):
        seen["log"].append(entry)
        show(entry)

    def init(*a, join=cli.init_distributed, **kw):
        n = join(*a, **kw)
        seen["backend"] = torch.distributed.get_backend()
        return n

    def grid(*a, make=cli.make_mesh, **kw):
        m = make(*a, **kw)
        seen["grid"] = [m.data, m.model]
        return m
    def first_average(self, tensors, average=trainer._average, kept=[]):
        average(self, tensors)
        if not kept:
            kept.append(rank)
            torch.save([t.detach().cpu() for t in tensors],
                       out / f"grads{rank}.pt")
    os.replace = recording
    cli.log_line, cli.init_distributed, cli.make_mesh = log_line, init, grid
    trainer._average = first_average
    ctc.ctc_loss_cuda.launches = 0
    t0 = time.perf_counter()
    try:
        rc = cli.main(args[1:])
    finally:
        os.replace = replace
    secs = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated()
            if torch.cuda.is_available() else 0)
    (out / f"rank{rank}.json").write_text(json.dumps(dict(
        rc=rc, secs=secs, launches=ctc.ctc_loss_cuda.launches,
        peak_bytes=peak, written=written, **seen)))
    return rc


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _dist_start(world, out, train_args, deterministic=False,
                backend="gloo"):
    """The train CLI through :func:`rank_run`: ``world`` ranks under
    torchrun (``--distributed``), or one plain process when ``world`` is
    0.  Returns the started process."""
    wrapper = ([str(REPO / "chip_smoke.py"), "--rank-run", str(out)]
               + (["--deterministic"] if deterministic else []) + ["--"]
               + list(train_args) + ["--device", DEVICE])
    if world:
        cmd = [sys.executable, "-m", "torch.distributed.run",
               "--nproc_per_node", str(world), "--master_port",
               str(_free_port()), *wrapper, "--distributed",
               "--dist-backend", backend]
    else:
        cmd = [sys.executable, *wrapper]
    print(" ".join(cmd[1:]), flush=True)
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, cwd=REPO)


def _dist_wait(proc, world, out):
    """The run's output and its ranks' records; raises with the output's
    end if a rank failed."""
    try:
        text, _ = proc.communicate(timeout=DIST_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    recs = [json.loads((pathlib.Path(out) / f"rank{r}.json").read_text())
            if (pathlib.Path(out) / f"rank{r}.json").exists() else None
            for r in range(max(world, 1))]
    if proc.returncode != 0 or any(r is None or r["rc"] != 0 for r in recs):
        print(text[-6000:])
        raise AssertionError(f"{' '.join(proc.args[1:4])}... exited "
                             f"{proc.returncode}")
    return text, recs


def _rank_logs(recs):
    """The log entries of each rank, its ``rank`` key dropped."""
    return [[{k: v for k, v in e.items() if k != "rank"} for e in r["log"]]
            for r in recs]


def _losses(entries):
    return [(e.get("iteration"), k, v) for e in entries
            for k, v in sorted(e.items()) if k.lower().endswith("loss")]


def _shard_batches(D, cfg, n):
    """The first ``n`` batches of each of two ranks' shards, padded to
    their common shapes and concatenated: the one-process run's batches."""
    import numpy as np
    its = [D.forever(D.make_batcher(cfg.data, "train", (2, r)),
                     seed=cfg.trainer.seed) for r in range(2)]
    out = []
    for _ in range(n):
        pair = [next(it) for it in its]
        W = max(b["image"].shape[2] for b in pair)
        L = max(b["label"].shape[1] for b in pair)
        a, b = (D.pad_batch(x, W, L) for x in pair)
        out.append({k: (np.concatenate([v, b[k]]) if isinstance(v, np.ndarray)
                        else v + b[k] if isinstance(v, list) else v)
                    for k, v in a.items()})
    return out


def _record_first(trainer):
    """The tensors of ``trainer``'s first ``_average`` call (in one process
    nothing to average): the first step's gradients and loss."""
    got = []

    def record(tensors):
        if not got:
            got.extend(t.detach().cpu().clone() for t in tensors)
    trainer._average = record
    return got


def _first_grads(torch, out, want, what):
    """The two ranks' first averaged gradients (:func:`rank_run`'s
    ``grads<R>.pt``): bit-equal to each other, and each tensor within
    ``DIST_GRAD_RTOL`` of its largest entry in ``want``, the one-process
    run's on the concatenated batch.  Returns the worst tensor's ratio."""
    a, b = (torch.load(pathlib.Path(out) / f"grads{r}.pt",
                       weights_only=True) for r in range(2))
    _same(torch, a, b, f"{what}: the ranks' first averaged gradients")
    if len(a) != len(want):
        raise AssertionError(f"{what}: {len(a)} averaged tensors, {len(want)}"
                             f" in one process")
    worst = 0.0
    for i, (g, w) in enumerate(zip(a, want)):
        err = float((g.double() - w.double()).abs().max())
        scale = float(w.abs().max())
        rel = err / scale if scale else (math.inf if err else 0.0)
        if rel > DIST_GRAD_RTOL:
            raise AssertionError(f"{what}: averaged tensor {i} is {rel:.3e} "
                                 f"of its max from one process (tolerance "
                                 f"{DIST_GRAD_RTOL})")
        worst = max(worst, rel)
    return worst


def _adam_bound(lr, betas, steps):
    """The CPU tests' bound on two runs' parameters after ``steps`` Adam
    steps of rate <= ``lr``: 2 lr x the sum of each step's largest |update|
    / lr (``sqrt(sum a_k^2 / w_k)``) + 1e-6."""
    b1, b2 = betas
    total = 0.0
    for t in range(1, steps + 1):
        a = [(1 - b1) * b1 ** (t - k) / (1 - b1 ** t) for k in range(1, t + 1)]
        w = [(1 - b2) * b2 ** (t - k) / (1 - b2 ** t) for k in range(1, t + 1)]
        total += math.sqrt(sum(x * x / y for x, y in zip(a, w)))
    return 2 * lr * total + 1e-6


def _param_gap(torch, got, want, bound_of):
    """Max |got - want| over the float tensors of two model state_dicts
    (``.u`` buffers aside), each against ``bound_of(name)``; the worst
    tensor's gap and bound."""
    worst = (0.0, 1.0, "")
    for name, v in want.items():
        if name.endswith(".u") or not v.is_floating_point():
            continue
        gap = float((got[name].float().cpu() - v.float().cpu()).abs().max())
        bound = bound_of(name)
        if gap > bound:
            raise AssertionError(f"{name}: the two ranks' run is {gap:.3e} "
                                 f"from the one-process run (bound "
                                 f"{bound:.3e})")
        worst = max(worst, (gap, bound, name), key=lambda x: x[0] / x[1])
    return worst


def _checkpoint(run_dir):
    import torch
    return torch.load(pathlib.Path(run_dir) / "checkpoint-latest.pt",
                      map_location="cpu", weights_only=True)


def _same(torch, a, b, what):
    """Two nests of tensors equal bit for bit."""
    if isinstance(a, dict):
        if a.keys() != b.keys():
            raise AssertionError(f"{what}: keys differ")
        for k in a:
            _same(torch, a[k], b[k], f"{what}/{k}")
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            _same(torch, x, y, f"{what}[{i}]")
    elif isinstance(a, torch.Tensor):
        if not torch.equal(a, b):
            diff = float((a.double() - b.double()).abs().max())
            raise AssertionError(f"{what}: not bit-equal (max diff "
                                 f"{diff:.3e})")
    elif a != b:
        raise AssertionError(f"{what}: {a} != {b}")


def _only_rank0_wrote(recs, run_dir):
    mine = [[p for p in r["written"] if p.startswith(str(run_dir))]
            for r in recs]
    if not mine[0] or any(mine[1:]):
        raise AssertionError(f"single writer broken: rank 0 wrote "
                             f"{len(mine[0])} files under {run_dir}, the "
                             f"others {[len(m) for m in mine[1:]]}")
    return len(mine[0])


def _bucket_rank(rank, port, shapes, device, out):
    """One of two gloo ranks on ``device`` timing ``Mesh.all_reduce_mean``
    of the paper GAN's gradient groups (1, 2 and 3 groups a call)."""
    import os
    import torch
    from handwriting_line_generation_tpu_torch.parallel import mesh as pm
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank))
    pm.init_distributed("gloo", device)
    mesh = pm.make_mesh(2, 1)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    res = {}
    for groups in DIST_BUCKET_GROUPS:
        ts = [torch.randn(s, device=device) for _ in range(groups)
              for s in shapes]
        times = []
        for i in range(DIST_BUCKET_REPS + 1):
            sync()
            t0 = time.perf_counter()
            mesh.all_reduce_mean(ts)
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        res[groups] = dict(ms=statistics.median(times[1:]),
                           bytes=sum(t.numel() * 4 for t in ts))
        del ts
    if rank == 0:
        pathlib.Path(out).write_text(json.dumps(res))
    pm.barrier()
    pm.shutdown()


def dist_bucket_rates(torch, card, work):
    """Ms a call of the gradient bucket's ``all_reduce`` over two gloo
    ranks on this card, at the paper GAN's 1, 2 and 3 groups; ms a cycle
    of its 13."""
    from handwriting_line_generation_tpu_torch.models.hw_with_style import \
        HWWithStyle
    with torch.device("meta"):
        model = HWWithStyle(_config("iam_gan_paper.json", []).model)
    shapes = [tuple(p.shape) for p in model.parameters()]
    n = sum(math.prod(s) for s in shapes)
    out = pathlib.Path(work) / "bucket.json"
    torch.multiprocessing.start_processes(
        _bucket_rank, args=(_free_port(), shapes, DEVICE, str(out)), nprocs=2,
        join=True, start_method="spawn")
    res = {int(k): v for k, v in json.loads(out.read_text()).items()}
    per_group = res[1]["ms"]
    for g, r in sorted(res.items()):
        print(f"gradient bucket all_reduce_mean, 2 gloo ranks on one card "
              f"(through the host, not multi-card NCCL): {g} group(s) of "
              f"{n / 1e6:.1f} M f32, {r['bytes'] / 1e6:.1f} MB: "
              f"{r['ms']:.2f} ms {card}", flush=True)
    print(f"gradient buckets a 7-lesson paper cycle: {DIST_CYCLE_GROUPS} "
          f"groups, ~{DIST_CYCLE_GROUPS * per_group:.0f} ms at the 1-group "
          f"rate {card}", flush=True)
    return res


def dist_phase(torch, tt, F, ctc, card, root, cli_root):
    """Phase 16: (a) ``iam_hwr`` for 10 steps (profiled) and
    ``iam_gan_paper`` for 14 lessons on two gloo ranks on this card through
    torchrun, against one process on the concatenated batches, rank 0 the
    only writer, the HWR run resumed in one process; (b) ``iam_hwr``
    for 4 steps as a world of 1 on NCCL and (c) on a 1 x 2 ``--fsdp 2``
    grid of two gloo ranks, each bit-equal to the plain run; (d)
    ``graft_entry.dryrun_multichip(2)`` on the card; (e) the profiles name
    the CTC kernel; the bucket's all_reduce rates.  Returns the kernels-line
    rows of the distributed runs' CTC paths."""
    import numpy as np
    from handwriting_line_generation_tpu_torch import graft_entry
    from handwriting_line_generation_tpu_torch.data import datasets as D
    from handwriting_line_generation_tpu_torch.training.gan_trainer import \
        GanTrainer
    from handwriting_line_generation_tpu_torch.training.hwr_trainer import \
        HWRTrainer
    from handwriting_line_generation_tpu_torch.training.train_state import \
        partition_label
    t_phase = time.perf_counter()
    root = pathlib.Path(root)
    cli_root = pathlib.Path(cli_root)
    fixture = [f"data.data_dir={CLI_FIXTURE}"]
    hwr_ov = fixture + [f"data.batch_size={CLI_BATCH}", "trainer.log_step=5",
                        f"trainer.val_step={DIST_HWR_STEPS}",
                        f"trainer.save_step_minor={DIST_HWR_STEPS}"]

    def hwr_args(name, ov=hwr_ov):
        return ["-c", str(REPO / "configs" / "iam_hwr.json"),
                *_pairs(ov + [f"trainer.save_dir={root / name}"])]

    # (a) iam_hwr on two ranks, profiled; (b) and (c) beside it: the plain
    # 4-step run, the same as a world of 1 on NCCL and on a 1 x 2 grid
    exact = hwr_ov + [f"trainer.save_step_minor={DIST_EXACT_STEPS}"]
    runs = {"a_hwr": (2, _dist_start(2, root / "out_a_hwr", hwr_args(
                "a_hwr") + ["-i", str(DIST_HWR_STEPS), "--profile",
                            str(root / "prof")])),
            "plain": (0, _dist_start(0, root / "out_plain", hwr_args(
                "plain", exact) + ["-i", str(DIST_EXACT_STEPS)],
                deterministic=True)),
            "nccl1": (1, _dist_start(1, root / "out_nccl1", hwr_args(
                "nccl1", exact) + ["-i", str(DIST_EXACT_STEPS)],
                deterministic=True, backend=DIST_EXACT_BACKEND)),
            "fsdp2": (2, _dist_start(2, root / "out_fsdp2", hwr_args(
                "fsdp2", exact) + ["-i", str(DIST_EXACT_STEPS), "--fsdp",
                                   "2"], deterministic=True))}
    res = {k: _dist_wait(p, w, root / f"out_{k}")
           for k, (w, p) in runs.items()}

    # (a) iam_hwr: the ranks' losses equal, rank 0 the only writer, CTC
    # launches a step and a local validation batch each, the first step's
    # averaged gradients those of one process on the concatenated batch
    text, recs = res["a_hwr"]
    logs = _rank_logs(recs)
    if not _losses(logs[0]) or _losses(logs[0]) != _losses(logs[1]):
        raise AssertionError("the two ranks logged different losses")
    run_dir = root / "a_hwr" / "iam_hwr"
    wrote = _only_rank0_wrote(recs, run_dir)
    cfg = _config("iam_hwr.json", hwr_ov)
    val_local = _val_batches(cfg, HWRTrainer, shard=(2, 0))
    want = DIST_HWR_STEPS + val_local
    launches_hwr = [r["launches"] for r in recs]
    if DEVICE == "cuda" and launches_hwr != [want, want]:
        raise AssertionError(f"iam_hwr on two ranks: CTC launches "
                             f"{launches_hwr}, {want} due on each")
    ref_cfg = _config("iam_hwr.json",
                      hwr_ov + [f"trainer.save_dir={root / 'ref'}"])
    ref = HWRTrainer(ref_cfg, device=DEVICE)
    first = _record_first(ref)
    ref.train(iter(_shard_batches(D, ref_cfg, DIST_HWR_STEPS)),
              iterations=DIST_HWR_STEPS, valid=None)
    rel = _first_grads(torch, root / "out_a_hwr", first, "iam_hwr")
    bound = _adam_bound(ref_cfg.optimizer.lr, ref_cfg.optimizer.betas,
                        DIST_HWR_STEPS)
    gap = _param_gap(torch, _checkpoint(run_dir)["model"],
                     ref.model.state_dict(), lambda name: bound)
    del ref
    print(f"distributed iam_hwr, 2 gloo ranks on one card: losses "
          f"{[e['loss'] for e in logs[0] if 'loss' in e]} on both; CTC "
          f"launches {launches_hwr}; rank 0 wrote {wrote} files, rank 1 "
          f"none; the first step's averaged gradients and loss bit-equal "
          f"on both ranks and within {rel:.3e} of each tensor's max from "
          f"one process on the concatenated batch (tolerance "
          f"{DIST_GRAD_RTOL}); parameters after {DIST_HWR_STEPS} steps "
          f"{gap[0]:.3e} from it (Adam bound {gap[1]:.3e}, {gap[2]}); "
          f"{[round(r['secs'], 1) for r in recs]} s; peak "
          f"{[round(r['peak_bytes'] / 2**30, 3) for r in recs]} GiB a rank "
          f"{card}", flush=True)
    # (e) the profiles: a Chrome trace a rank, naming the CTC kernel
    for r in range(2):
        trace = (root / "prof" / f"trace_rank{r}.json").read_text()
        if DEVICE == "cuda" and "ctc_kernel" not in trace:
            raise AssertionError(f"rank {r}'s trace names no ctc_kernel")
    print(f"--profile: trace_rank0.json and trace_rank1.json, each naming "
          f"ctc_kernel", flush=True)

    # (b), (c): bit-equal to the plain run
    plain = _checkpoint(root / "plain" / "iam_hwr")
    for k in ("nccl1", "fsdp2"):
        _same(torch, _checkpoint(root / k / "iam_hwr"), plain, k)
    ran = [(r["backend"], r["grid"]) for k in ("nccl1", "fsdp2")
           for r in res[k][1]]
    if ran != [(DIST_EXACT_BACKEND, [1, 1])] + [("gloo", [1, 2])] * 2:
        raise AssertionError(f"(b)/(c) ran as {ran}")
    print(f"iam_hwr {DIST_EXACT_STEPS} steps, deterministic algorithms: "
          f"a world of 1 on NCCL and --fsdp 2 (1 x 2 gloo ranks, sharded "
          f"Adam) each wrote the plain run's checkpoint-latest bit for bit",
          flush=True)

    # (a) resume: the two ranks' checkpoint in one process, beside (d) the
    # graft entry's multichip dry run on two gloo ranks
    p = _dist_start(0, root / "out_resume", hwr_args(
        "a_hwr", hwr_ov + ["trainer.log_step=2", "trainer.save_step_minor=2",
                           "trainer.val_step=0"])
        + ["-r", "-i", str(DIST_HWR_RESUME_TO)])
    graft_entry.dryrun_multichip(2, device=DEVICE, backend="gloo")
    _, recs = _dist_wait(p, 0, root / "out_resume")
    its = [e["iteration"] for e in _rank_logs(recs)[0]]
    meta = json.loads((run_dir / "checkpoint-latest.json").read_text())
    if its != [DIST_HWR_RESUME_TO] or meta["iteration"] != DIST_HWR_RESUME_TO:
        raise AssertionError(f"the two ranks' run resumed in one process "
                             f"logged {its}, saved {meta['iteration']}")
    print(f"the two ranks' checkpoint-latest resumed in one process: "
          f"steps {DIST_HWR_STEPS + 1}..{DIST_HWR_RESUME_TO}", flush=True)

    # (a) the paper GAN on two ranks, the card to itself
    gan_ov = fixture + [
        f"model.pretrained_hwr={cli_root}/iam_hwr/checkpoint-latest",
        f"trainer.encoder_weights={cli_root}/iam_auto_2tight/"
        "checkpoint-latest", "data.text_data=", "trainer.log_step=7",
        f"trainer.val_step={DIST_GAN_LESSONS}",
        f"trainer.save_step_minor={DIST_GAN_LESSONS}",
        f"trainer.print_every={DIST_GAN_LESSONS}"]
    p = _dist_start(2, root / "out_gan", [
        "-c", str(REPO / "configs" / "iam_gan_paper.json"),
        *_pairs(gan_ov + [f"trainer.save_dir={root / 'gan'}"]),
        "-i", str(DIST_GAN_LESSONS)])
    text, recs = _dist_wait(p, 2, root / "out_gan")
    logs = _rank_logs(recs)
    if not _losses(logs[0]) or _losses(logs[0]) != _losses(logs[1]):
        raise AssertionError("the GAN's two ranks logged different losses")
    run_dir = root / "gan" / "iam_gan_paper"
    wrote = _only_rank0_wrote(recs, run_dir)
    launches_gan = [r["launches"] for r in recs]
    want = 4 * DIST_GAN_LESSONS // 7   # genRecog, reconRecog twice a cycle
    if DEVICE == "cuda" and launches_gan != [want, want]:
        raise AssertionError(f"the GAN on two ranks: CTC launches "
                             f"{launches_gan}, {want} due on each")
    # lessons 8-14 (the window of the log entry at 14): every kind warm,
    # no validation, save or dump inside
    two_rate = 4 / [e for e in logs[0] if "sec_per_iter" in e][-1][
        "sec_per_iter"]
    cfg = _config("iam_gan_paper.json",
                  gan_ov + [f"trainer.save_dir={root / 'gan_ref'}"])
    ref = GanTrainer(cfg, device=DEVICE)
    ref.text.batch_size //= 2            # a rank's texts, on both ranks
    draw = ref.text.get_batch
    ref.text.get_batch = lambda **kw: {
        k: (np.concatenate([v, v]) if isinstance(v, np.ndarray)
            else v + v if isinstance(v, list) else v)
        for k, v in draw(**kw).items()}
    # count, auto, disc, auto, disc a cycle pull image batches
    images = _shard_batches(D, cfg, 5 * DIST_GAN_LESSONS // 7)
    first = _record_first(ref)
    rlog = ref.train(iter(images), iterations=DIST_GAN_LESSONS, valid=None)
    rel = _first_grads(torch, root / "out_gan", first, "iam_gan_paper")
    one_rate = 4 / rlog.entries[-1]["sec_per_iter"]
    o, d = cfg.optimizer, cfg.optimizer_discriminator
    cycles = DIST_GAN_LESSONS // 7
    bounds = {"main": _adam_bound(o.lr, o.betas, 3 * cycles),
              "disc": _adam_bound(d.lr, d.betas, 2 * cycles), "frozen": 1e-6}
    frozen = cfg.model.hwr_frozen
    gap = _param_gap(torch, _checkpoint(run_dir)["model"],
                     ref.model.state_dict(), lambda name: bounds[
                         partition_label(name, hwr_frozen=frozen)])
    peak = [r["peak_bytes"] / 2 ** 30 for r in recs]
    del ref
    torch.cuda.empty_cache()
    print(f"distributed iam_gan_paper, {DIST_GAN_LESSONS} lessons, 2 gloo "
          f"ranks on one card (through the host, not multi-card NCCL): "
          f"losses equal on both ranks; CTC launches {launches_gan}; rank 0 "
          f"wrote {wrote} files, rank 1 none; the first lesson's (count) "
          f"averaged gradients and loss bit-equal on both ranks and within "
          f"{rel:.3e} of each tensor's max from one process on the "
          f"concatenated batch (tolerance {DIST_GRAD_RTOL}); parameters "
          f"after {DIST_GAN_LESSONS} lessons {gap[0]:.3e} from it (Adam "
          f"bound {gap[1]:.3e}, {gap[2]}); GAN-trained lines/s over lessons "
          f"8-14: "
          f"{two_rate:.1f} on 2 ranks against {one_rate:.1f} in one process "
          f"(batches assembled first); peak {peak[0]:.3f} and {peak[1]:.3f} "
          f"GiB a rank {card}", flush=True)

    dist_bucket_rates(torch, card, root)

    # the CTC kernel at the distributed runs' per-rank shapes
    rows = []
    for path, (b, t, lab), launches in (
            ("iam_hwr", (2, 112, 24), launches_hwr),
            ("iam_gan_paper genRecog", (2, 500, 96), launches_gan)):
        err = check_ctc(torch, ctc, t, lab, seed=t + lab, batch=b)
        times = time_ctc(torch, tt, F, ctc, t, lab, card, batch=b)
        rows += [(f"distributed {path}, rank {r} of 2", (b, t, lab), n, err,
                  times) for r, n in enumerate(launches)]
    print(f"phase 16: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return rows



# phase 17: the synthetic pipeline, each stage a fresh train CLI process,
# at a cut corpus and budget; its stages' CTC launches come from each
# process's last line
PIPE_CUT = ["data.synthetic_authors=8", "data.synthetic_lines=8"]
PIPE_STEPS, PIPE_GAN_LESSONS = 20, 14
PIPE_TIMEOUT = 600                 # s for one pipeline call
PIPE_TRAJECTORY = 7                # lessons of the cache check's trajectory


def _pipeline_start(family, save_dir, *flags):
    """Start ``python -m ...pipeline --family FAMILY`` at the cut, on the
    card; returns the process and its start time."""
    argv = [sys.executable, "-m",
            "handwriting_line_generation_tpu_torch.pipeline", "--family",
            family, "--save-dir", str(save_dir), "--device", DEVICE,
            *_pairs(PIPE_CUT + [f"trainer.iterations={PIPE_STEPS}"]),
            *flags]
    print(" ".join(argv[2:]), flush=True)
    return (subprocess.Popen(argv, cwd=REPO, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True),
            time.perf_counter())


def _pipeline_wait(started):
    """(exit code, seconds, output) of a started pipeline call; killed
    past ``PIPE_TIMEOUT``."""
    proc, t0 = started
    try:
        out, _ = proc.communicate(timeout=PIPE_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    print(out, flush=True)
    return proc.returncode, time.perf_counter() - t0, out


def _stage_launches(save_dir, name):
    """The CTC launches each train process of a stage counted."""
    log = pathlib.Path(save_dir, name + ".log")
    return [int(l.split()[-1]) for l in log.read_text().splitlines()
            if l.startswith("kernel launches: ctc ")]


def pipeline_phase(torch, tt, F, ctc, card):
    """Phase 17.  Returns the kernels-line rows of the pipeline's CTC
    paths."""
    from handwriting_line_generation_tpu_torch.utils.checkpoint import \
        load_meta
    t_phase = time.perf_counter()
    (REPO / "saved").mkdir(exist_ok=True)
    # the GAN reads its corpus only from inside the checkout
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pipeline_",
                                     dir=REPO / "saved") as tmp:
        save_dir = pathlib.Path(tmp)
        rows = _pipeline_runs(load_meta, save_dir, card)
    out = []
    for name, (b, t, lab), launches in rows:
        err = check_ctc(torch, ctc, t, lab, seed=t + lab, batch=b)
        out.append((f"pipeline {name}", (b, t, lab), launches, err,
                    time_ctc(torch, tt, F, ctc, t, lab, card, batch=b)))
    print(f"phase 17: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


def _iam3_runs(load_meta, save_dir, iam, due, card):
    """``iam3`` through the GAN, then again; returns its stages' CTC
    launches."""
    gan = ["--gan-iterations", str(PIPE_GAN_LESSONS)]
    rc, secs, _ = _pipeline_wait(_pipeline_start("iam3", save_dir, *gan))
    launches = {n: _stage_launches(save_dir, n) for n in iam}
    at = {n: load_meta(str(save_dir / n), "checkpoint-latest")["iteration"]
          for n in iam}
    gan_log = (save_dir / "syn_gan3.log").read_text()
    corpus = (save_dir / "syn_text.txt").read_text().splitlines()
    print(f"pipeline iam3: exit {rc}, {secs:.1f} s; checkpoint-latest at "
          f"{at}; CTC launches {launches}; corpus {len(corpus)} lines "
          f"{card}", flush=True)
    if rc != 0 or at != iam or any(launches[n] != [due[n]] for n in iam) \
            or len(corpus) != 5000 or "does not exist" in gan_log:
        raise AssertionError("the iam3 pipeline: a stage failed, stopped "
                             "short, launched the CTC kernel other than "
                             f"{due}, or the GAN missed its corpus")
    rc, secs, out = _pipeline_wait(_pipeline_start("iam3", save_dir, *gan))
    again = {n: _stage_launches(save_dir, n) for n in iam}
    print(f"pipeline iam3 again: exit {rc}, {secs:.1f} s; "
          f"{out.count('skipped')} stages skipped", flush=True)
    if rc != 0 or again != launches or out.count("skipped") != len(iam):
        raise AssertionError("a second iam3 pipeline call took a step")
    return launches


def _pipeline_runs(load_meta, save_dir, card):
    """The pipeline calls of phase 17 and their checks; returns each
    stage's CTC shape and launches."""
    iam = {"syn_hwr3": PIPE_STEPS, "syn_auto3": PIPE_STEPS,
           "syn_gan3": PIPE_GAN_LESSONS}
    rimes = {"syn_rimes_hwr3": PIPE_STEPS, "syn_rimes_auto3": PIPE_STEPS}
    # genRecog and reconRecog twice a 7-lesson cycle, none in validation
    # (val_step 2000); a step each for the recognizer and the autoencoder
    due = {n: (4 * PIPE_GAN_LESSONS // 7 if "gan" in n else PIPE_STEPS)
           for n in {**iam, **rimes}}
    # the two families run side by side, each in its own directory
    rimes_job = _pipeline_start("rimes3", save_dir / "rimes3", "--through",
                                "spaced", "--check-cache", "--trajectory",
                                str(PIPE_TRAJECTORY))
    try:
        launches = _iam3_runs(load_meta, save_dir / "iam3", iam, due, card)
    finally:
        rc, secs, out = _pipeline_wait(rimes_job)
    rl = {n: _stage_launches(save_dir / "rimes3", n) for n in rimes}
    cache = next(json.loads(l[l.index("{"):l.rindex("}") + 1])
                 for l in out.splitlines()
                 if "cache against live alignment" in l)
    print(f"pipeline rimes3 through the cache: exit {rc}, {secs:.1f} s; CTC "
          f"launches {rl}; cache against live: {cache['rows']} rows, "
          f"{cache['mismatched_positions']} of {cache['positions']} "
          f"positions differ; lessons {cache['lessons']}; trajectory of "
          f"{cache['trajectory']['lessons']} lessons with and without it: "
          f"first unequal {cache['trajectory']['first_unequal']}, largest "
          f"loss difference {cache['trajectory']['max_loss_diff']} {card}",
          flush=True)
    if rc != 0 or any(rl[n] != [due[n]] for n in rimes) \
            or cache["mismatched_positions"] != 0 or any(
                v["max_loss_diff"] != 0 or v["max_group_diff"] != 0
                for v in cache["lessons"].values()) \
            or cache["trajectory"]["lessons"] != PIPE_TRAJECTORY \
            or cache["trajectory"]["first_unequal"] is not None:
        raise AssertionError("the rimes3 cache differs from live alignment, "
                             "or a stage failed")

    # each stage's CTC shape: frames W/4 for the recognizer and reconRecog,
    # W/8 for the autoencoder's head, the generated lines' spaced length
    # for genRecog
    gan = _config("syn_gan3.json", [])
    gen_t = min(gan.model.max_gen_length, 6 * max(gan.data.label_buckets))
    lines = gan.data.batch_size * gan.data.a_batch_size
    shapes = {"syn_hwr3": (32, 112, 16), "syn_auto3": (28, 56, 16),
              "syn_gan3": (lines, gen_t, 16),
              "syn_rimes_hwr3": (32, 112, 16),
              "syn_rimes_auto3": (28, 56, 16)}
    return [(name, shape, sum({**launches, **rl}[name]))
            for name, shape in shapes.items()]


# phase 18: every model variant of the JAX package and its checkpoints.
# The committed JAX fixture through load_model and the epilogue kernel; the
# CRNN and SmallCRNN recognizers through the CTC kernel; the 32-px family
# and phase_upsample at the paper's widths; the normalization augmentation
FIXTURE_DIR = REPO / "tests" / "fixtures" / "jax_ckpt"
# the fixture's render against the JAX package's (float32, TF32 off): the
# same bound as a generator forward against its plain path on the card
JAX_RENDER_ATOL = 1e-4
DECODE_REPS = 20
CRNN_STEPS = 30
SMALL_CRNN_STEPS, SMALL_CRNN_H, SMALL_CRNN_W = 5, 24, 512
# the 32-px family: the small recognizer trunk, generator and
# discriminator, the "32" perceptual encoder, paper widths otherwise
GAN32_OVERRIDES = ["model.hwr.small=true", "model.generator.small=true",
                   "model.discriminator.small=true",
                   "trainer.encoder_type=32", "model.pretrained_hwr=",
                   "trainer.encoder_weights=", "data.text_data="]
NORM_LINES = 16                     # 64 x 1024 lines, card against CPU
NORM_ATOL = 1e-4


def small_epilogue_calls(dim=256, t=192):
    """(block, C, H, W, apply_blur) of the 32-px generator's 9 epilogue
    calls: blocks 0-3 as the paper generator's; block 4 does not upsample,
    so its first half is unblurred at 32 rows, and its second half is
    deferred into the final 1x1 conv."""
    shapes = block_shapes(dim, t)[:4] + [(dim // 16, 32, 2 * t)]
    calls = []
    for i, (c, h, w) in enumerate(shapes):
        calls.append((i, c, h, w, 0 < i < 4))
        if i < 4:
            calls.append((i, c, h, w, False))
    return calls


def epilogue_row(torch, ge, tt, name, calls, b, dtype, launches, card,
                 max_err=0.0):
    """The kernel against its plain version at each call of a forward
    (batch ``b``, a conv bias), their CUDA-event times, byte bounds and
    the kernel's plan, summed into one entry of the kernels line (its
    ``max_abs_err`` at least ``max_err``, earlier checks' error)."""
    dname = "bfloat16" if dtype == torch.bfloat16 else "float32"
    esize = 2 if dtype == torch.bfloat16 else 4
    k_ms = p_ms = b_ms = 0.0
    err = max_err
    bound_by = "bytes"
    for blk, c, h, w, blur in calls:
        args, bias = epilogue_inputs(torch, b, c, h, w, dtype, seed=blk)
        err = max(err, check_epilogue(
            torch, ge, args, blur, dname,
            f"{name}: block {blk} B={b} C={c} H={h} W={w}", bias=bias))
        t_k = tt.event_ms(lambda: ge.block_epilogue(
            *args, apply_blur=blur, bias=bias), iters=20)
        t_p = tt.event_ms(lambda: ge.block_epilogue_reference(
            *args, apply_blur=blur, bias=bias), iters=3, warmup=1)
        plan = ge.plan(args[0].shape, dtype, blur)
        n = b * h * w
        nbytes = (2 * n * c + n + 3 * c + 2 * b * c) * esize
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = n * c * OPS_PER_ELEM[blur] / F32_OPS_PER_S * 1e3
        if t_ops > t_bytes:
            bound_by = "operations"
        bound = max(t_bytes, t_ops)
        k_ms, p_ms, b_ms = k_ms + t_k, p_ms + t_p, b_ms + bound
        print(f"{name} block {blk} C={c} H={h} W={w} blur={blur} B={b} "
              f"{dname}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, bound "
              f"{bound:.4f} ms ({nbytes / 1e9:.3f} GB), kernel / bound "
              f"{t_k / bound:.2f}; y from {plan['y_from']} (cluster "
              f"{plan['cluster']}, {plan['pixels_per_rank']} pixels per "
              f"rank, {plan['threads']} threads, {plan['smem_bytes']} B "
              f"shared) {card}", flush=True)
        del args
    print(f"{name} per forward ({len(calls)} calls): kernel {k_ms:.4f} ms, "
          f"plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({bound_by}), "
          f"launches on its path {launches} {card}", flush=True)
    return {"name": name, "route": "cuda",
            "source": "handwriting_line_generation_tpu_torch/csrc/"
                      "gen_epilogue.cu",
            "replaces": "handwriting_line_generation_tpu/ops/"
                        "gen_epilogue.py:39",
            "launches": launches, "max_abs_err": err, "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": bound_by,
            "library_ms": None}


def jax_checkpoint_step(torch, np, ge, tt, card):
    """18.1: the committed JAX fixture (``model_best.msgpack``, written by
    the JAX package) through ``load_model``, rendered through the epilogue
    kernel on the fixture's spaced text, styles and noise, against the JAX
    render stored beside it; the decoder's rate.  Returns the kernels-line
    entry."""
    from handwriting_line_generation_tpu_torch.config import (
        apply_overrides, load_config,
    )
    from handwriting_line_generation_tpu_torch.inference.load import \
        load_model
    from handwriting_line_generation_tpu_torch.utils import msgpack
    data = (FIXTURE_DIR / "model_best.msgpack").read_bytes()
    t0 = time.perf_counter()
    for _ in range(DECODE_REPS):
        msgpack.restore(data)
    secs = (time.perf_counter() - t0) / DECODE_REPS
    fx = json.loads((FIXTURE_DIR / "fixture.json").read_text())
    cfg = apply_overrides(load_config(str(REPO / fx["config"])),
                          fx["overrides"])
    cfg.model.generator.fused_epilogue = True
    model, step = load_model(cfg, str(FIXTURE_DIR), "model_best",
                             device=DEVICE)
    z = np.load(FIXTURE_DIR / "render.npz")
    noise = [torch.from_numpy(z[f"noise{i}"]).to(DEVICE) for i in range(10)]
    spaced = torch.from_numpy(z["spaced"]).long().to(DEVICE)
    ge.block_epilogue.launches = 0
    with torch.no_grad():
        img = model.generate_spaced(
            spaced, torch.from_numpy(z["style"]).to(DEVICE), noise=noise)
        torch.cuda.synchronize()
    launches = ge.block_epilogue.launches
    err = float(np.abs(img.cpu().numpy() - z["image"]).max())
    print(f"JAX checkpoint {FIXTURE_DIR.name}/model_best.msgpack "
          f"({len(data)} B, step {step}): decoded at "
          f"{len(data) / secs / 1e6:.1f} MB/s (host); render "
          f"{tuple(img.shape)} through the epilogue kernel ({launches} "
          f"launches) against the JAX render: max abs {err:.3e} (bound "
          f"{JAX_RENDER_ATOL}, f32, TF32 off); the fixture holds "
          f"{'a' if model.hwr is not None else 'no'} recognizer "
          f"{card}", flush=True)
    if launches != 9 or not err <= JAX_RENDER_ATOL:
        raise AssertionError("the JAX checkpoint's render disagrees with "
                             "the JAX package's, or missed the kernel")
    B, T = z["spaced"].shape
    return epilogue_row(torch, ge, tt, f"gen_epilogue (JAX checkpoint "
                        f"render, B={B} T={T} float32)",
                        epilogue_calls(cfg.model.generator.dim, T), B,
                        torch.float32, launches, card)


def _kernel_split(torch, fn, steps):
    """Device ms a call of ``fn`` by group (conv: cuDNN convolutions;
    LSTM: cuDNN's recurrent kernels; matmul: the other GEMMs, the LSTMs'
    input projections and the dense layers; CTC; other), the idle share
    1 - busy / wall, and the five longest "other" kernels, over ``steps``
    profiled calls (CUDA activity only)."""
    from torch.profiler import ProfilerActivity, profile
    from handwriting_line_generation_tpu_torch.trace_forward import \
        _device_us
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    split = {"conv": 0.0, "LSTM": 0.0, "matmul": 0.0, "CTC": 0.0,
             "other": 0.0}
    other = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        low, ms = evt.key.lower(), _device_us(evt) / 1e3 / steps
        if "ctc_kernel" in low:
            split["CTC"] += ms
        elif "rnn" in low or "lstm" in low:
            split["LSTM"] += ms
        elif any(k in low for k in ("conv", "fprop", "dgrad", "wgrad",
                                    "implicit", "nhwc", "nchw")):
            split["conv"] += ms
        elif "gemm" in low or "xmma" in low or "cutlass" in low:
            split["matmul"] += ms
        else:
            split["other"] += ms
            other.append((ms, evt.key[:60]))
    busy = sum(split.values())
    if busy <= 0.0:
        raise AssertionError("the profile holds no device time")
    return split, wall, 1.0 - busy / wall, sorted(other, reverse=True)[:5]


def _hwr_config(load_config, kind):
    cfg = load_config(str(HWR_CONFIG))
    cfg.model.hwr.kind = kind
    return cfg


def crnn_step(torch, tt, F, ctc, HWRTrainer, load_config, card):
    """18.2: the CRNN at full width (hidden 512, 64 x 1024, B = 16, Adam
    1e-3, f32, TF32 off): 30 steps and an eval step through the CTC kernel,
    the loss falling; a step's gradients through the kernel against the
    plain CTC; the step's time and split; then SmallCRNN steps at H = 24.
    Returns the CTC rows of both paths."""
    cfg = _hwr_config(load_config, "crnn")
    tr = HWRTrainer(cfg, device=DEVICE)
    tr.init_state(seed=0)
    batch = tt.batch(seed=0, device=DEVICE)
    ctc.ctc_loss_cuda.launches = 0
    losses = [tr.train_step(*batch)[0] for _ in range(CRNN_STEPS)]
    eval_loss, logp = tr.eval_step(*batch)
    launches = ctc.ctc_loss_cuda.launches
    losses = torch.stack(losses).tolist()
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    print(f"CRNN ({type(tr.model).__name__}, hidden 512) losses "
          + " ".join(f"{v:.4f}" for v in losses)
          + f"; eval {eval_loss.item():.4f}; ctc launches {launches}",
          flush=True)
    if not all(math.isfinite(v) for v in losses) or not last < first \
            or launches != CRNN_STEPS + 1 \
            or tuple(logp.shape) != (tt.B, tt.W // 4, CTC_CLASSES):
        raise AssertionError("the CRNN did not train through the kernel")
    # one step's gradients, kernel against plain CTC, augmentation off
    cfg.data.augmentation = None
    ref = HWRTrainer(cfg, device=DEVICE)
    ref.init_state(seed=0)
    params = list(ref.model.parameters())
    loss_k, lp = ref.loss(*batch)
    g_k = torch.autograd.grad(loss_k, params, retain_graph=True)
    B, T, _ = lp.shape
    loss_p = ctc.ctc_loss(lp, batch[1], torch.full((B,), T, device=DEVICE),
                          batch[2])
    g_p = torch.autograd.grad(loss_p, params)
    worst = max(((a - b).abs().max() / b.abs().max()).item()
                for a, b in zip(g_k, g_p))
    print(f"CRNN step, kernel vs plain CTC: loss {loss_k.item():.6f} vs "
          f"{loss_p.item():.6f}; worst gradient max abs diff / max abs "
          f"{worst:.2e} (bound {TRAIN_GRAD_RTOL})", flush=True)
    if not worst <= TRAIN_GRAD_RTOL:
        raise AssertionError("the CRNN step through the kernel disagrees "
                             "with the plain CTC")
    del ref, g_k, g_p, lp
    step_ms = time_train(tt, tr, batch)
    split, wall, idle, other = _kernel_split(
        torch, lambda: tr.train_step(*batch), 3)
    print(f"CRNN train step (B={tt.B}, 64x{tt.W}, f32, TF32 off): "
          f"{step_ms:.3f} ms, {tt.B * 1000.0 / step_ms:.1f} trained lines/s;"
          f" profiled wall {wall:.3f} ms a step, device ms "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
          + f", idle {idle:.3f}; LSTM share of device time "
          f"{split['LSTM'] / sum(split.values()):.3f}; longest other "
          f"kernels (ms) {[(round(m, 3), k) for m, k in other]} {card}",
          flush=True)
    err = check_ctc(torch, ctc, tt.W // 4, tt.L, seed=181)
    times = time_ctc(torch, tt, F, ctc, tt.W // 4, tt.L, card)
    rows = [("CRNN training", (tt.B, tt.W // 4, tt.L), launches, err,
             times)]
    del tr

    # SmallCRNN: H = 24 bands of the same lines, 512 px wide
    cfg = _hwr_config(load_config, "small_crnn")
    tr = HWRTrainer(cfg, device=DEVICE)
    tr.init_state(seed=0)
    lo = 32 - SMALL_CRNN_H // 2
    image, label, lens, width = batch
    small = [image[:, lo:lo + SMALL_CRNN_H, :SMALL_CRNN_W].contiguous(),
             label, lens, torch.clamp(width, max=SMALL_CRNN_W)]
    ctc.ctc_loss_cuda.launches = 0
    losses = [tr.train_step(*small)[0].item()
              for _ in range(SMALL_CRNN_STEPS)]
    s_launches = ctc.ctc_loss_cuda.launches
    T = SMALL_CRNN_W // 4
    print(f"SmallCRNN (H={SMALL_CRNN_H}, 64->24-row bands, W="
          f"{SMALL_CRNN_W}, T={T}) losses "
          + " ".join(f"{v:.4f}" for v in losses)
          + f"; ctc launches {s_launches}", flush=True)
    if not all(math.isfinite(v) for v in losses) or not losses[0] > 0 \
            or s_launches != SMALL_CRNN_STEPS:
        raise AssertionError("SmallCRNN did not step through the kernel")
    err = check_ctc(torch, ctc, T, tt.L, seed=182)
    rows.append(("SmallCRNN training", (tt.B, T, tt.L), s_launches, err,
                 time_ctc(torch, tt, F, ctc, T, tt.L, card)))
    return rows


def _session(torch, cfg, n, seed=0):
    """A bf16 generation session of ``cfg`` (seeded weights, conv biases)
    and ``n`` copies of ``bench.TEXT`` with seeded styles."""
    from handwriting_line_generation_tpu_torch import bench
    from handwriting_line_generation_tpu_torch.charset import IAM_CHARSET
    from handwriting_line_generation_tpu_torch.inference.generate import (
        GenerationSession, cast_params_bf16,
    )
    from handwriting_line_generation_tpu_torch.init import (
        init_model, seed_conv_biases,
    )
    model = init_model(cfg, seed)
    seed_conv_biases(model.generator, seed=1)
    if cfg.compute_dtype == "bfloat16":
        cast_params_bf16(model)
    session = GenerationSession(model, IAM_CHARSET, device=DEVICE)
    labels, lens = session.encode_texts([bench.TEXT] * n)
    styles = torch.randn((n, bench.STYLE_DIM), device=DEVICE,
                         generator=torch.Generator(DEVICE).manual_seed(7))
    return session, labels, lens, styles


def _render(torch, ge, session, labels, lens, styles, fused):
    from handwriting_line_generation_tpu_torch import bench
    session.model.generator.fused_epilogue = fused
    ge.block_epilogue.launches = 0
    img, _ = session.forward(labels, lens, styles,
                             spaced_len=bench.SPACED_LEN, seed=0)
    torch.cuda.synchronize()
    return img, ge.block_epilogue.launches


def gan32_step(torch, np, tt, F, ctc, ge, load_config, card):
    """18.3: the 32-px family at the paper's widths: a 512-line bf16
    render through the epilogue kernel (9 launches, 32 rows, 2T columns),
    against the plain path, each call against its plain version; then the
    GAN's paper cycle on the 32-px config at B = 4 through the CTC kernel.
    Returns (the epilogue entry, the CTC row)."""
    from handwriting_line_generation_tpu_torch import bench
    from handwriting_line_generation_tpu_torch import trace_gan as tg
    from handwriting_line_generation_tpu_torch.config import apply_overrides
    from handwriting_line_generation_tpu_torch.training.gan_trainer import \
        GanTrainer
    cfg = bench.paper_config()
    cfg.generator.small = True
    session, labels, lens, styles = _session(torch, cfg, MAIN_BATCH)
    img, launches = _render(torch, ge, session, labels, lens, styles, True)
    plain, _ = _render(torch, ge, session, labels, lens, styles, False)
    session.model.generator.fused_epilogue = True
    want = (MAIN_BATCH, 32, 2 * bench.SPACED_LEN, 1)
    mad = (img - plain).abs().mean().item()
    ms = bench.time_forward(session, labels, lens, styles, iters=10)
    print(f"32-px generator (small, dim 256, bf16): render "
          f"{tuple(img.shape)}, {launches} epilogue launches; kernel vs "
          f"plain path mean abs {mad:.3e} (bound {BF16_MEAN_ABS_BOUND}); "
          f"forward {ms:.3f} ms per {MAIN_BATCH} lines, "
          f"{MAIN_BATCH * 1000.0 / ms:.1f} lines/s {card}", flush=True)
    if launches != 9 or tuple(img.shape) != want \
            or not torch.isfinite(img).all() or not mad <= \
            BF16_MEAN_ABS_BOUND:
        raise AssertionError("the 32-px render failed its checks")
    del session, img, plain
    row = epilogue_row(torch, ge, tt, f"gen_epilogue (32-px generator, "
                       f"B={MAIN_BATCH} bf16)",
                       small_epilogue_calls(t=bench.SPACED_LEN),
                       MAIN_BATCH, torch.bfloat16, launches, card)

    # the GAN's paper cycle on the 32-px config, f32, TF32 off
    gcfg = apply_overrides(load_config(str(tg.CONFIG)), GAN32_OVERRIDES)
    tr = GanTrainer(gcfg, device=DEVICE)
    tr.init_state(0)
    data = tg.batch(DEVICE)
    data = dict(data, image=data["image"][:, ::2, ::2].contiguous(),
                width=(data["width"] + 1) // 2,
                fg_mask=data["fg_mask"][:, ::2, ::2].contiguous())
    blocked, ran = [], []
    ctc.ctc_loss_cuda.launches = 0
    n = len(tr.curriculum.stages[0][1])
    for i in range(n):
        lesson = tr.curriculum.get_lesson(i)
        if "count" in lesson or "auto" in lesson:
            blocked.append("+".join(lesson))   # need the char style encoder
            continue
        out = tr.run_lesson(lesson, itertools.repeat(data), iteration=i)
        ran.append(("+".join(lesson), {k: float(v) for k, v in out.items()}))
    torch.cuda.synchronize()
    g_launches = ctc.ctc_loss_cuda.launches
    print(f"32-px GAN cycle (B=4, small recognizer/generator/discriminator,"
          f" '32' encoder, f32): ran {ran}; not run at 32 rows in either "
          f"package (the char style encoder's trunk needs 64): {blocked}; "
          f"ctc launches {g_launches}", flush=True)
    gen = sum("gen" in name for name, _ in ran)
    if g_launches != gen or not all(math.isfinite(v) for _, o in ran
                                    for v in o.values()):
        raise AssertionError("the 32-px GAN lessons failed")
    gen_t = min(gcfg.model.max_gen_length, 6 * max(gcfg.data.label_buckets))
    L = max(gcfg.data.label_buckets)
    err = check_ctc(torch, ctc, gen_t, L, seed=183, batch=tg.B)
    times = time_ctc(torch, tt, F, ctc, gen_t, L, card, batch=tg.B)
    return row, ("32-px GAN genRecog", (tg.B, gen_t, L), g_launches, err,
                 times)


def _set_phase(model, on: bool) -> None:
    """Switch the generator's vertical blocks between the phase-decomposed
    and the sequential upsample conv (the same weights serve both)."""
    for blk in model.generator.blocks:
        blk.phase_upsample = on


def phase_upsample_step(torch, tt, ge, card):
    """18.4: ``phase_upsample`` at the paper's width: a 512-line bf16 render
    through the epilogue kernel (9 launches), timed in turns against the
    sequential generator on the same weights, and a float32 forward (B =
    4) equal to the sequential one within ``F32_MAX_ABS_BOUND``.  Returns
    the epilogue entry."""
    from handwriting_line_generation_tpu_torch import bench
    cfg = bench.paper_config()
    cfg.generator.phase_upsample = True
    session, labels, lens, styles = _session(torch, cfg, MAIN_BATCH)
    _, launches = _render(torch, ge, session, labels, lens, styles, True)
    rates = {False: [], True: []}
    for phase in (False, True, True, False):
        _set_phase(session.model, phase)
        ms = bench.time_forward(session, labels, lens, styles, iters=10)
        rates[phase].append(round(MAIN_BATCH * 1000.0 / ms, 1))
    del session
    cfg.compute_dtype = "float32"
    session, labels, lens, styles = _session(torch, cfg, 4)
    outs = {}
    for phase in (False, True):
        _set_phase(session.model, phase)
        outs[phase], _ = _render(torch, ge, session, labels, lens, styles,
                                 True)
    e32 = (outs[True] - outs[False]).abs().max().item()
    print(f"phase_upsample (paper width, bf16, {MAIN_BATCH} lines): "
          f"{launches} epilogue launches; lines/s phase {rates[True]} "
          f"against sequential {rates[False]} (alternated); f32 forward "
          f"(B=4) phase vs sequential max abs {e32:.3e} (bound "
          f"{F32_MAX_ABS_BOUND}) {card}", flush=True)
    if launches != 9 or not e32 <= F32_MAX_ABS_BOUND:
        raise AssertionError("phase_upsample disagrees with the sequential "
                             "generator or missed the kernel")
    return epilogue_row(torch, ge, tt, f"gen_epilogue (phase_upsample, "
                        f"B={MAIN_BATCH} bf16)",
                        epilogue_calls(t=bench.SPACED_LEN), MAIN_BATCH,
                        torch.bfloat16, launches, card)


def normalization_step(torch, tt, card):
    """18.5: the "normalization" augmentation on a 64 x 1024 batch: the
    card against the CPU (the skeleton's pixels equal, the image within
    ``NORM_ATOL``), and its time on each."""
    from handwriting_line_generation_tpu_torch.ops.augment import (
        apply_augmentation, dequantize_image,
    )
    image, _, _, width = tt.batch(seed=5, device=DEVICE, n=NORM_LINES)
    x = dequantize_image(image, width)
    run = lambda t: apply_augmentation("normalization", t, None, None)[0]
    gpu = run(x)
    t0 = time.perf_counter()
    cpu = run(x.cpu())
    cpu_ms = (time.perf_counter() - t0) * 1e3
    gpu_ms = tt.event_ms(lambda: run(x), iters=3, warmup=1)
    err = (gpu.cpu() - cpu).abs().max().item()
    same = float(((gpu.cpu() > -1.0) == (cpu > -1.0)).float().mean())
    print(f"normalization augmentation ({NORM_LINES} x 64 x {tt.W}): card "
          f"{gpu_ms:.2f} ms, CPU {cpu_ms:.1f} ms; card vs CPU max abs "
          f"{err:.3e} (bound {NORM_ATOL}), stroke pixels agreeing "
          f"{same:.6f} {card}", flush=True)
    if not err <= NORM_ATOL or same != 1.0:
        raise AssertionError("the normalization on the card disagrees with "
                             "the CPU")


def variants_phase(torch, np, tt, F, ctc, ge, HWRTrainer, load_config,
                   card):
    """Phase 18; returns (epilogue entries, CTC rows)."""
    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    epi = [jax_checkpoint_step(torch, np, ge, tt, card)]
    ctc_rows = crnn_step(torch, tt, F, ctc, HWRTrainer, load_config, card)
    row, gan_row = gan32_step(torch, np, tt, F, ctc, ge, load_config, card)
    epi.append(row)
    ctc_rows.append(gan_row)
    epi.append(phase_upsample_step(torch, tt, ge, card))
    normalization_step(torch, tt, card)
    torch.cuda.empty_cache()
    print(f"phase 18: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return epi, ctc_rows


# phase 19: the plotting and dataset-dump CLIs, on numpy alone (no
# matplotlib, OpenCV or PIL): a style bank of the paper model and its
# thumbnails through the epilogue kernel, the style map, the training
# curves of phase 14's GAN run, the heatmap, and the dataset dumps with the
# augmentation on the card
THUMB_TEXT = "A MOVE to stop"
THUMB_T = 64                       # spaced positions: 64 x 256 thumbnails
PLOT_BANNED = ("matplotlib", "cv2", "PIL", "jax", "jaxlib", "flax",
               "handwriting_line_generation_tpu")
INSPECT_RUNS = {                   # config, overrides, batches
    "mini_iam": ("iam_gan_paper.json", [f"data.data_dir={CLI_FIXTURE}"], 2),
    "syn_hwr3": ("syn_hwr3.json", ["data.synthetic_authors=2",
                                   "data.synthetic_lines=8",
                                   "data.batch_size=8"], 1),
}


def check_style_map(np, path, data, thumbs=None):
    """A ``umap_styles`` PNG against the geometry it promises: 960 x 960;
    each dot's centre pixel (where no other dot, the legend or a thumbnail
    covers it) in ``TAB20[author index % 20]``; with ``thumbs`` (id ->
    u8 image), the last thumbnail drawn at its point, area-averaged to a
    quarter.  Returns how many dots it checked."""
    from handwriting_line_generation_tpu_torch.inference.styles import (
        STYLE_DOT_RADIUS, STYLE_MAP_PX, THUMB_ZOOM, umap_embed,
    )
    from handwriting_line_generation_tpu_torch.utils.colormap import TAB20
    from handwriting_line_generation_tpu_torch.utils.png import read_png_rgb
    from handwriting_line_generation_tpu_torch.utils.raster_plot import (
        Canvas, area_resize, data_limits,
    )
    img = read_png_rgb(path)
    if img.shape != (STYLE_MAP_PX, STYLE_MAP_PX, 3):
        raise AssertionError(f"{path}: shape {img.shape}")
    emb = umap_embed(data)
    authors = [str(a) for a in data["authors"]]
    uniq = sorted(set(authors))
    idx = np.searchsorted(uniq, authors)
    c = Canvas(STYLE_MAP_PX, STYLE_MAP_PX, data_limits(emb[:, 0]),
               data_limits(emb[:, 1]))
    px, py = c.transform(emb[:, 0], emb[:, 1])
    covered = np.zeros(img.shape[:2], bool)
    legend = None
    if len(uniq) <= 20:             # the legend's box, drawn last
        c0, r0, c1, r1 = c.legend([(a, TAB20[i % 20], "dot")
                                   for i, a in enumerate(uniq)],
                                  avoid=(px, py))
        legend = (r0, c0, r1, c1)
        covered[r0:r1 + 1, c0:c1 + 1] = True
    if thumbs:
        last = None
        for j, sid in enumerate(map(str, data["ids"])):
            if sid in thumbs:
                t = area_resize(thumbs[sid], THUMB_ZOOM)
                h, w = t.shape
                r0, c0 = py[j] - h // 2, px[j] - w // 2
                covered[max(r0, 0):r0 + h, max(c0, 0):c0 + w] = True
                last = (r0, c0, t)
        r0, c0, t = last
        h, w = t.shape
        clear = legend is None or (r0 > legend[2] or r0 + h <= legend[0]
                                   or c0 > legend[3] or c0 + w <= legend[1])
        if 0 <= r0 and r0 + h <= img.shape[0] and 0 <= c0 \
                and c0 + w <= img.shape[1] and clear:
            if not (img[r0:r0 + h, c0:c0 + w] == t[..., None]).all():
                raise AssertionError("the last thumbnail is not at its "
                                     "point")
    near = 2 * STYLE_DOT_RADIUS + 2
    checked = 0
    for j in range(len(px)):
        d = np.hypot(px - px[j], py - py[j])
        d[j] = np.inf
        if d.min() <= near or covered[py[j], px[j]]:
            continue
        want = TAB20[idx[j] % 20]
        if not (img[py[j], px[j]] == want).all():
            raise AssertionError(f"dot {j} at {(px[j], py[j])}: "
                                 f"{img[py[j], px[j]]}, want {want}")
        checked += 1
    return checked


def check_curves(np, path, log_path):
    """A ``graph`` PNG: 1000 x 600, and every sample of every curve at its
    transformed pixel drawn (not the white background), but where the
    legend covers it."""
    from handwriting_line_generation_tpu_torch.utils.png import read_png_rgb
    from handwriting_line_generation_tpu_torch.utils.raster_plot import (
        Canvas, data_limits,
    )
    from handwriting_line_generation_tpu_torch.utils.train_log import \
        TrainLog
    img = read_png_rgb(path)
    if img.shape != (600, 1000, 3):
        raise AssertionError(f"{path}: shape {img.shape}")
    with tempfile.TemporaryDirectory() as work:
        curves = TrainLog.load(log_path).plot(str(pathlib.Path(work,
                                                               "p.png")))
    xs = [x for c in curves.values() for x in c[0]]
    ys = [y for c in curves.values() for y in c[1]]
    c = Canvas(1000, 600, data_limits(xs), data_limits(ys))
    px, py = c.transform(xs, ys)
    c0, r0, c1, r1 = c.legend([(k, v[2], "line") for k, v in curves.items()],
                              avoid=(px, py))
    clear = ~((px >= c0) & (px <= c1) & (py >= r0) & (py <= r1))
    blank = (img[py, px] == 255).all(-1) & clear
    if blank.any():
        raise AssertionError(f"{int(blank.sum())} of {len(xs)} curve "
                             "samples not drawn")
    return len(curves), int(clear.sum())


def plots_phase(torch, np, ge, tt, ts, card, gan_log):
    """Phase 19.  Returns the kernels-line entry of the thumbnails'
    epilogue."""
    from handwriting_line_generation_tpu_torch import (
        graph, inspect_dataset, play_styles, umap_styles,
    )
    from handwriting_line_generation_tpu_torch.charset import IAM_CHARSET
    from handwriting_line_generation_tpu_torch.inference.generate import (
        GenerationSession, to_uint8,
    )
    from handwriting_line_generation_tpu_torch.inference.styles import (
        StyleExtractor, load_styles, save_styles,
    )
    from handwriting_line_generation_tpu_torch.utils.colormap import VIRIDIS
    from handwriting_line_generation_tpu_torch.utils.png import (
        read_png_gray, read_png_rgb, write_png_gray,
    )
    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    work = tempfile.TemporaryDirectory()
    root = pathlib.Path(work.name)
    secs = {}

    # the bank and its thumbnails through the epilogue kernel
    model = ts.paper_model(DEVICE)
    t0 = time.perf_counter()
    bank = StyleExtractor(model, device=DEVICE).extract_dataset(
        _Fixed(_eval_batches(np, tt)))
    secs["style bank"] = time.perf_counter() - t0
    bank_path = str(root / "bank.npz")
    save_styles(bank_path, bank)
    n = len(bank["ids"])
    session = GenerationSession(model, IAM_CHARSET, device=DEVICE)
    ge.block_epilogue.launches = 0
    t0 = time.perf_counter()
    imgs = session.render([THUMB_TEXT] * n, bank["styles"], seed=0,
                          spaced_len=THUMB_T)
    secs["thumbnails"] = time.perf_counter() - t0
    launches = ge.block_epilogue.launches
    if launches != 9 or imgs.shape != (n, 64, 4 * THUMB_T, 1) \
            or not np.isfinite(imgs).all():
        raise AssertionError(f"thumbnails: {launches} launches, shape "
                             f"{imgs.shape}")
    thumbs = {}
    (root / "thumbs").mkdir()
    for sid, im in zip(map(str, bank["ids"]), imgs):
        thumbs[sid] = to_uint8(im)
        write_png_gray(str(root / "thumbs" / f"{sid}.png"), thumbs[sid])
    row = epilogue_row(torch, ge, tt, f"gen_epilogue (thumbnails, B={n} "
                       f"T={THUMB_T} float32)", epilogue_calls(t=THUMB_T),
                       n, torch.float32, launches, card)
    del model, session
    torch.cuda.empty_cache()

    # the style map, with thumbnails and by author mean
    data = load_styles(bank_path)
    out, _, secs["umap_styles --thumbnails"] = _cli_call(
        torch, ge, umap_styles, [bank_path, "-o", str(root / "map.png"),
                                 "--thumbnails", str(root / "thumbs")])
    check_style_map(np, str(root / "map.png"), data, thumbs)
    out, _, secs["umap_styles"] = _cli_call(
        torch, ge, umap_styles, [bank_path, "-o", str(root / "dots.png")])
    dots = check_style_map(np, str(root / "dots.png"), data)
    if dots == 0:
        raise AssertionError("no style-map dot could be checked")

    # phase 14's GAN curves
    log_path = root / "train_log.json"
    log_path.write_text(gan_log)
    out, _, secs["graph --csv"] = _cli_call(
        torch, ge, graph, [str(log_path), "-o", str(root / "curves.png"),
                           "--csv", str(root / "log.csv")])
    n_keys, n_samples = check_curves(np, str(root / "curves.png"),
                                     str(log_path))
    header = (root / "log.csv").read_text().splitlines()[0].split(",")
    if "iteration" not in header or len(header) < n_keys + 1:
        raise AssertionError(f"log.csv header {header}")

    # the heatmap against LUT[d], recomputed
    heat = str(root / "heat.png")
    out, _, secs["play_styles --heatmap"] = _cli_call(
        torch, ge, play_styles, [bank_path, "--heatmap", heat,
                                 "--device", DEVICE])
    s = np.asarray(data["styles"], np.float32)
    s = s[np.argsort(np.asarray(data["authors"]), kind="stable")[:512]]
    d = np.linalg.norm(s[:, None] - s[None, :], axis=-1)
    d = (255 * d / max(d.max(), 1e-8)).astype(np.uint8)
    if not (read_png_rgb(heat) == VIRIDIS[d]).all():
        raise AssertionError("heatmap pixels differ from VIRIDIS[d]")

    # the dataset dumps, the augmentation on the card
    dumps = {}
    for name, (config, overrides, batches) in INSPECT_RUNS.items():
        cfg_path = root / f"{name}.json"
        cfg_path.write_text(json.dumps(_config(config, overrides).to_dict()))
        for rep in range(2 if name == "mini_iam" else 1):
            dump = root / f"dump_{name}_{rep}"
            out, _, t = _cli_call(torch, ge, inspect_dataset, [
                "-c", str(cfg_path), "-n", str(batches), "-o", str(dump),
                "--augment", "--device", DEVICE])
            secs[f"inspect_dataset --augment ({name}{', again' * rep})"] = t
        gts = (dump / "gt.txt").read_text().splitlines()
        for line in gts:
            stem = line.split("\t")[0]
            shapes = {kind: read_png_gray(str(dump / f"{stem}_{kind}.png"))
                      .shape for kind in ("line", "mask", "aug")}
            if len(set(shapes.values())) != 1 or shapes["line"][0] != 64:
                raise AssertionError(f"{name} {stem}: shapes {shapes}")
        dumps[name] = (len(gts), out.strip().splitlines()[-1])
    for f in (root / "dump_mini_iam_0").glob("*_aug.png"):
        if f.read_bytes() != (root / "dump_mini_iam_1" / f.name).read_bytes():
            raise AssertionError(f"{f.name} differs between two runs")

    bad = [m for m in sys.modules if m.split(".")[0] in PLOT_BANNED]
    if bad:
        raise AssertionError(f"banned modules imported: {bad}")
    work.cleanup()
    print(f"phase 19: style map of {n} styles ({dots} dots checked), "
          f"curves of {n_keys} keys ({n_samples} samples), heatmap "
          f"{d.shape[0]}x{d.shape[0]}, dumps "
          + ", ".join(f"{k} {v[0]} lines ({v[1]})" for k, v in dumps.items())
          + "; no matplotlib, cv2, PIL or JAX imported", flush=True)
    for k, v in secs.items():
        print(f"phase 19 {k}: {v:.3f} s {card}", flush=True)
    print(f"phase 19: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return row


# phase 20: bf16 mixed-precision training.  The three trainers with
# model.compute_dtype = "bfloat16" through the CTC kernel (parameters, Adam
# moments and the spectral norms' u's float32, log-probs into CTC float32),
# phase 14's float32 GAN run continued in bf16 beside its float32
# continuation, the bf16 checkpoint rendered through the epilogue kernel,
# and the step and cycle times by precision
BF16_CONT_LESSONS = 14             # lessons of each continuation
BF16_RENDER_LINES = 4


def _f32_state(torch, tensors, what):
    """Raise unless every tensor is float32; returns their number."""
    bad = [i for i, t in enumerate(tensors) if t.dtype != torch.float32]
    if bad or not tensors:
        raise AssertionError(f"{what}: {len(bad)} of {len(tensors)} tensors "
                             f"not float32")
    return len(tensors)


def _moments(opt):
    return [v for st in opt.state_dict()["state"].values()
            for k, v in st.items() if k.startswith("exp_avg")]


def _band_check(runs, step):
    """JAX's criterion for its bf16 continuation: each bf16 loss within
    the float32 continuation's min-max band widened by its own spread on
    both sides.  Returns the worst (distance outside the band / spread)
    (0 when every loss lies in the band)."""
    logs = {d: [e for e in entries if e["iteration"] > step]
            for d, entries in runs.items()}
    keys = sorted({k for e in logs["float32"] for k in e
                   if k.endswith("Loss")})
    worst = 0.0
    for k in keys:
        f32 = [e[k] for e in logs["float32"] if k in e]
        b16 = [e[k] for e in logs["bfloat16"] if k in e]
        lo, hi = min(f32), max(f32)
        spread = hi - lo
        out = max(max(lo - spread - v, v - hi - spread, 0.0) for v in b16)
        worst = max(worst, out / max(spread, 1e-30))
        print(f"  {k}: float32 {lo:.5g}..{hi:.5g} (spread {spread:.3g}), "
              f"bf16 {min(b16):.5g}..{max(b16):.5g} "
              f"{'in' if out == 0 else 'OUTSIDE'} the widened band",
              flush=True)
        if len(b16) != len(f32) or not all(map(math.isfinite, b16)):
            raise AssertionError(f"{k}: {len(b16)} bf16 entries for "
                                 f"{len(f32)}, or not finite")
    return worst


def bf16_continuation(torch, np, ge, ctc, tt, card, cli_root, work):
    """Phase 20 (d): phase 14's float32 ``iam_gan_paper`` run resumed by
    the train CLI with ``-r -a model.compute_dtype=bfloat16`` for
    ``BF16_CONT_LESSONS`` lessons, and from a copy of the same checkpoint
    in float32; the bf16 losses held to the float32 band; then the bf16
    checkpoint rendered by ``generate -m render`` through the epilogue
    kernel in bf16, against the plain path.  Returns (CTC launches of the
    bf16 continuation, the kernels-line entry of the render's epilogue)."""
    import shutil
    from handwriting_line_generation_tpu_torch import (
        generate, get_styles, train as cli,
    )
    from handwriting_line_generation_tpu_torch.utils.checkpoint import \
        load_meta
    src = cli_root / "iam_gan_paper"
    step = load_meta(str(src), "checkpoint-latest")["iteration"]
    fixture = [f"data.data_dir={CLI_FIXTURE}", "data.text_data="]
    overrides = fixture + [
        f"model.pretrained_hwr={cli_root}/iam_hwr/checkpoint-latest",
        f"trainer.encoder_weights={cli_root}/iam_auto_2tight/"
        "checkpoint-latest", "trainer.log_step=1", "trainer.val_step=0",
        f"trainer.save_step_minor={BF16_CONT_LESSONS}"]
    runs, launches = {}, {}
    for dtype in ("bfloat16", "float32"):
        dst = work / dtype / "iam_gan_paper"
        dst.mkdir(parents=True)
        for f in ("checkpoint-latest.pt", "checkpoint-latest.json",
                  "train_log.json"):
            shutil.copy(src / f, dst / f)
        n, secs, _ = _cli_run(torch, ctc, cli, "iam_gan_paper.json",
                              work / dtype, overrides + [
                                  f"model.compute_dtype={dtype}"],
                              "-r", "-i", str(step + BF16_CONT_LESSONS))
        runs[dtype] = json.loads((dst / "train_log.json").read_text())
        launches[dtype] = n
        meta = load_meta(str(dst), "checkpoint-latest")
        print(f"continuation in {dtype}: lessons {step + 1}.."
              f"{step + BF16_CONT_LESSONS}, {secs:.1f} s, checkpoint-latest "
              f"at {meta['iteration']}, ctc launches {n}", flush=True)
        if meta["iteration"] != step + BF16_CONT_LESSONS:
            raise AssertionError(f"the {dtype} continuation stopped early")
    print(f"bf16 continuation against the float32 one (JAX's criterion: "
          f"each bf16 loss within the float32 min-max band widened by its "
          f"spread) {card}:", flush=True)
    worst = _band_check(runs, step)
    due = 4 * BF16_CONT_LESSONS // 7
    if worst > 0 or set(launches.values()) != {due}:
        raise AssertionError(f"bf16 continuation: a loss outside its band "
                             f"({worst:.3f} spreads) or CTC launches "
                             f"{launches} where {due} were due")

    # the bf16 checkpoint rendered through the epilogue kernel, in bf16
    run16 = work / "bfloat16" / "iam_gan_paper"
    gen_ov = fixture + ["model.compute_dtype=bfloat16"]
    base = ["-c", str(REPO / "configs" / "iam_gan_paper.json"), "-k",
            str(run16), "--device", DEVICE]
    _cli_call(torch, ge, get_styles, base + _pairs(gen_ov)
              + ["-o", str(work / "bank")])
    bank = work / "bank" / f"train_styles_{step + BF16_CONT_LESSONS}.npz"
    images, seen = {}, []
    render_mode = generate.render_mode

    def kept(*a, **k):
        seen.append(render_mode(*a, **k))
        return seen[-1]
    for fused in (True, False):
        ov = gen_ov + [f"model.generator.fused_epilogue={str(fused).lower()}"]
        with mock.patch.object(generate, "render_mode", kept):
            _, n, secs = _cli_call(torch, ge, generate, base + [
                a for o in ov for a in ("--override", o)] + [
                "-m", "render", "-n", str(BF16_RENDER_LINES), "-s",
                str(bank), "-o", str(work / f"gen_{fused}")])
        images[fused] = (seen[-1], n, secs)
    (img, n, secs), (plain, n_plain, _) = images[True], images[False]
    mad = float(np.abs(img - plain).mean())
    print(f"generate -m render of the bf16 checkpoint, bf16: {img.shape}, "
          f"{secs:.2f} s, epilogue launches {n} (plain path {n_plain}); "
          f"kernel vs plain path mean abs diff {mad:.3e} (bound "
          f"{BF16_MEAN_ABS_BOUND}) {card}", flush=True)
    if n != 9 or n_plain != 0 or not np.isfinite(img).all() \
            or not mad <= BF16_MEAN_ABS_BOUND:
        raise AssertionError("the bf16 checkpoint's render through the "
                             "epilogue kernel")
    T = img.shape[2] // 4
    row = epilogue_row(torch, ge, tt, f"gen_epilogue (bf16 continuation's "
                       f"render, B={BF16_RENDER_LINES} T={T} bfloat16)",
                       epilogue_calls(t=T), BF16_RENDER_LINES,
                       torch.bfloat16, n, card)
    return launches["bfloat16"], row


def bf16_phase(torch, np, tt, F, ctc, ge, HWRTrainer, load_config, card,
               hwr_ckpt, auto_ckpt, cli_root):
    """Phase 20.  Returns (the CTC launches of each bf16 path, the
    kernels-line entry of the render's epilogue)."""
    from handwriting_line_generation_tpu_torch import trace_auto as ta
    from handwriting_line_generation_tpu_torch import trace_gan as tg
    t0 = time.perf_counter()
    tt.set_tf32(False)
    # (a) the recognizer
    hwr_n, tr, batch = train_main_path(torch, tt, ctc, HWRTrainer,
                                       load_config, dtype="bfloat16")
    check_train_grads(torch, ctc, HWRTrainer, load_config, batch,
                      dtype="bfloat16")
    n = _f32_state(torch, list(tr.model.parameters())
                   + _moments(tr.optimizer), "bf16 HWR trainer")
    print(f"bf16 HWR trainer: {n} parameters and moments float32", flush=True)
    del tr
    # (b) the autoencoder
    with tempfile.TemporaryDirectory() as d:
        auto_n, tr, batch = auto_main_path(torch, ctc, ta, load_config, d,
                                           dtype="bfloat16")
    check_auto_grads(torch, ctc, ta, batch, dtype="bfloat16")
    n = _f32_state(torch, list(tr.model.parameters())
                   + _moments(tr.optimizer), "bf16 autoencoder trainer")
    print(f"bf16 autoencoder trainer: {n} parameters and moments float32",
          flush=True)
    auto_data = _args(batch)
    del tr
    torch.cuda.empty_cache()
    # (c) two GAN cycles
    gan_n, tr, batches = gan_main_path(torch, ctc, tg, hwr_ckpt, auto_ckpt,
                                       dtype="bfloat16")
    check_gan_grads(torch, ctc, tr, next(batches), bf16=True)
    s = tr.state
    n = _f32_state(torch, list(s.params) + _moments(s.opt_main.optimizer)
                   + _moments(s.opt_disc.optimizer)
                   + [m.u for m in tr.model.discriminator.sn],
                   "bf16 GAN trainer")
    print(f"bf16 GAN trainer: {n} parameters, moments and u's float32",
          flush=True)
    del tr
    torch.cuda.empty_cache()
    # (d) phase 14's float32 run continued in bf16
    with tempfile.TemporaryDirectory() as d:
        cont_n, render_row = bf16_continuation(torch, np, ge, ctc, tt, card,
                                               cli_root, pathlib.Path(d))
    # (e) times by precision
    tt.precision_ms(tt.batch(seed=0, device=DEVICE), card)
    ta.precision_ms(auto_data, card)
    tg.precision_ms(batches, card, pretrained_hwr=hwr_ckpt,
                    encoder_weights=auto_ckpt)
    torch.cuda.empty_cache()
    print(f"phase 20 (bf16 training): {time.perf_counter() - t0:.1f} s",
          flush=True)
    return dict(hwr=hwr_n, auto=auto_n, gan=gan_n, cont=cont_n), render_row


# phase 21: the JAX package's last measurement tools on the card.
# mfu_report's FLOP and MFU accounting on the GAN cell (iam_gan_paper, B = 2
# x 2, 64 x 1024 over the mini-IAM fixture, seeded weights, f32 with TF32
# off) and its generation forward; trace_gen's per-block split, variant A/B
# and attribution on the bench configuration
MFU_CONFIG = REPO / "configs" / "iam_gan_paper.json"
MFU_OVERRIDES = [f"data.data_dir={CLI_FIXTURE}", "data.text_data=",
                 "model.pretrained_hwr=", "trainer.encoder_weights=",
                 "data.width_buckets=[1024]"]
MFU_ITERS = 14                     # two timed cycles, 14 timed auto lessons
MFU_FEW = 8                        # lines of a forward counted on both devices
TRACE_GEN_ITERS, TRACE_GEN_ROUNDS = 5, 3
# epilogue launches a block alone: two per styled block, one for the last
# (its second AdaIN folds into the head), none for the head
BLOCK_LAUNCHES = [2, 2, 2, 2, 1, 0]


def _gen_flops(torch, flops, session, label, n, spaced_len):
    """One forward of ``n`` copies of ``label`` counted: its FLOPs."""
    labels = label.repeat(n, 1)
    lens = torch.full((n,), label.shape[1], dtype=torch.long,
                      device=labels.device)
    styles = torch.zeros((n, session.model.cfg.packed_style_dim()),
                         device=labels.device)
    with torch.no_grad():
        _, fl, _ = flops.count(session.forward, labels, lens, styles,
                               spaced_len=spaced_len, seed=0)
    return fl


def mfu_report_step(torch, np, tt, F, ctc, ge, card):
    """21.1: ``mfu_report`` on the GAN cell through both kernels; its FLOP
    counts held against the CPU's at the same config and shapes.  Returns
    the report and its kernels-line rows."""
    import copy
    from handwriting_line_generation_tpu_torch import flops
    from handwriting_line_generation_tpu_torch.inference.generate import \
        GenerationSession
    from handwriting_line_generation_tpu_torch.scripts import mfu_report as mr
    tt.set_tf32(False)
    ctc.ctc_loss_cuda.launches = 0
    ge.block_epilogue.launches = 0
    rep = mr.report(str(MFU_CONFIG), MFU_OVERRIDES, iters=MFU_ITERS,
                    gen_batch=MAIN_BATCH, device=DEVICE)
    n_ctc, n_epi = ctc.ctc_loss_cuda.launches, ge.block_epilogue.launches
    print("mfu_report (iam_gan_paper, B=2x2, 64x1024, f32, TF32 off): "
          + json.dumps(rep), flush=True)
    cycles = MFU_ITERS // 7
    # the counted auto lesson, a warm-up and the timed cycles (genRecog and
    # reconRecog twice a cycle), a warm-up and the timed auto lessons; the
    # counted forward, a warm-up and the timed ones
    due_ctc = 1 + 4 * (1 + cycles) + 1 + MFU_ITERS
    due_epi = 9 * (2 + max(MFU_ITERS // 2, 3))
    # the same counts on the CPU: the auto lesson at the cell's shapes, a
    # forward of MFU_FEW lines on both devices, and the card's 512 lines as
    # 512 / MFU_FEW of its MFU_FEW
    tr, it = mr.trainer(str(MFU_CONFIG), MFU_OVERRIDES, device="cpu")
    batch = next(it)
    _, cpu_auto, _ = flops.count(tr.step_auto, *mr.auto_args(tr, batch,
                                                             False))
    cpu = mr.generation_session(tr)
    on_card = GenerationSession(copy.deepcopy(cpu.model), cpu.charset,
                                device=DEVICE)
    label = torch.as_tensor(batch["label"][:1]).long()
    few_cpu = _gen_flops(torch, flops, cpu, label, MFU_FEW,
                         tr.gen_spaced_len)
    few = _gen_flops(torch, flops, on_card, label.to(DEVICE), MFU_FEW,
                     tr.gen_spaced_len)
    del tr, cpu, on_card
    torch.cuda.empty_cache()
    card_auto = rep["auto_step_gflops"] * 1e9
    card_gen = rep["gen_step_gflops"] * 1e9
    print(f"mfu_report FLOPs card against CPU: auto lesson {card_auto:.0f} "
          f"/ {cpu_auto:.0f}; forward of {MFU_FEW} lines {few:.0f} / "
          f"{few_cpu:.0f}; {MAIN_BATCH} lines {card_gen:.0f} = "
          f"{MAIN_BATCH // MFU_FEW} x {few:.0f}; CTC launches {n_ctc} "
          f"(due {due_ctc}), epilogue {n_epi} (due {due_epi}) {card}",
          flush=True)
    if (card_auto != cpu_auto or few != few_cpu
            or card_gen != MAIN_BATCH // MFU_FEW * few):
        raise AssertionError("a FLOP count differs between the card and "
                             "the CPU")
    if (rep["ctc_launches_per_auto_lesson"] != 1
            or rep["gen_epilogue_launches_per_forward"] != 9
            or n_ctc != due_ctc or n_epi != due_epi):
        raise AssertionError("mfu_report's paths missed a kernel")
    for k in ("auto_mfu", "gen_mfu"):
        if not 0 < rep[k] <= 1:
            raise AssertionError(f"mfu_report {k} {rep[k]} outside (0, 1]")
    B, T, L = rep["batch"], rep["image_w"] // 4, rep["label_len"]
    err = check_ctc(torch, ctc, T, L, seed=T + L, batch=B)
    rows = [{"name": f"ctc (mfu_report auto lesson and cycles, B={B} T={T} "
                     f"L={L})", "route": "cuda",
             "source": "handwriting_line_generation_tpu_torch/csrc/ctc.cu",
             "replaces": "handwriting_line_generation_tpu/ops/"
                         "ctc_pallas.py:60",
             "launches": n_ctc, "max_abs_err": err,
             **{k: v for k, v in time_ctc(torch, tt, F, ctc, T, L, card,
                                          batch=B).items()
                if k in ("ms", "plain_ms", "bound_ms", "bound_by",
                         "library_ms")}},
            epilogue_row(torch, ge, tt, f"gen_epilogue (mfu_report "
                         f"generation, B={MAIN_BATCH} T={rep['gen_spaced_len']}"
                         f" bf16)", epilogue_calls(t=rep["gen_spaced_len"]),
                         MAIN_BATCH, torch.bfloat16, n_epi, card)]
    return rep, rows


def trace_gen_step(torch, tt, ge, card):
    """21.2: ``trace_gen``'s per-block split, variant A/B and attribution
    on the bench session, each block's and arm's epilogue launches
    counted, the A/B renders held against the baseline's.  Returns the
    three tables and the kernels-line row."""
    from handwriting_line_generation_tpu_torch import bench, trace_gen
    session, labels, lens, styles = bench.build(MAIN_BATCH, device=DEVICE)
    ge.block_epilogue.launches = 0
    out = {}
    for what, fn in (("blocks", trace_gen.blocks), ("ab", trace_gen.ab),
                     ("attribution", trace_gen.attribution)):
        out[what] = fn(session, labels, lens, styles, TRACE_GEN_ITERS,
                       TRACE_GEN_ROUNDS)
        print(f"trace_gen {what} (bench, B={MAIN_BATCH}, bf16): "
              f"{json.dumps(out[what])} {card}", flush=True)
    launches = ge.block_epilogue.launches
    names = list(trace_gen.BLOCK_NAMES) + ["head_equal_conv_tanh"]
    got = [out["blocks"][n]["epilogue_launches"] for n in names]
    ab_ok = all(v["epilogue_launches"] == (9 if "fused" in k else 0)
                and v["mean_abs_vs_baseline"] <= BF16_MEAN_ABS_BOUND
                for k, v in out["ab"].items())
    att = out["attribution"]["epilogue_launches"]
    att_ok = all(n == (0 if k == "noise_draws" else 9)
                 for k, n in att.items())
    print(f"trace_gen: block launches {got} (due {BLOCK_LAUNCHES}); A/B "
          f"renders against the baseline's mean abs "
          f"{ {k: v['mean_abs_vs_baseline'] for k, v in out['ab'].items()} }"
          f" (bound {BF16_MEAN_ABS_BOUND}); attribution launches {att}; "
          f"{launches} launches in all {card}", flush=True)
    if got != BLOCK_LAUNCHES or not ab_ok or not att_ok:
        raise AssertionError("trace_gen missed the kernel or an exact "
                             "variant's render disagrees")
    del session
    torch.cuda.empty_cache()
    row = epilogue_row(torch, ge, tt, f"gen_epilogue (trace_gen blocks, A/B "
                       f"and attribution, B={MAIN_BATCH} bf16)",
                       epilogue_calls(t=bench.SPACED_LEN), MAIN_BATCH,
                       torch.bfloat16, launches, card)
    return out, row


def mfu_phase(torch, np, tt, F, ctc, ge, card):
    """Phase 21.  Returns its kernels-line rows."""
    t0 = time.perf_counter()
    rep, rows = mfu_report_step(torch, np, tt, F, ctc, ge, card)
    print(f"phase 21 MFU (datasheet peaks, {rep['peak_precision']} "
          f"{rep['peak_tflops']} TFLOP/s, bf16 {rep['gen_peak_tflops']}): "
          f"auto lesson {rep['auto_step_gflops']:.1f} GFLOP in "
          f"{rep['auto_sec_per_step'] * 1e3:.3f} ms, "
          f"{rep['auto_achieved_tflops']:.3f} TFLOP/s, MFU "
          f"{rep['auto_mfu']:.4f}; {rep['lessons_per_sec']:.2f} lessons/s; "
          f"generation {rep['gen_step_gflops']:.1f} GFLOP, "
          f"{rep['gen_bytes_accessed_gb']:.2f} GB unfused, "
          f"{rep['gen_sec_per_batch'] * 1e3:.3f} ms, "
          f"{rep['gen_lines_per_sec']:.1f} lines/s, "
          f"{rep['gen_achieved_tflops']:.3f} TFLOP/s, MFU "
          f"{rep['gen_mfu']:.4f} {card}", flush=True)
    _, row = trace_gen_step(torch, tt, ge, card)
    print(f"phase 21: {time.perf_counter() - t0:.1f} s", flush=True)
    return rows + [row]


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    import numpy as np
    import torch.nn.functional as F
    from handwriting_line_generation_tpu_torch import bench, kernels
    from handwriting_line_generation_tpu_torch import trace_train as tt
    from handwriting_line_generation_tpu_torch.config import load_config
    from handwriting_line_generation_tpu_torch.inference.generate import (
        GenerationSession,
    )
    from handwriting_line_generation_tpu_torch import trace_auto as ta
    from handwriting_line_generation_tpu_torch import trace_style as ts
    from handwriting_line_generation_tpu_torch.init import (
        init_model, seed_conv_biases,
    )
    from handwriting_line_generation_tpu_torch.ops import ctc
    from handwriting_line_generation_tpu_torch.ops import gen_epilogue as ge
    from handwriting_line_generation_tpu_torch.training.hwr_trainer import \
        HWRTrainer
    from handwriting_line_generation_tpu_torch.utils.checkpoint import \
        save_checkpoint

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0].strip()
    card = f"[{smi}]"
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    for name, secs, log in kernels.build():
        print(f"built {name}.cu in {secs:.1f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())
    print(f"build phase {time.perf_counter() - t0:.1f} s", flush=True)

    # 3. kernels vs plain, at B = CHECK_BATCH
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    max_err = 0.0
    cases = sorted({(c, h, w, blur) for _, c, h, w, blur in epilogue_calls()},
                   reverse=True)
    for dname in TOLERANCE:
        for c, h, w, blur in cases:
            args, bias = epilogue_inputs(torch, CHECK_BATCH, c, h, w,
                                         getattr(torch, dname),
                                         seed=c + h + int(blur))
            for b in (None, bias):
                max_err = max(max_err, check_epilogue(
                    torch, ge, args, blur, dname,
                    f"B={CHECK_BATCH} C={c} H={h} W={w}", bias=b))

    # 4. main path: paper width, bf16, fused epilogue, 512 lines
    session, labels, lens, styles = bench.build(MAIN_BATCH)
    seed_conv_biases(session.model.generator, seed=1)
    texts = [bench.TEXT] * MAIN_BATCH
    styles_np = styles.cpu().numpy()
    ge.block_epilogue.launches = 0
    img = session.render(texts, styles_np, seed=0,
                         spaced_len=bench.SPACED_LEN)
    launches = ge.block_epilogue.launches
    print(f"main path: render {img.shape}, gen_epilogue launches "
          f"{launches}", flush=True)
    if launches != 9:
        raise AssertionError(f"expected 9 gen_epilogue launches per forward, "
                             f"got {launches}")
    if img.shape != (MAIN_BATCH, 64, 4 * bench.SPACED_LEN, 1):
        raise AssertionError(f"bad output shape {img.shape}")
    if not np.isfinite(img).all() or np.abs(img).max() > 1.0:
        raise AssertionError("output not finite or outside [-1, 1]")
    # the same render through the plain sequential path, same noise draws
    session.model.generator.fused_epilogue = False
    plain = session.render(texts, styles_np, seed=0,
                           spaced_len=bench.SPACED_LEN)
    session.model.generator.fused_epilogue = True
    mad = float(np.abs(img - plain).mean())
    print(f"main path bf16, non-zero conv biases, kernel vs plain path: "
          f"mean abs diff {mad:.3e} "
          f"(bound {BF16_MEAN_ABS_BOUND}), max {np.abs(img - plain).max():.3e}")
    if not mad <= BF16_MEAN_ABS_BOUND:
        raise AssertionError("bf16 render disagrees with the plain path")
    cfg32 = bench.paper_config()
    cfg32.compute_dtype = "float32"
    s32 = GenerationSession(init_model(cfg32, seed=0), session.charset,
                            device=DEVICE)
    seed_conv_biases(s32.model.generator, seed=1)
    few = slice(0, 4)
    outs = []
    for fused in (True, False):
        s32.model.generator.fused_epilogue = fused
        out, _ = s32.forward(labels[few], lens[few], styles[few],
                             spaced_len=bench.SPACED_LEN, seed=0)
        outs.append(out)
    e32 = (outs[0] - outs[1]).abs().max().item()
    print(f"f32 forward (B=4), non-zero conv biases, kernel vs plain path: "
          f"max abs diff {e32:.3e} "
          f"(bound {F32_MAX_ABS_BOUND})", flush=True)
    if not e32 <= F32_MAX_ABS_BOUND:
        raise AssertionError("f32 forward disagrees with the plain path")
    del s32, outs, plain

    # 5. timing
    ms = bench.time_forward(session, labels, lens, styles, iters=10)
    print(f"forward {ms:.3f} ms per {MAIN_BATCH} lines: "
          f"{MAIN_BATCH * 1000.0 / ms:.1f} lines/s {card}", flush=True)
    main_row = epilogue_row(torch, ge, tt, "gen_epilogue",
                            epilogue_calls(), MAIN_BATCH, torch.bfloat16,
                            launches, card, max_err)

    # 6. CTC kernel vs plain (TF32 still off)
    ctc_err = 0.0
    for T, L in CTC_BUCKETS + [CTC_IMPOSSIBLE_BUCKET]:
        ctc_err = max(ctc_err, check_ctc(torch, ctc, T, L, seed=T + L))

    # 7. main path: HWR training through the kernel
    del session
    torch.cuda.empty_cache()
    ctc_launches, trainer, batch = train_main_path(
        torch, tt, ctc, HWRTrainer, load_config)
    check_train_grads(torch, ctc, HWRTrainer, load_config, batch)

    # 8. timing: training and the CTC kernel
    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        step_ms = time_train(tt, trainer, batch)
        print(f"train step (iam_hwr, B={tt.B}, 64x{tt.W}, "
              f"f32, TF32 {'on' if tf32 else 'off'}): {step_ms:.3f} ms, "
              f"{tt.B * 1000.0 / step_ms:.1f} trained lines/s {card}",
              flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # the recognizer the GAN phase loads: phase 7's trainer, saved
    ckpts = tempfile.TemporaryDirectory()
    hwr_ckpt = pathlib.Path(ckpts.name, "hwr", "checkpoint-latest")
    save_checkpoint(str(hwr_ckpt.parent), hwr_ckpt.name,
                    trainer.state_dict())
    del trainer
    ctc_times = [time_ctc(torch, tt, F, ctc, T, L, card)
                 for T, L in CTC_BUCKETS]
    main_t = ctc_times[CTC_MAIN]

    # 9. main path: style extraction and autoencode on the paper model
    style_main_path(torch, np, ge, ts, card)

    # 10. main path: autoencoder pretraining through the CTC kernel at
    # T = W/8 (leaves TF32 off)
    auto_dir = pathlib.Path(ckpts.name, "auto")
    auto_launches, auto_err, auto_t = auto_phase(torch, tt, F, ctc, ta,
                                                 load_config, card,
                                                 str(auto_dir))

    # 11. main path: GAN training through the CTC kernel at its buckets
    auto_ckpt = auto_dir / load_config(str(AUTO_CONFIG)).name \
        / "checkpoint-latest"
    gan_launches, gan_err, gan_t = gan_phase(torch, tt, F, ctc, card,
                                             str(hwr_ckpt), str(auto_ckpt))

    # 12. main path: the GAN's training run (GanTrainer.train) through the
    # CTC kernel at the same buckets
    run_launches = gan_train_phase(torch, ctc, card, str(hwr_ckpt),
                                   str(auto_ckpt), ckpts.name)
    print(f"ctc launches on the main paths: HWR training {ctc_launches}, "
          f"autoencoder pretraining {auto_launches}, GAN training "
          f"{gan_launches}, GAN training run {run_launches}", flush=True)

    # 13. one CUDA launch per epilogue call, seen by the profiler, on a small
    # paper-width session
    small, s_labels, s_lens, s_styles = bench.build(CHECK_BATCH)
    cuda_launches = count_device_kernels(
        torch, "epilogue_kernel", lambda: small.forward(
            s_labels, s_lens, s_styles, spaced_len=bench.SPACED_LEN, seed=0))
    print(f"generation forward (B={CHECK_BATCH}): {cuda_launches} CUDA "
          f"kernel launches named epilogue_kernel (profiler)", flush=True)
    if cuda_launches != 9:
        raise AssertionError(f"expected one CUDA launch per epilogue call, "
                             f"9 per forward; got {cuda_launches}")
    del small

    # 14. training from a config: the port's train CLI over the mini-IAM
    # fixture and the synthetic corpus, each stage through the CTC kernel
    cli_rows = cli_phase(torch, tt, F, ctc, card,
                         pathlib.Path(ckpts.name, "cli"))

    # 15. inference from a checkpoint: the port's get_styles, generate and
    # evaluate CLIs on phase 14's GAN run through the epilogue kernel, the
    # kernel at the evaluation path's shapes, and the evaluation rates
    infer = infer_phase(torch, np, ge, tt, ts, card,
                        pathlib.Path(ckpts.name, "cli"))

    # 16. multi-process training on the one card: the train CLI under
    # torchrun (gloo ranks sharing it, a world of 1 on NCCL, --fsdp 2),
    # against one process, and the graft entry's dry run
    dist_rows = dist_phase(torch, tt, F, ctc, card,
                           pathlib.Path(ckpts.name, "dist"),
                           pathlib.Path(ckpts.name, "cli"))
    gan_log = pathlib.Path(ckpts.name, "cli", "iam_gan_paper",
                           "train_log.json").read_text()

    # 17. the synthetic pipeline: iam3 through the GAN and again (no step),
    # rimes3 through the spaced_loc cache, held against live alignment
    pipe_rows = pipeline_phase(torch, tt, F, ctc, card)

    # 18. every model variant and the JAX checkpoints: the committed JAX
    # fixture rendered through the epilogue kernel, the CRNN and SmallCRNN
    # through the CTC kernel, the 32-px family, phase_upsample and the
    # normalization augmentation
    var_epi, var_ctc = variants_phase(torch, np, tt, F, ctc, ge, HWRTrainer,
                                      load_config, card)

    # 19. the plotting and dataset-dump CLIs: a style bank's thumbnails
    # through the epilogue kernel, the style map, phase 14's GAN curves,
    # the heatmap and the dataset dumps, with no matplotlib or OpenCV
    plot_row = plots_phase(torch, np, ge, tt, ts, card, gan_log)

    # 20. bf16 mixed-precision training: the three trainers through the
    # CTC kernel, phase 14's GAN run continued in bf16 beside float32 and
    # its render through the epilogue kernel, the times by precision
    bf16_n, bf16_render = bf16_phase(
        torch, np, tt, F, ctc, ge, HWRTrainer, load_config, card,
        str(hwr_ckpt), str(auto_ckpt), pathlib.Path(ckpts.name, "cli"))
    ckpts.cleanup()

    # 21. the JAX package's last tools: mfu_report's FLOPs and MFU of the
    # GAN's auto lesson and of generation through both kernels, the counts
    # held against the CPU's; trace_gen's per-block split, variant A/B and
    # attribution through the epilogue kernel
    mfu_rows = mfu_phase(torch, np, tt, F, ctc, ge, card)

    # 22. summary
    print(smi)
    # the CTC kernel once per path that runs it: each entry's launches come
    # from that path's run, its times from that path's main bucket
    ctc_paths = [
        ("HWR training", (CTC_BATCH,) + CTC_BUCKETS[CTC_MAIN], ctc_launches,
         ctc_err, main_t),
        ("autoencoder pretraining", (ta.B,) + AUTO_CTC_BUCKETS[AUTO_CTC_MAIN],
         auto_launches, auto_err, auto_t),
        ("GAN training", (4,) + GAN_CTC_BUCKETS[0], gan_launches, gan_err,
         gan_t),
        ("GAN training run", (4,) + GAN_CTC_BUCKETS[0], run_launches,
         gan_err, gan_t)] + cli_rows + dist_rows + pipe_rows + [
        ("bf16 HWR training", (CTC_BATCH,) + CTC_BUCKETS[CTC_MAIN],
         bf16_n["hwr"], ctc_err, main_t),
        ("bf16 autoencoder pretraining",
         (ta.B,) + AUTO_CTC_BUCKETS[AUTO_CTC_MAIN], bf16_n["auto"], auto_err,
         auto_t),
        ("bf16 GAN training", (4,) + GAN_CTC_BUCKETS[0], bf16_n["gan"],
         gan_err, gan_t),
        ("bf16 GAN continuation through the CLI", (4,) + GAN_CTC_BUCKETS[0],
         bf16_n["cont"], gan_err, gan_t)]
    print(json.dumps({"kernels": [main_row, infer] + [{
        "name": f"ctc ({path}, B={b} T={t} L={lab})", "route": "cuda",
        "source": "handwriting_line_generation_tpu_torch/csrc/ctc.cu",
        "replaces": "handwriting_line_generation_tpu/ops/ctc_pallas.py:60",
        "launches": n, "max_abs_err": err, "ms": t_["ms"],
        "plain_ms": t_["plain_ms"], "bound_ms": t_["bound_ms"],
        "bound_by": t_["bound_by"], "library_ms": t_["library_ms"]}
        for path, (b, t, lab), n, err, t_ in ctc_paths + var_ctc]
        + var_epi + [plot_row, bf16_render] + mfu_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-run"]:
        sys.exit(rank_run(sys.argv[2:]))
    sys.exit(main())
