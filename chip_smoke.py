#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``handwriting_line_generation_tpu_torch``)
on one NVIDIA GPU.  Run from the repository root:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. device  — the card's name and power limit (``nvidia-smi``);
2. build   — every CUDA source of the port, compiled by ``nvcc``;
3. kernels — each kernel against its plain PyTorch version on the card, at
   the paper-width block shapes (B = 8), float32 (TF32 off) and bfloat16;
4. main path — ``GenerationSession.render`` of 512 lines at paper width
   (bf16, fused epilogue, seeded weights): shape, finiteness, range, the
   kernel's launch count, and agreement with the plain (sequential) path;
5. timing  — lines/s, and at each of the main path's kernel calls (its
   shapes, B = 512, bf16) the kernel checked against its plain version,
   then its time beside the plain version's and its bound (CUDA events);
6. summary — one JSON line of kernels, then the device line last.

Imports nothing of JAX.  Exits non-zero without a CUDA device.
"""

import json
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM memory rate
F32_OPS_PER_S = 67e12              # H100 SXM float32 outside tensor cores
# float operations per element of the epilogue: the separable blur (3 row
# sums of 4 ops, 1 column sum of 4, 1 rounding), noise (2), leaky_relu (2),
# statistics (3), normalize and affine (4)
OPS_PER_ELEM = {True: 28, False: 11}
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
    g = torch.Generator("cuda").manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=g, device="cuda")
    return ((rn(b, h, w, c) * 2.0).to(dtype), rn(b, h, w).to(dtype),
            (rn(c) * 0.3).to(dtype), (1.0 + 0.5 * rn(b, c)).to(dtype),
            rn(b, c).to(dtype))


def check_epilogue(torch, ge, args, blur, dname, label):
    """Kernel against its plain version on the same inputs; raises past
    ``TOLERANCE[dname]``.  Returns the max abs error."""
    tol = TOLERANCE[dname]
    got = ge.block_epilogue(*args, apply_blur=blur).float()
    want = ge.block_epilogue_reference(*args, apply_blur=blur).float()
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    ok = torch.allclose(got, want, **tol)
    print(f"gen_epilogue {dname} {label} blur={blur}: max_abs_err {err:.3e} "
          f"(atol {tol['atol']}, rtol {tol['rtol']}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("gen_epilogue disagrees with its plain version")
    return err


def event_ms(torch, fn, iters, warmup=2):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    import numpy as np
    from handwriting_line_generation_tpu_torch import bench, kernels
    from handwriting_line_generation_tpu_torch.inference.generate import (
        GenerationSession,
    )
    from handwriting_line_generation_tpu_torch.init import init_model
    from handwriting_line_generation_tpu_torch.ops import gen_epilogue as ge

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
            args = epilogue_inputs(torch, CHECK_BATCH, c, h, w,
                                   getattr(torch, dname),
                                   seed=c + h + int(blur))
            max_err = max(max_err, check_epilogue(
                torch, ge, args, blur, dname,
                f"B={CHECK_BATCH} C={c} H={h} W={w}"))

    # 4. main path: paper width, bf16, fused epilogue, 512 lines
    session, labels, lens, styles = bench.build(MAIN_BATCH)
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
    print(f"main path bf16 kernel vs plain path: mean abs diff {mad:.3e} "
          f"(bound {BF16_MEAN_ABS_BOUND}), max {np.abs(img - plain).max():.3e}")
    if not mad <= BF16_MEAN_ABS_BOUND:
        raise AssertionError("bf16 render disagrees with the plain path")
    cfg32 = bench.paper_config()
    cfg32.compute_dtype = "float32"
    s32 = GenerationSession(init_model(cfg32, seed=0), session.charset,
                            device="cuda")
    few = slice(0, 4)
    outs = []
    for fused in (True, False):
        s32.model.generator.fused_epilogue = fused
        out, _ = s32.forward(labels[few], lens[few], styles[few],
                             spaced_len=bench.SPACED_LEN, seed=0)
        outs.append(out)
    e32 = (outs[0] - outs[1]).abs().max().item()
    print(f"f32 forward (B=4) kernel vs plain path: max abs diff {e32:.3e} "
          f"(bound {F32_MAX_ABS_BOUND})", flush=True)
    if not e32 <= F32_MAX_ABS_BOUND:
        raise AssertionError("f32 forward disagrees with the plain path")
    del s32, outs, plain

    # 5. timing
    ms = bench.time_forward(session, labels, lens, styles, iters=10)
    print(f"forward {ms:.3f} ms per {MAIN_BATCH} lines: "
          f"{MAIN_BATCH * 1000.0 / ms:.1f} lines/s {card}", flush=True)
    k_ms = p_ms = b_ms = 0.0
    bound_by = "bytes"
    for blk, c, h, w, blur in epilogue_calls():
        args = epilogue_inputs(torch, MAIN_BATCH, c, h, w, torch.bfloat16,
                               seed=blk)
        max_err = max(max_err, check_epilogue(
            torch, ge, args, blur, "bfloat16",
            f"block {blk} B={MAIN_BATCH} C={c} H={h} W={w}"))
        t_k = event_ms(torch, lambda: ge.block_epilogue(
            *args, apply_blur=blur), iters=20)
        t_p = event_ms(torch, lambda: ge.block_epilogue_reference(
            *args, apply_blur=blur), iters=3, warmup=1)
        n = MAIN_BATCH * h * w
        nbytes = (2 * n * c + n + c + 2 * MAIN_BATCH * c) * 2
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = n * c * OPS_PER_ELEM[blur] / F32_OPS_PER_S * 1e3
        if t_ops > t_bytes:
            bound_by = "operations"
        bound = max(t_bytes, t_ops)
        k_ms, p_ms, b_ms = k_ms + t_k, p_ms + t_p, b_ms + bound
        print(f"gen_epilogue block {blk} C={c} H={h} W={w} blur={blur} "
              f"B={MAIN_BATCH} bf16: kernel {t_k:.4f} ms, plain {t_p:.4f} "
              f"ms, bound {bound:.4f} ms ({nbytes / 1e9:.3f} GB) {card}",
              flush=True)
        del args
    print(f"gen_epilogue per forward (9 calls): kernel {k_ms:.4f} ms, plain "
          f"{p_ms:.4f} ms, bound {b_ms:.4f} ms {card}")

    # 6. summary
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "gen_epilogue", "route": "cuda",
        "source": "handwriting_line_generation_tpu_torch/csrc/gen_epilogue.cu",
        "replaces": "handwriting_line_generation_tpu/ops/gen_epilogue.py:39",
        "launches": launches, "max_abs_err": max_err, "ms": k_ms,
        "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": bound_by,
        "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
