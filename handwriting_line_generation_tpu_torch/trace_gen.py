"""Where the paper-width generation forward's time goes, split three ways.

The port's counterpart of the repo-root ``scripts/profile_gen_blocks.py``,
``scripts/ab_gen_variants.py`` and ``scripts/profile_gen.py`` (which stay
JAX), on the bench configuration (:func:`paper_config`: num_class 80,
style_dim 128, gen dim 256, appended style, spacer dim 128 with
duplicates, no recognizer or discriminator, whole-network bfloat16, the
fused epilogue; seeded random weights; 512 copies of a 35-character line
at ``spaced_len`` 192, i.e. 64 x 768 px; the benchmark's
``gen_paper_b512`` cell runs the same model):

* ``blocks``: each ``StyledConvBlock`` of the generator trunk alone, on the
  input it receives in the forward (its epilogues through the kernel), and
  the head (the last block's deferred AdaIN folded into the 1x1 equal conv,
  then tanh), with each input's MB and the epilogue launches of each;
* ``ab``: ``phase_upsample`` off/on x ``fused_epilogue`` off/on on one set
  of weights (both variants are exact);
* ``attribution``: the forward and its ablations, which change the output
  and exist only to place the time: the generator alone on a precomputed
  spaced input (the rest is the spacer and ``insert_spaces``), the noise
  planes passed in instead of drawn (the difference is the draws), the
  blur passes dropped from the epilogue, both (the styled trunk), and the
  ten noise draws alone.  The shipped model does not change.

Each arm's time is the median over ``--rounds`` rounds, the arms in turn
within a round, of :func:`.profiling.event_ms` over ``--iters`` calls
after a warm-up (the host clock around the calls with ``--device cpu``).

    python -m handwriting_line_generation_tpu_torch.trace_gen \\
        [blocks|ab|attribution|all] [--batch 512] [--iters 10] \\
        [--rounds 3] [--device cuda]

Prints each table's lines, then one JSON line last.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from handwriting_line_generation_tpu_torch.charset import IAM_CHARSET
from handwriting_line_generation_tpu_torch.config import (
    DiscriminatorConfig, GeneratorConfig, HWRConfig, ModelConfig,
    SpacerConfig, StyleConfig,
)
from handwriting_line_generation_tpu_torch.inference.generate import (
    GenerationSession, cast_params_bf16,
)
from handwriting_line_generation_tpu_torch.init import init_model
from handwriting_line_generation_tpu_torch.models import generator as gen
from handwriting_line_generation_tpu_torch.ops import gen_epilogue, rows
from handwriting_line_generation_tpu_torch.ops.spacing import insert_spaces
from handwriting_line_generation_tpu_torch.profiling import event_ms

TEXT = "The quick brown fox jumps over dogs"      # 35 chars
SPACED_LEN = 192                                  # -> 64 x 768 px lines
STYLE_DIM = 128


def paper_config(fused_epilogue: bool = True) -> ModelConfig:
    """The paper-width generation model, bfloat16, fused epilogue."""
    return ModelConfig(
        num_class=80,
        style=StyleConfig(style_dim=STYLE_DIM, dim=64, char_dim=128,
                          window=2),
        generator=GeneratorConfig(dim=256, append_style=True,
                                  fused_epilogue=fused_epilogue),
        discriminator=DiscriminatorConfig(enabled=False),
        spacer=SpacerConfig(dim=128, count_duplicates=True),
        hwr=HWRConfig(kind="none"),
        compute_dtype="bfloat16",
    )


def build(batch: int = 512, device=None, seed: int = 0
          ) -> Tuple[GenerationSession, torch.Tensor, torch.Tensor,
                     torch.Tensor]:
    """Session on ``device`` (default cuda) with seeded bf16 weights, and
    ``(labels, lens, styles)`` for ``batch`` copies of :data:`TEXT`."""
    model = cast_params_bf16(init_model(paper_config(), seed))
    session = GenerationSession(model, IAM_CHARSET, device=device)
    labels, lens = session.encode_texts([TEXT] * batch)
    styles = np.random.default_rng(seed + 1).standard_normal(
        (batch, STYLE_DIM)).astype(np.float32)
    return session, labels, lens, torch.from_numpy(styles).to(session.device)


def median_ms(arms: Dict[str, Callable[[], object]], iters: int,
              rounds: int) -> Dict[str, float]:
    """Each arm's median ms per call over ``rounds`` rounds, the arms
    alternated within each round, after one warm-up call of each."""
    for fn in arms.values():
        fn()
    times: Dict[str, List[float]] = {k: [] for k in arms}
    for r in range(rounds):
        order = list(arms) if r % 2 == 0 else list(arms)[::-1]
        for k in order:
            times[k].append(event_ms(arms[k], iters, warmup=0))
    return {k: statistics.median(v) for k, v in times.items()}


def _launches(fn: Callable[[], object]) -> int:
    n0 = gen_epilogue.block_epilogue.launches
    fn()
    return gen_epilogue.block_epilogue.launches - n0


def block_inputs(session, labels, lens, styles) -> List[tuple]:
    """``(x, style)`` of each styled block and the head's ``(x, gamma,
    beta)`` in one bench forward."""
    g = session.model.generator
    seen, hooks = [], []
    for blk in g.blocks:
        hooks.append(blk.register_forward_pre_hook(
            lambda m, a: seen.append((a[0], a[1]))))
    hooks.append(g.blocks[-1].register_forward_hook(
        lambda m, a, out: seen.append(tuple(out))))
    try:
        with torch.no_grad():
            session.forward(labels, lens, styles,
                            spaced_len=SPACED_LEN, seed=0)
    finally:
        for h in hooks:
            h.remove()
    return seen


BLOCK_NAMES = ("blk0_init_H4", "blk1_up_v_H8", "blk2_up_v_H16",
               "blk3_fused_H32", "blk4_fused_H64")


def blocks(session, labels, lens, styles, iters: int, rounds: int) -> Dict:
    """Each styled block alone at the bench shapes (noise drawn from a
    seeded generator, epilogues through the kernel), then the head."""
    g, dev = session.model.generator, session.device
    inputs = block_inputs(session, labels, lens, styles)
    draw = torch.Generator(dev).manual_seed(0)
    arms, info = {}, {}
    for name, blk, (x, style) in zip(BLOCK_NAMES, g.blocks, inputs):
        arms[name] = (lambda blk=blk, x=x, style=style: blk(
            x, style, generator=draw, fused_epilogue=g.fused_epilogue))
        info[name] = {"in_mb": x.numel() * x.element_size() / 1e6,
                      "in_shape": list(x.shape)}
    hx, gamma, beta = inputs[-1]
    arms["head_equal_conv_tanh"] = lambda: g.head(hx, gamma, beta)
    info["head_equal_conv_tanh"] = {
        "in_mb": hx.numel() * hx.element_size() / 1e6,
        "in_shape": list(hx.shape)}
    with torch.no_grad():
        for name, fn in arms.items():
            info[name]["epilogue_launches"] = _launches(fn)
        times = median_ms(arms, iters, rounds)
    for name, ms in times.items():
        info[name]["ms"] = ms
    info["total_isolated_ms"] = sum(times.values())
    return info


@contextlib.contextmanager
def _no_blur():
    """The epilogue called with its blur off (an ablation: timing only)."""
    real = gen.block_epilogue

    def call(*a, apply_blur, **kw):
        return real(*a, apply_blur=False, **kw)
    gen.block_epilogue = call
    try:
        yield
    finally:
        gen.block_epilogue = real


def _set_variant(model, phase: bool, fused: bool) -> None:
    model.generator.fused_epilogue = fused
    for blk in model.generator.blocks:
        blk.phase_upsample = phase


AB_ARMS = (("baseline", False, False), ("phase", True, False),
           ("fused_epi", False, True), ("phase+fused", True, True))


def ab(session, labels, lens, styles, iters: int, rounds: int) -> Dict:
    """The four variant arms on one set of weights: ms, lines/s, epilogue
    launches per forward, and each arm's render (the same draws) against
    the baseline's: mean and max abs difference."""
    model, B = session.model, labels.shape[0]

    def arm(phase, fused):
        def run():
            _set_variant(model, phase, fused)
            return session.forward(labels, lens, styles,
                                   spaced_len=SPACED_LEN, seed=0)
        return run
    arms = {name: arm(p, f) for name, p, f in AB_ARMS}
    launches, diff = {}, {}
    base = arms["baseline"]()[0].float()
    for name, fn in arms.items():
        n0 = gen_epilogue.block_epilogue.launches
        d = (fn()[0].float() - base).abs()
        launches[name] = gen_epilogue.block_epilogue.launches - n0
        diff[name] = (float(d.mean()), float(d.max()))
    times = median_ms(arms, iters, rounds)
    _set_variant(model, False, True)
    return {name: {"ms": ms, "lines_per_s": B * 1e3 / ms,
                   "epilogue_launches": launches[name],
                   "mean_abs_vs_baseline": diff[name][0],
                   "max_abs_vs_baseline": diff[name][1]}
            for name, ms in times.items()}


def attribution(session, labels, lens, styles, iters: int,
                rounds: int) -> Dict:
    """The forward and its ablations (timing only), and what their
    differences attribute."""
    model, dev = session.model, session.device
    g = model.generator
    with torch.no_grad():
        counts = session._counts(labels, styles)
        spaced, _ = insert_spaces(
            labels, lens, counts, torch.Generator(dev).manual_seed(0),
            max_len=SPACED_LEN, count_std=0.0, dup_std=0.0,
            count_duplicates=model.cfg.spacer.count_duplicates)
    draw = torch.Generator(dev).manual_seed(0)
    planes = noise_planes(g, labels.shape[0], SPACED_LEN, draw,
                          g.dtype, dev)

    def generator(noise=None, blur=True):
        def run():
            ctx = contextlib.nullcontext() if blur else _no_blur()
            with ctx:
                return model.generate_spaced(
                    spaced, styles, noise=noise,
                    generator=None if noise is not None else draw)
        return run
    arms = {"full": lambda: session.forward(
                labels, lens, styles, spaced_len=SPACED_LEN, seed=0),
            "generator": generator(),
            "generator_noise_given": generator(planes),
            "generator_no_blur": generator(blur=False),
            "trunk": generator(planes, blur=False),
            "noise_draws": lambda: noise_planes(
                g, labels.shape[0], SPACED_LEN, draw, g.dtype, dev)}
    with torch.no_grad():
        launches = {k: _launches(fn) for k, fn in arms.items()}
        t = median_ms(arms, iters, rounds)
    return {"arms_ms": t, "epilogue_launches": launches,
            "spacer_insert_spaces_ms": t["full"] - t["generator"],
            "noise_ms": t["generator"] - t["generator_noise_given"],
            "blur_ms": t["generator"] - t["generator_no_blur"],
            "trunk_ms": t["trunk"]}


def noise_planes(g, B: int, T: int, draw, dtype, device) -> List:
    """The ten planes a forward of ``g`` at ``T`` spaced positions draws:
    two per block at its output resolution."""
    out = []
    for h, w in g.noise_shapes(T):
        for _ in range(2):
            out.append(rows.randn((B, h, w), draw, device=device,
                                  dtype=dtype))
    return out


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m handwriting_line_generation_tpu_torch.trace_gen")
    ap.add_argument("what", nargs="?", default="all",
                    choices=("blocks", "ab", "attribution", "all"))
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(sys.argv[1:] if argv is None else argv)
    session, labels, lens, styles = build(a.batch, device=a.device)
    out = {"batch": a.batch, "spaced_len": SPACED_LEN,
           "device": (torch.cuda.get_device_name(session.device)
                      if session.device.type == "cuda" else "cpu")}
    for what, fn in (("blocks", blocks), ("ab", ab),
                     ("attribution", attribution)):
        if a.what in (what, "all"):
            out[what] = fn(session, labels, lens, styles, a.iters, a.rounds)
            print(what, json.dumps(out[what], indent=1), flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
