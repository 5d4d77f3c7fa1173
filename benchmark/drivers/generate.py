"""generate: lines rendered from text and styles, a closed loop with one
client.

A request is ``GenerationSession.render_tensor`` of ``batch`` texts of
``text_min`` to ``text_max`` characters over the configuration's charset
with ``batch`` styles drawn N(0, 1), at ``spaced_len`` positions, with the
request's own noise seed; it is complete when the card has finished the
images, which stay on the card.  The texts and styles come from a pool of
``pool`` requests drawn from the seed at set-up; request ``i`` takes pool
entry ``i mod pool`` and noise seed ``seed * 4096 + i``.  Every request
has the same shape: its longest text is ``text_max`` long.

The check takes a sample of ``sample`` requests of the window, drawn from
the seed (reservoir sampling over every request completed), and judges
each against the reference (:mod:`reference.generation`): the spacer's
counts, the spaced map and the images.  The counts and the spaced map are
read from the program's spacer and generator modules by forward hooks.
"""

from __future__ import annotations

import numpy as np
import torch

from counts import bounds
from counts.flops import count
from harness import inputs, weights
from harness.driver import Cell, Number
from reference import build as ref_build
from reference import generation as ref_gen
from reference import lowp
from reference.charset import get_charset as ref_charset


def _program(ctx):
    from handwriting_line_generation_tpu_torch.charset import get_charset
    from handwriting_line_generation_tpu_torch.config import config_from_dict
    from handwriting_line_generation_tpu_torch.inference.generate import (
        GenerationSession, cast_params_bf16)
    from handwriting_line_generation_tpu_torch.models.hw_with_style import \
        HWWithStyle
    cfg = config_from_dict(ctx.config["config"])
    model = HWWithStyle(cfg.model).to(ctx.device)
    weights.fill(model, ctx.seed)
    if cfg.model.compute_dtype in ("bfloat16", "bf16"):
        cast_params_bf16(model)
    charset = get_charset(cfg.data.charset)
    return cfg, GenerationSession(model, charset, device=ctx.device)


class Generate(Cell):
    def __init__(self, ctx):
        super().__init__()
        p = ctx.params
        self.ctx = ctx
        self.batch, self.spaced_len = int(p["batch"]), int(p["spaced_len"])
        self.cfg, self.session = _program(ctx)
        m = self.cfg.model
        self.dtype = m.torch_compute_dtype()
        self.noise_dtype = self.dtype
        chars = ref_charset(self.cfg.data.charset).chars
        rng = np.random.default_rng([ctx.seed, 0])
        self.pool = [(inputs.texts(rng, chars, self.batch,
                                   int(p["text_min"]), int(p["text_max"])),
                      rng.standard_normal((self.batch, m.style.style_dim))
                      .astype(np.float32))
                     for _ in range(int(p["pool"]))]
        self.base_seed = (ctx.seed % 2 ** 31) * 4096
        # the sample the check judges: a reservoir over the requests
        self.k = int(p["sample"])
        self.res_rng = np.random.default_rng([ctx.seed, 1])
        self.sample = []
        self._seen = {}
        model = self.session.model
        self._hooks = [
            model.spacer.register_forward_hook(
                lambda mod, args, out: self._seen.__setitem__("counts",
                                                              out)),
            model.generator.register_forward_pre_hook(
                lambda mod, args: self._seen.__setitem__("onehot",
                                                         args[0]))]
        kind = "request"
        fwd = self.spaced_len
        esize = 2 if self.dtype == torch.bfloat16 else 4
        self.bounds = {"epilogue_kernel": {kind: bounds.epilogue_forward_s(
            self.batch, fwd, m.generator.dim, esize)}}
        self.peak_flops = bounds.PEAK_FLOPS[
            "bfloat16" if self.dtype == torch.bfloat16 else
            "tf32" if ctx.config["precision"]["cudnn_allow_tf32"]
            else "float32"]
        self.events = []
        # warm-up: the first request counted, then two more
        _, self.flops[kind] = count(lambda: self._render(-1))
        for i in range(-3, -1):
            self._render(i)
        ctx.sync()

    def _render(self, i: int):
        texts, styles = self.pool[i % len(self.pool)]
        return self.session.render_tensor(
            texts, styles, seed=self.base_seed + i,
            spaced_len=self.spaced_len)

    def step(self, i: int):
        timed = self.ctx.device.startswith("cuda")
        if timed:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
        with self.ctx.spans("generate.render_tensor"):
            img = self._render(i)
            if self.ctx.fault == "answer":          # one line a request
                with torch.inference_mode():
                    img[i % self.batch] = -img[i % self.batch]
            if timed:
                b.record()
                self.events.append(("request", a, b))
            self.ctx.sync()
        self._keep(i, img)
        return "request", self.batch

    def _keep(self, i, img):
        out = {"i": i, "image": img, "counts": self._seen["counts"],
               "onehot": self._seen["onehot"]}
        if len(self.sample) < self.k:
            self.sample.append(out)
        else:
            j = int(self.res_rng.integers(0, i + 1))
            if j < self.k:
                self.sample[j] = out

    def event_ms(self, kind):
        return [a.elapsed_time(b) for k, a, b in self.events if k == kind]

    def close(self):
        for h in self._hooks:
            h.remove()
        self.events = []
        self.session = None
        if self.ctx.device.startswith("cuda"):
            torch.cuda.empty_cache()

    def outputs(self, model, charset, i):
        """The control's request: the reference model in place of the
        program."""
        texts, styles = self.pool[i % len(self.pool)]
        return ref_gen.request(model, charset, texts, styles,
                               self.base_seed + i, self.spaced_len,
                               self.noise_dtype, self.ctx.device)

    def check(self, control: bool = False):
        ctx = self.ctx
        dev = ctx.device
        if dev.startswith("cuda"):
            from harness.env import reference_precision
            reference_precision(ctx.config)
        charset = ref_charset(self.cfg.data.charset)
        served = "bfloat16" if self.dtype == torch.bfloat16 else None
        model = ref_build.model(ctx.config, ctx.seed, dev, served=served)
        if control:
            with lowp.fp8():
                self.sample = [dict(self.outputs(model, charset, s["i"]),
                                    i=s["i"]) for s in self.sample]
        worst = {"count_gap": 0.0, "spaced_mismatch": 0.0,
                 "image_gap": 0.0}
        for s in self.sample:
            if "spaced" not in s:
                s["spaced"] = s.pop("onehot").argmax(-1)
            texts, styles = self.pool[s["i"] % len(self.pool)]
            got = ref_gen.judge(model, charset, texts, styles,
                                self.base_seed + s["i"], self.spaced_len,
                                self.noise_dtype, s, dev)
            for k, v in got.items():
                worst[k] = max(worst[k], v)
        return [Number(k, v, ctx.limit(k)) for k, v in worst.items()]


def setup(ctx) -> Generate:
    return Generate(ctx)
