"""reconstruct: lines recognized, their styles extracted, aligned to their
transcripts and regenerated, a closed loop with one client.

A request is one batch as the evaluator and the ``spaced_loc`` cache run
it: ``authors * a_batch`` u8 lines of ``64 x width`` and their transcripts
copied to the card, the lines dequantized there
(``ops.augment.dequantize_image``, each line's pad past its ink at -1),
``StyleExtractor.reconstruct`` with the recognizer frames ``(width + 3) //
4`` and a noise generator seeded ``seed * 4096 + i``, then the spaced
labels ``[B, width / 4]`` and one packed style an author copied to the
host.  The request is complete when the host has them and the card has
finished the reconstructions, which stay on the card.  The lines come
from a pool of ``pool`` batches of seeded glyph lines made at set-up on
the host; request ``i`` takes entry ``i mod pool``.

The check judges a sample of ``sample`` requests of the window, drawn from
the seed (reservoir sampling over every request completed), against the
reference (:mod:`reference.reconstruction`) in float32 with the
configuration's TF32 switches: the recognizer's masked log-probabilities
(read by a forward pre-hook on the program's style extractor), the
styles, the alignment, its path's score and the reconstructions.
"""

from __future__ import annotations

import numpy as np
import torch

from counts import bounds
from counts.flops import count
from harness import inputs, weights
from harness.driver import Cell, Number
from reference import build as ref_build
from reference import reconstruction as ref_rec


class Reconstruct(Cell):
    def __init__(self, ctx):
        super().__init__()
        from handwriting_line_generation_tpu_torch.inference.styles import \
            StyleExtractor
        if not hasattr(StyleExtractor, "reconstruct"):
            raise RuntimeError("the program has no served reconstruction "
                               "entry (StyleExtractor.reconstruct)")
        from handwriting_line_generation_tpu_torch.config import \
            config_from_dict
        from handwriting_line_generation_tpu_torch.models.hw_with_style \
            import HWWithStyle
        from handwriting_line_generation_tpu_torch.ops.augment import \
            dequantize_image
        self.ctx = ctx
        p = ctx.params
        dev = ctx.device
        self.cfg = cfg = config_from_dict(ctx.config["config"])
        model = HWWithStyle(cfg.model).to(dev)
        weights.fill(model, ctx.seed)
        self.extractor = StyleExtractor(model, device=dev)
        self.dequantize = dequantize_image
        self.a = int(cfg.data.a_batch_size)
        self.n = int(p["authors"]) * self.a
        width = int(p["width"])
        rng = np.random.default_rng([ctx.seed, 5])
        self.pool = [inputs.glyph_lines(rng, self.n, width,
                                        int(p["label_len"]),
                                        cfg.model.num_class)
                     for _ in range(int(p["pool"]))]
        self.base_seed = (ctx.seed % 2 ** 31) * 4096
        self.k = int(p["sample"])
        self.res_rng = np.random.default_rng([ctx.seed, 1])
        self.sample = []
        self.events = []
        # the masked log-probs, as the style extractor and the alignment
        # take them: its input [B/a, a*T, C], one author's lines end to end
        self._seen = {}
        self._hook = model.style_extractor.register_forward_pre_hook(
            lambda mod, args: self._seen.__setitem__("pred", args[1]))
        kind = "request"
        self.bounds = {"epilogue_kernel": {kind: bounds.epilogue_forward_s(
            self.n, width // 4, cfg.model.generator.dim, 4)}}
        self.peak_flops = bounds.PEAK_FLOPS[
            "tf32" if ctx.config["precision"]["cudnn_allow_tf32"]
            else "float32"]
        _, self.flops[kind] = count(lambda: self._request(-1))
        for i in range(-3, -1):
            self._request(i)
        ctx.sync()

    def _request(self, i: int):
        dev = self.ctx.device
        img, label, lens, width = (torch.from_numpy(x)
                                   for x in self.pool[i % len(self.pool)])
        with torch.inference_mode():
            image = img.to(dev)
            w = width.to(dev)
            x = self.dequantize(image, w)
            frames = torch.clamp((w + 3) // 4, 1, x.shape[2] // 4)
            g = torch.Generator(dev).manual_seed(self.base_seed + i)
            recon, spaced, style = self.extractor.reconstruct(
                x, frames, label.to(dev), lens.to(dev), self.a, g)
            if self.ctx.fault == "answer":      # one author a request
                recon = recon.clone()
                recon[:self.a] = -recon[:self.a]
            elif self.ctx.fault == "late_path":  # every path a frame late
                spaced = torch.roll(spaced, 1, dims=1)
            out = (recon, spaced.cpu(), style.float().cpu())
        self.ctx.sync()
        return out

    def step(self, i: int):
        timed = self.ctx.device.startswith("cuda")
        if timed:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
        with self.ctx.spans("reconstruct.request"):
            recon, spaced, styles = self._request(i)
        if timed:
            b.record()
            self.events.append(("request", a, b))
        self._keep(i, recon, spaced, styles)
        return "request", self.n

    def _keep(self, i, recon, spaced, styles):
        pred = self._seen["pred"]
        out = {"i": i, "recon": recon, "spaced": spaced, "styles": styles,
               "pred": pred.reshape(self.n, -1, pred.shape[-1])}
        if len(self.sample) < self.k:
            self.sample.append(out)
        else:
            j = int(self.res_rng.integers(0, i + 1))
            if j < self.k:
                self.sample[j] = out

    def event_ms(self, kind):
        return [a.elapsed_time(b) for k, a, b in self.events if k == kind]

    def close(self):
        self._hook.remove()
        self.events = []
        self.extractor = None
        if self.ctx.device.startswith("cuda"):
            torch.cuda.empty_cache()

    def _ref_args(self, i: int):
        dev = self.ctx.device
        img, label, lens, width = (torch.from_numpy(x).to(dev)
                                   for x in self.pool[i % len(self.pool)])
        return img, width, label, lens, self.a, self.base_seed + i

    def check(self, control: bool = False):
        ctx = self.ctx
        dev = ctx.device
        if dev.startswith("cuda"):
            from harness.env import reference_precision
            reference_precision(ctx.config)
        model = ref_build.model(ctx.config, ctx.seed, dev)
        if control:
            low = ref_build.model(ctx.config, ctx.seed, dev, "bfloat16")
            self.sample = [dict(ref_rec.request(low,
                                                *self._ref_args(s["i"])),
                                i=s["i"]) for s in self.sample]
            del low
        worst = {k: 0.0 for k in ctx.workload["limits"]}
        for s in self.sample:
            got = ref_rec.judge(model, *self._ref_args(s["i"]), s)
            for k, v in got.items():
                if worst[k] == worst[k] and not v <= worst[k]:  # NaN stays
                    worst[k] = v
        return [Number(k, v, ctx.limit(k)) for k, v in worst.items()]


def setup(ctx) -> Reconstruct:
    return Reconstruct(ctx)
