"""extract: styles extracted from batches of lines, a closed loop with one
client.

A request is one batch as ``StyleExtractor.extract_dataset`` runs it:
``authors * a_batch`` u8 lines of ``64 x width`` copied to the card,
dequantized there (``ops.augment.dequantize_image``, each line's pad past
its ink at -1), ``StyleExtractor.extract`` with the recognizer frames
``(width + 3) // 4``, and one packed style an author copied to the host;
the request is complete when the styles are on the host.  The lines come
from a pool of ``pool`` batches of seeded glyph lines made at set-up on
the host; request ``i`` takes entry ``i mod pool``.

The check judges a sample of ``sample`` requests of the window, drawn from
the seed (reservoir sampling over every request completed), against the
reference (:mod:`reference.extraction`) in float32 with the
configuration's TF32 switches: the styles and the recognizer's masked
log-probabilities.
"""

from __future__ import annotations

import numpy as np
import torch

from counts import bounds
from counts.flops import count
from harness import inputs, weights
from harness.driver import Cell, Number
from reference import build as ref_build
from reference import extraction as ref_ext


class Extract(Cell):
    def __init__(self, ctx):
        super().__init__()
        from handwriting_line_generation_tpu_torch.config import \
            config_from_dict
        from handwriting_line_generation_tpu_torch.inference.styles import \
            StyleExtractor
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
        rng = np.random.default_rng([ctx.seed, 3])
        self.pool = [inputs.glyph_lines(rng, self.n, int(p["width"]),
                                        int(p["label_len"]),
                                        cfg.model.num_class)[::3]
                     for _ in range(int(p["pool"]))]
        self.k = int(p["sample"])
        self.res_rng = np.random.default_rng([ctx.seed, 1])
        self.sample = []
        self.events = []
        self.peak_flops = bounds.PEAK_FLOPS[
            "tf32" if ctx.config["precision"]["cudnn_allow_tf32"]
            else "float32"]
        _, self.flops["request"] = count(lambda: self._request(-1))
        for i in range(-3, -1):
            self._request(i)
        ctx.sync()

    def _request(self, i: int):
        img, width = self.pool[i % len(self.pool)]
        dev = self.ctx.device
        with torch.inference_mode():
            image = torch.from_numpy(img).to(dev)
            w = torch.from_numpy(width).to(dev)
            x = self.dequantize(image, w)
            frames = torch.clamp((w + 3) // 4, 1, x.shape[2] // 4)
            style, pred = self.extractor.extract(x, frames, self.a)
            if self.ctx.fault == "answer":      # one author a request
                style = style.clone()
                style[0] = -style[0]
            return style[::self.a].float().cpu(), pred

    def step(self, i: int):
        timed = self.ctx.device.startswith("cuda")
        if timed:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
        with self.ctx.spans("extract.request"):
            styles, pred = self._request(i)
        if timed:
            b.record()
            self.events.append(("request", a, b))
        self._keep(i, styles, pred)
        return "request", self.n

    def _keep(self, i, styles, pred):
        out = {"i": i, "styles": styles, "pred": pred}
        if len(self.sample) < self.k:
            self.sample.append(out)
        else:
            j = int(self.res_rng.integers(0, i + 1))
            if j < self.k:
                self.sample[j] = out

    def event_ms(self, kind):
        return [a.elapsed_time(b) for k, a, b in self.events if k == kind]

    def close(self):
        self.events = []
        self.extractor = None
        if self.ctx.device.startswith("cuda"):
            torch.cuda.empty_cache()

    def check(self, control: bool = False):
        ctx = self.ctx
        dev = ctx.device
        if dev.startswith("cuda"):
            from harness.env import reference_precision
            reference_precision(ctx.config)
        model = ref_build.model(ctx.config, ctx.seed, dev)
        if control:
            low = ref_build.model(ctx.config, ctx.seed, dev, "bfloat16")
            self.sample = [dict(self._ref_request(low, s["i"]), i=s["i"])
                           for s in self.sample]
            del low
        worst = {}
        for s in self.sample:
            img, width = self.pool[s["i"] % len(self.pool)]
            got = ref_ext.judge(model, torch.from_numpy(img).to(dev),
                                torch.from_numpy(width).to(dev), self.a, s)
            for k, v in got.items():
                worst[k] = max(worst.get(k, 0.0), v)
        self.detail = {k: v for k, v in worst.items()
                       if k not in ctx.workload["limits"]}
        return [Number(k, v, ctx.limit(k)) for k, v in worst.items()
                if k in ctx.workload["limits"]]

    def _ref_request(self, model, i):
        img, width = self.pool[i % len(self.pool)]
        dev = self.ctx.device
        return ref_ext.request(model, torch.from_numpy(img).to(dev),
                               torch.from_numpy(width).to(dev), self.a)


def setup(ctx) -> Extract:
    return Extract(ctx)
