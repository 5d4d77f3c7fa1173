"""gan_lessons: the GAN curriculum's lessons back to back from a warm state.

The trainer is the program's ``GanTrainer`` on the configuration, its
weights (and the frozen perceptual encoder's) made from the seed.  Image
lessons take the next of a pool of ``pool`` batches made at set-up on the
card: ``a_batch * authors`` seeded u8 glyph lines of ``64 x width`` with
labels of 24 to ``label_len`` characters, their ink as the foreground
mask.  Text lessons take ``TextSampler`` labels at the configuration's
longest label bucket.  A step is one ``GanTrainer.run_lesson``, complete
at a synchronize; it counts the batch's lines.

Set-up drives the trainer from the seed through its first ``ref_lessons``
lessons (one of each kind in the paper curriculum: count, no-step gen,
auto, disc) through the window's own entry and feed, and keeps what the
check compares: each lesson's losses, the first update's gradient by leaf
(read back from Adam's first moment, ``m / (1 - b1)``) and each leaf's
change over those lessons.  Then ``warm_lessons`` more lessons, the first
of each kind under the float-operation counter, and the window continues
the same trainer.

The check (after the window, the trainer freed) runs the reference
(:mod:`reference.gan`) through the same lessons from the same seed in
float32 with the configuration's TF32 switches and compares, by the worst leaf, ``|norm_program -
norm_reference| / max(norm_reference, median leaf's norm)`` of the first
gradient and of the change, and the lessons' losses.  A leaf whose
reference gradient stays under a thousandth of its update's median
(non-zero) leaf in every update is left out of both: Adam moves such a
leaf by its round-off alone.
"""

from __future__ import annotations

import itertools
from typing import Dict, List

import numpy as np
import torch

from counts import bounds
from counts.flops import count
from harness import inputs, weights
from harness.driver import Cell, Number

ENCODER_SEED = 7             # the perceptual encoder's weights: seed + 7
LOSS_FLOOR = 1e-3            # a loss's gap is relative to max(|ref|, this)
TEXT_MIN_LEN = 3             # the text sampler's shortest text


def kind_of(lesson: List[str]) -> str:
    if "count" in lesson:
        return "count"
    if "auto" in lesson:
        return "auto"
    if "disc" in lesson:
        return "disc"
    return "gen"


def _pool(ctx, device, n_lines: int, a_batch: int):
    from handwriting_line_generation_tpu_torch.charset import get_charset
    p = ctx.params
    charset = get_charset(ctx.config["config"]["data"]["charset"])
    rng = np.random.default_rng([ctx.seed, 2])
    pool = []
    for _ in range(int(p["pool"])):
        image, label, lens, width = inputs.glyph_lines(
            rng, n_lines, int(p["width"]), int(p["label_len"]),
            charset.num_class)
        img = torch.from_numpy(image).to(device)
        pool.append(dict(
            image=img, label=torch.from_numpy(label).to(device),
            label_lengths=torch.from_numpy(lens).to(device),
            width=torch.from_numpy(width).to(device),
            gt=[charset.decode(label[b, :lens[b]]) for b in range(n_lines)],
            a_batch_size=a_batch, fg_mask=img < 128))
    return pool


def _halve(batch: Dict) -> Dict:
    """The fault ``half_batch``: the first half of the lines only."""
    n = len(batch["gt"]) // 2
    return {k: (v[:n] if k != "a_batch_size" else v)
            for k, v in batch.items()}


def leaf_gaps(prog: torch.Tensor, ref: torch.Tensor,
              keep: torch.Tensor) -> torch.Tensor:
    """``|prog - ref| / max(ref, median ref)`` by leaf, 0 where a leaf is
    not kept."""
    out = torch.zeros(prog.shape, dtype=torch.float64)
    if not bool(keep.any()):
        return out
    p, r = prog.double(), ref.double()
    med = float(r[keep].median())
    gap = (p - r).abs() / torch.clamp(r, min=med) if med > 0 \
        else (p - r).abs()
    return torch.where(keep, gap, out)


def keep_leaves(grad_norms: List[torch.Tensor]) -> torch.Tensor:
    """Leaves whose gradient reaches a thousandth of its update's median
    non-zero leaf in some update."""
    keep = torch.zeros_like(grad_norms[0], dtype=torch.bool)
    for g in grad_norms:
        nz = g[g > 0]
        if nz.numel():
            keep |= g >= 1e-3 * nz.median()
    return keep


class GanLessonsCell(Cell):
    def __init__(self, ctx):
        super().__init__()
        from handwriting_line_generation_tpu_torch.config import \
            config_from_dict
        from handwriting_line_generation_tpu_torch.training.gan_trainer \
            import GanTrainer
        self.ctx = ctx
        p = ctx.params
        dev = ctx.device
        cfg = config_from_dict(ctx.config["config"])
        cfg.trainer.seed = ctx.seed
        d = cfg.data
        self.lines = d.batch_size * d.a_batch_size
        tr = GanTrainer(cfg, device=dev)
        tr.init_state(ctx.seed)
        weights.fill(tr.model, ctx.seed)
        weights.fill(tr.encoder, ctx.seed + ENCODER_SEED)
        if ctx.fault == "half_batch":
            tr.text.batch_size //= 2
        if ctx.fault == "unchanged":
            for opt in (tr.state.opt_main, tr.state.opt_disc):
                opt.step = lambda grads: None
        self.tr, self.cfg = tr, cfg
        self.names = list(tr.state.names)
        self.pool = _pool(ctx, dev, self.lines, d.a_batch_size)
        self.n_ref = int(p["ref_lessons"])
        self.data = self._batches()
        self.lesson = 0
        # what the check compares, taken as set-up drives the first lessons
        s = tr.state
        before = [q.detach().clone() for q in s.params]
        self.prog_losses: List[Dict[str, float]] = []
        for i in range(self.n_ref):
            out = self._run(i)
            self.prog_losses.append({k: float(v) for k, v in out.items()
                                     if k.endswith("Loss")})
            if i == 0:
                self.prog_grad = self._first_grad()
        self.prog_change = torch.stack(
            [(q.detach() - b).float().norm() for q, b in zip(s.params,
                                                             before)]).cpu()
        del before
        # the float operations of each kind, counted on its first warm-up
        # lesson; the lessons compared above ran as the window runs them
        for i in range(self.n_ref, self.n_ref + int(p["warm_lessons"])):
            kind = kind_of(tr.curriculum.get_lesson(i))
            if kind in self.flops:
                self._run(i)
            else:
                _, self.flops[kind] = count(lambda: self._run(i))
        ctx.sync()
        self.lesson = self.n_ref + int(p["warm_lessons"])
        # what a lesson's CTC launch may take at least, from its shape
        C = cfg.model.num_class
        T_gen = tr.gen_spaced_len
        L_gen = max(d.label_buckets)
        T_img, L_img = int(p["width"]) // 4, int(p["label_len"])
        B = self.lines
        # lattice cells sum_b T (2 len_b + 1): image lessons at the pool's
        # lengths on average (they cycle through it), text lessons at the
        # text sampler's mean length (uniform from TEXT_MIN_LEN to L_gen)
        img_cells = float(np.mean([
            T_img * (2 * b["label_lengths"].double() + 1).sum().item()
            for b in self.pool]))
        gen_cells = B * T_gen * (TEXT_MIN_LEN + L_gen + 1)
        self.bounds = {"ctc_kernel": {
            "gen": bounds.ctc_launch_s(B, T_gen, L_gen, C, gen_cells),
            "auto": bounds.ctc_launch_s(B, T_img, L_img, C, img_cells)}}
        self.peak_flops = bounds.PEAK_FLOPS[
            "tf32" if ctx.config["precision"]["cudnn_allow_tf32"]
            else "float32"]

    def _batches(self):
        for b in itertools.cycle(self.pool):
            yield _halve(b) if self.ctx.fault == "half_batch" else b

    def _run(self, i: int):
        lesson = self.tr.curriculum.get_lesson(i)
        return self.tr.run_lesson(lesson, self.data, iteration=i)

    def _first_grad(self) -> torch.Tensor:
        """Each leaf's gradient norm as the first update took it, from
        Adam's first moment (0 for a leaf the main optimizer does not
        step)."""
        opt = self.tr.state.opt_main.optimizer
        b1 = opt.param_groups[0]["betas"][0]
        out = []
        for q in self.tr.state.params:
            st = opt.state.get(q, {})
            m = st.get("exp_avg")
            out.append(0.0 if m is None else float(m.float().norm())
                       / (1 - b1))
        return torch.tensor(out)

    def step(self, i: int):
        idx = self.lesson + i
        lesson = self.tr.curriculum.get_lesson(idx)
        kind = kind_of(lesson)
        with self.ctx.spans(f"gan.run_lesson.{kind}"):
            self.tr.run_lesson(lesson, self.data, iteration=idx)
            self.ctx.sync()
        return kind, self.lines

    def close(self):
        self.tr = None
        self.data = None
        if self.ctx.device.startswith("cuda"):
            torch.cuda.empty_cache()

    def reference(self, compute_dtype: str = "float32"):
        """The reference's readings over the first lessons: ``(losses,
        first gradient by leaf, change by leaf, gradient norms of each
        update)``."""
        from reference import build as ref_build
        from reference.gan import GanLessons
        from reference.models.autoencoder import build_encoder
        ctx = self.ctx
        dev = ctx.device
        rcfg = ref_build.config(ctx.config, compute_dtype)
        rcfg.trainer.seed = ctx.seed
        model = ref_build.model(ctx.config, ctx.seed, dev, compute_dtype)
        dt = rcfg.model.torch_compute_dtype()
        enc = build_encoder(rcfg.trainer.encoder_type, dt).to(dev)
        weights.fill(enc, ctx.seed + ENCODER_SEED)
        enc.requires_grad_(False)
        ref = GanLessons(rcfg, model, enc, ctx.seed, dev)
        before = [q.detach().clone() for q in ref.params]
        data = iter(self.pool)
        losses, grad = [], None
        for i in range(self.n_ref):
            out = ref.run_lesson(ref.curriculum.get_lesson(i), data, i)
            losses.append({k: float(v) for k, v in out.items()})
            if i == 0:
                b1 = ref.opt_main.b1
                grad = torch.tensor([
                    float(ref.opt_main.m[j].float().norm()) / (1 - b1)
                    if j in ref.opt_main.m else 0.0
                    for j in range(len(ref.params))])
        change = torch.stack([(q.detach() - b).float().norm()
                              for q, b in zip(ref.params, before)]).cpu()
        return losses, grad, change, ref.grad_norms

    def check(self, control: bool = False):
        ctx = self.ctx
        if ctx.device.startswith("cuda"):
            from harness.env import reference_precision
            reference_precision(ctx.config)
        if control:
            (self.prog_losses, self.prog_grad, self.prog_change,
             _) = self.reference("bfloat16")
        losses, grad, change, norms = self.reference()
        gaps = {}
        for i, (lp, lr) in enumerate(zip(self.prog_losses, losses)):
            for k, v in lr.items():
                gaps[f"{i}.{k}"] = (abs(lp[k] - v) / max(abs(v), LOSS_FLOOR)
                                    if k in lp else float("inf"))
        loss_gap = max(gaps.values())
        if any(g != g for g in gaps.values()):
            loss_gap = float("nan")
        g_gap = leaf_gaps(self.prog_grad, grad, keep_leaves(norms[:1]))
        c_gap = leaf_gaps(self.prog_change, change, keep_leaves(norms))
        self.detail = {"loss_gaps": gaps,
                       "grad_leaf": self.names[int(g_gap.argmax())],
                       "change_leaf": self.names[int(c_gap.argmax())],
                       "leaves_kept": int(keep_leaves(norms).sum())}
        return [Number("loss_gap", loss_gap, ctx.limit("loss_gap")),
                Number("grad_gap", float(g_gap.max()), ctx.limit("grad_gap")),
                Number("change_gap", float(c_gap.max()),
                       ctx.limit("change_gap"))]


def setup(ctx) -> GanLessonsCell:
    return GanLessonsCell(ctx)
