"""The GAN trainer's lessons, plainly: the reference of ``GanTrainer.run_lesson``.

A copy of the program's lesson steps (count; no-step gen; auto and
auto-gen with the ``sign_preserve_var`` balancing; disc) for one process,
without the mesh, checkpoints or logs.  Its optimizers are written out as
the arithmetic they compute: the element clip at ``grad_clip``, then Adam
(bias-corrected moments, ``eps`` added to the square root), each
partition's parameters stepped with a gradient for every one of them (a
zero where a lesson gives none), at a constant rate.  CTC is PyTorch's
(:mod:`reference.ops.ctc`).  Every random draw comes from a
``torch.Generator`` on the device seeded ``seed + 1``, in the program's
order, and the texts from the text sampler seeded with
``trainer.seed``, so the same seed gives the reference the program's
draws.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence

import torch

from reference.charset import get_charset
from reference.data.text_data import TextSampler
from reference.models.hw_with_style import _flat_style, pack_style
from reference.ops.align import viterbi_align
from reference.ops.augment import (
    apply_augmentation, dequantize_image, fg_to_float,
)
from reference.ops import rows
from reference.ops.ctc import ctc_loss_fast, mask_frames_to_blank
from reference.ops.spacing import counts_from_spaced, onehot
from reference.training.curriculum import Curriculum
from reference.training.losses import disc_hinge_loss, gen_adv_loss


def partition(name: str, hwr_frozen: bool) -> str:
    if "discriminator" in name:
        return "disc"
    if "hwr" in name and hwr_frozen:
        return "frozen"
    return "main"


class Adam:
    """Clip, then Adam over one partition's parameters."""

    def __init__(self, params: Sequence[torch.Tensor], index: List[int],
                 lr: float, betas, grad_clip: float, eps: float = 1e-8):
        self.params, self.index = params, index
        self.lr, (self.b1, self.b2) = lr, betas
        self.clip, self.eps = grad_clip, eps
        self.t = 0
        self.m = {i: torch.zeros_like(params[i]) for i in index}
        self.v = {i: torch.zeros_like(params[i]) for i in index}

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        self.t += 1
        c1 = 1 - self.b1 ** self.t
        c2 = 1 - self.b2 ** self.t
        for i in self.index:
            g = grads[i]
            g = torch.zeros_like(self.params[i]) if g is None else g
            if self.clip:
                g = torch.clamp(g, -self.clip, self.clip)
            self.m[i].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[i].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[i].sqrt() / c2 ** 0.5).add_(self.eps)
            self.params[i].addcdiv_(self.m[i], denom, value=-self.lr / c1)


def _grads(outputs, params, grad_outputs, retain_graph: bool):
    got = torch.autograd.grad(outputs, params, grad_outputs,
                              retain_graph=retain_graph, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for g, p in zip(got, params)]


def _abs_means(grads):
    return torch.stack([g.float().abs().sum() / g.numel() for g in grads])


def balance_and_merge(d_grads, saved, multipliers):
    """``D + sum_i x_i * R_i * (mean|D| / mean|R_i|)``, tensor by tensor; a
    tensor whose D is all zero takes the mean of the non-zero ``mean|D|``,
    and a saved tensor that is all zero adds nothing."""
    ad = _abs_means(d_grads)
    nz = ad != 0
    nz_mean = torch.where(nz, ad, 0.0).sum() / torch.clamp(nz.sum(), min=1)
    ad = torch.where(nz, ad, nz_mean)
    out = [g.clone() for g in d_grads]
    for x, r_grads in zip(multipliers, saved):
        ar = _abs_means(r_grads)
        scale = torch.where(ar != 0, ad / torch.clamp(ar, min=1e-30), 0.0)
        for i, r in enumerate(r_grads):
            out[i] += x * r * scale[i]
    return out


def multipliers_at(balance_var_x: Dict, iteration: int) -> List[float]:
    best_start, best = -1, [1.0]
    for k, v in balance_var_x.items():
        if best_start < int(k) <= iteration:
            best_start, best = int(k), (v if isinstance(v, list) else [v])
    return best


class GanLessons:
    """The reference trainer over ``model`` (a reference ``HWWithStyle``)
    and ``encoder`` (the frozen perceptual encoder), both with the
    benchmark's weights."""

    def __init__(self, cfg, model, encoder, seed: int, device):
        c = cfg
        self.cfg, self.model, self.encoder = cfg, model, encoder
        self.device = device
        self.charset = get_charset(c.data.charset)
        self.curriculum = Curriculum(c.trainer.curriculum)
        lw = c.trainer.loss_weights
        self.w = {k: lw.get(k, d) for k, d in (
            ("auto", 0.5), ("perceptual", 0.5), ("count", 0.5),
            ("reconRecog", 1e-6), ("genRecog", 1e-4),
            ("discriminator", 1.0), ("generator", 1.0))}
        self.use_perceptual = "perceptual" in (c.trainer.loss or
                                               {"perceptual": 1})
        il = c.trainer.interpolate_gen_styles
        if isinstance(il, str) and il.startswith("extra-"):
            extra = float(il[6:])
            self.interp = (-extra, 1.0 + extra)
        else:
            self.interp = (0.0, 1.0)
        self.gen_spaced_len = min(c.model.max_gen_length,
                                  max(c.data.label_buckets) * 6)
        self.text = TextSampler(
            self.charset, batch_size=c.data.batch_size * c.data.a_batch_size,
            corpus_path=None,
            max_len=c.trainer.text_data_max_len or max(c.data.label_buckets),
            seed=c.trainer.seed)
        names, params = zip(*model.named_parameters())
        self.names, self.params = list(names), list(params)
        labels = [partition(n, c.model.hwr_frozen) for n in self.names]
        t = c.trainer
        self.opt_main = Adam(self.params, [i for i, l in enumerate(labels)
                                           if l == "main"],
                             c.optimizer.lr, tuple(c.optimizer.betas),
                             t.grad_clip)
        od = c.optimizer_discriminator
        self.opt_disc = Adam(self.params, [i for i, l in enumerate(labels)
                                           if l == "disc"],
                             od.lr, tuple(od.betas), t.grad_clip)
        zeros = lambda: [torch.zeros_like(p) for p in self.params]
        self.saved_recog, self.saved_adv = zeros(), zeros()
        self.bank = torch.zeros((t.prev_style_size,
                                 c.model.packed_style_dim()), device=device)
        self.bank_count = 0
        self.generator = torch.Generator(device).manual_seed(seed + 1)
        # each update's gradient norms by leaf: what the judgement's
        # leaf rule reads
        self.grad_norms: List[torch.Tensor] = []

    # -- pieces ------------------------------------------------------------

    def _augment(self, image, fg_mask):
        return apply_augmentation(self.cfg.data.augmentation, image,
                                  fg_mask, self.generator)

    def _frames(self, width, wscale, W):
        return torch.clamp(torch.ceil(width.float() * wscale / 4.0).long(),
                           1, W // 4)

    def _bank_style(self, B: int):
        dev, g = self.device, self.generator
        limit = min(max(self.bank_count, 1), self.bank.shape[0])
        lo, hi = self.interp
        idx = rows.randint(0, limit, (B, 2), g, device=dev)
        mix = lo + (hi - lo) * rows.rand((B, 1), g, device=dev)
        normal = rows.randn((B, self.cfg.model.packed_style_dim()), g,
                            device=dev)
        if self.bank_count == 0:
            return normal.float()
        pair = self.bank[idx.long()]
        return pair[:, 0] * mix + pair[:, 1] * (1 - mix)

    def _generate(self, label, lens, style, spaced_len):
        return self.model.generate(label, lens, style, spaced_len=spaced_len,
                                   generator=self.generator)

    def _perceptual(self, image, recon):
        bo, mo = self.encoder(image.permute(0, 3, 1, 2))
        br, mr = self.encoder(recon.permute(0, 3, 1, 2))
        return ((bo.float() - br.float()).abs().mean()
                + (mo.float() - mr.float()).abs().mean())

    def _update(self, opt, grads):
        self.grad_norms.append(torch.stack(
            [g.float().norm() for g in grads]).cpu())
        opt.step(grads)

    # -- lessons -----------------------------------------------------------

    def step_count(self, image, label, lens, width, a_batch: int) -> Dict:
        c = self.cfg
        image = dequantize_image(image, width)
        image, _, wscale = self._augment(image, None)
        frames = self._frames(width, wscale, image.shape[2])
        with torch.no_grad():
            pred = mask_frames_to_blank(self.model.recognize(image), frames)
        style, _ = self.model.extract_style(image, a_batch, pred)
        style = _flat_style(style)
        aligned = viterbi_align(pred, label, lens)
        gt_counts, n_rec = counts_from_spaced(aligned, label.shape[1])
        counts = self.model.spacer(onehot(label, c.model.num_class), style)
        mask = (torch.arange(label.shape[1], device=self.device)[None, :]
                < torch.minimum(n_rec, lens.long())[:, None])[..., None]
        loss = self.w["count"] * ((torch.where(mask, counts, 0.0)
                                   - torch.where(mask, gt_counts, 0.0)) ** 2
                                  ).mean()
        grads = _grads(loss, self.params, None, retain_graph=False)
        self._update(self.opt_main, grads)
        return {"countLoss": loss.detach()}

    def step_gen_nostep(self, label, lens, spaced_len: int) -> Dict:
        style_gen = self._bank_style(label.shape[0])
        img, aux = self._generate(label, lens, style_gen, spaced_len)
        frames = torch.clamp(aux["total_len"], 1, spaced_len)
        im = img.detach().requires_grad_(True)
        logp = mask_frames_to_blank(self.model.recognize(im), frames)
        recog_l = self.w["genRecog"] * ctc_loss_fast(logp, label, lens)
        ct_recog, = torch.autograd.grad(recog_l, im)
        adv_l = self.w["generator"] * gen_adv_loss(
            self.model.discriminate(im))
        ct_adv, = torch.autograd.grad(adv_l, im)
        recog_g = _grads(img, self.params, ct_recog, retain_graph=True)
        adv_g = _grads(img, self.params, ct_adv, retain_graph=False)
        torch._foreach_add_(self.saved_recog, recog_g)
        torch._foreach_add_(self.saved_adv, adv_g)
        return {"genRecogLoss": recog_l.detach(),
                "generatorLoss": adv_l.detach()}

    def step_auto(self, image, label, lens, fg_mask, width, a_batch: int,
                  bal_stage: int) -> Dict:
        c = self.cfg
        image = dequantize_image(image, width)
        fg_mask = fg_to_float(fg_mask)
        image, fg_mask, wscale = self._augment(image, fg_mask)
        frames = self._frames(width, wscale, image.shape[2])
        recon, aux = self.model.autoencode(
            image, label, lens, a_batch, frame_lengths=frames,
            generator=self.generator)
        r = recon.detach().requires_grad_(True)
        if c.trainer.no_bg_loss and fg_mask is not None:
            auto = (r * fg_mask - image * fg_mask).abs().mean()
        else:
            auto = (r - image).abs().mean()
        main_l = self.w["auto"] * auto
        logs = {"autoLoss": auto.detach()}
        if self.use_perceptual:
            perc = self._perceptual(image, r)
            main_l = main_l + self.w["perceptual"] * perc
            logs["perceptualLoss"] = perc.detach()
        ct_main, = torch.autograd.grad(main_l, r)
        adv_l = self.w["generator"] * gen_adv_loss(self.model.discriminate(r))
        ct_adv, = torch.autograd.grad(adv_l, r)
        logp = mask_frames_to_blank(self.model.recognize(r), frames)
        recog_l = self.w["reconRecog"] * ctc_loss_fast(logp, label, lens)
        ct_recog, = torch.autograd.grad(recog_l, r)
        main_g = _grads(recon, self.params, ct_main, retain_graph=True)
        adv_g = _grads(recon, self.params, ct_adv, retain_graph=True)
        recog_g = _grads(recon, self.params, ct_recog, retain_graph=False)
        logs.update(autoGenLoss=adv_l.detach(),
                    reconRecogLoss=recog_l.detach())
        mults = (multipliers_at(c.trainer.balance_var_x, bal_stage)
                 + [1.0] * 4)[:4]
        merged = balance_and_merge(
            main_g, [self.saved_recog, self.saved_adv, adv_g, recog_g],
            mults)
        self._update(self.opt_main, merged)
        styles = pack_style(aux["style"])[::a_batch].detach()
        n = styles.shape[0]
        idx = torch.arange(self.bank_count, self.bank_count + n,
                           device=self.device) % self.bank.shape[0]
        self.bank[idx] = styles.to(self.bank.dtype)
        self.bank_count += n
        for g in self.saved_recog + self.saved_adv:
            g.zero_()
        return logs

    def step_disc(self, image, label, lens, width) -> Dict:
        image = dequantize_image(image, width)
        image, _, _ = self._augment(image, None)
        style_gen = self._bank_style(label.shape[0])
        with torch.no_grad():
            fake, _ = self._generate(label, lens, style_gen,
                                     image.shape[2] // 4)
        real_s = self.model.discriminate(image)
        fake_s = self.model.discriminate(fake)
        loss = self.w["discriminator"] * disc_hinge_loss(real_s, fake_s)
        grads = _grads(loss, self.params, None, retain_graph=False)
        self._update(self.opt_disc, grads)
        return {"discriminatorLoss": loss.detach()}

    def run_lesson(self, lesson: List[str], data_iter: Iterator[Dict],
                   iteration: int) -> Dict:
        c = self.cfg
        if all(l[:3] == "gen" or l == "no-step" for l in lesson):
            tb = self.text.get_batch(label_len=max(c.data.label_buckets))
            label = torch.as_tensor(tb["label"], device=self.device)
            lens = torch.as_tensor(tb["label_lengths"], device=self.device)
            return self.step_gen_nostep(label, lens, self.gen_spaced_len)
        b = next(data_iter)
        args = (b["image"], b["label"], b["label_lengths"])
        a = b.get("a_batch_size", 1)
        if "count" in lesson:
            return self.step_count(*args, b["width"], a)
        if "auto" in lesson:
            stage = max([int(k) for k in c.trainer.balance_var_x
                         if int(k) <= iteration] or [0])
            return self.step_auto(*args, b["fg_mask"], b["width"], a, stage)
        if "disc" in lesson:
            return self.step_disc(*args, b["width"])
        raise ValueError(f"no step for lesson {lesson}")
