"""GAN trainer: phase 3 of the system, the multi-task curriculum.

Counterpart of ``handwriting_line_generation_tpu/training/gan_trainer.py``.
A curriculum (the paper's 7 lessons) picks one of four lesson steps per
iteration:

  ``count``          — style -> spacer counts against the counts decoded
                       from the recognizer's alignment (MSE); main update
  ``no-step, gen``   — a text batch: genRecog CTC (the frozen recognizer
                       reads the generated line) and the generator's
                       adversarial loss; both gradient groups are **saved**
                       (added to what consecutive no-step lessons saved),
                       no update
  ``auto, auto-gen`` — an image batch: autoencode; the main group is the
                       fg-masked L1 plus the perceptual loss (frozen
                       encoder), beside the adversarial and reconRecog
                       groups; the saved and fresh groups are rescaled by
                       ``x * mean|D| / mean|R|`` and merged into the main
                       update; one style per author goes to the bank
  ``disc``           — hinge loss on real against generated lines; the
                       discriminator's update

As in the JAX trainer, the autoencode / generate forward runs **once** and
each loss group's parameter gradient is that forward's vector-Jacobian
product with the group's image cotangent: one ``torch.autograd.grad(image,
params, cotangent, retain_graph=True)`` per group, the heads differentiated
with respect to a detached copy of the image.  The gradients cover every
parameter, the frozen recognizer's and the discriminator's included, since
the balancing averages over them.  Every discriminator forward advances its
spectral-norm ``u``'s.  Dropout is off in every step, as the JAX trainer
passes no dropout rng.  The generator runs its plain path (the epilogue
kernel has no backward); the CTC goes through ``ops.ctc.ctc_loss_fast``,
the CUDA kernel on the card.

Each step takes ``draws=``, a mapping of the step's random draws (tests
inject the JAX trainer's): ``"noise"`` (the generator's 10 planes),
``"normals"`` (``insert_spaces``' two jitter planes), ``"bank"``
(``bank_sample``'s ``(idx, mix, normal)``), ``"aug"`` (the augmentation's,
see ``ops.augment.apply_augmentation``) and ``"vae"`` (a VAE style's eps).
What is not given is drawn from the state's ``torch.Generator``.

A VAE style adds its KL as a second output of the one autoencode forward:
the main group is ``autograd.grad([recon, kl], params, [ct_main,
w_styleReg])``, and the bank stores ``mu``.

:meth:`GanTrainer.train` is the loop of ``training/loop.py``: lesson
``get_lesson(i - 1)`` at iteration ``i`` (the JAX loop's 0-based ``i``),
validation (:meth:`GanTrainer.validate`: losses, CER/WER of the originals,
of their reconstructions and of generated lines), ``model_best`` on
``trainer.monitor``, SWA, sample strips, checkpoints holding the whole
state (:meth:`GanTrainer.state_dict`), resume and SIGINT.  Unlike the JAX
loop, it builds its state from a seed alone (JAX consumes the first batch
to build it), and a resumed run continues the text sampler where it was
(JAX re-seeds it).  It also resumes a JAX run directory
(:meth:`GanTrainer.load_jax_state`); then the sampler is re-seeded as JAX
re-seeds it.

Under a mesh (``use_mesh``, or ``train(..., mesh=, fsdp=)``; see
``parallel/mesh.py``) each rank steps on its share of every image batch.
Where JAX's one SPMD program makes every group gradient global, here each
lesson averages its gradient groups over the ``data`` axis in one bucket
(with its losses) before anything reads them: count's and disc's
gradients, the no-step lesson's genRecog and genAdv groups before they are
added to the saved ones, and the auto lesson's main, adversarial and
reconRecog groups before ``balance_and_merge``.  The style bank takes every
rank's styles in rank order (the bank of one process on the concatenated
batch), and each rank draws the global batch's numbers from the shared
generator and keeps its rows (``ops.rows``), so the ranks' states stay
bit-equal.  As in JAX, the text lessons sample ``batch_size *
a_batch_size / data`` texts a rank from the same seed (every rank the same
texts), and validation's losses are global means while its CERs come from
the rank's own rows (``model_best`` follows rank 0's).  Sample strips are
rank 0's.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import warnings
from typing import (Any, Dict, Iterable, Iterator, List, Mapping, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from handwriting_line_generation_tpu_torch.charset import (
    collapse_argmax_batch, ctc_greedy_decode_batch, get_charset,
)
from handwriting_line_generation_tpu_torch.config import Config
from handwriting_line_generation_tpu_torch.convert import (
    convert_autoencoder_params, convert_checkpoint, convert_hwr_params,
    convert_params, encoder_tree, fill_masked, hwr_tree,
)
from handwriting_line_generation_tpu_torch.data.text_data import TextSampler
from handwriting_line_generation_tpu_torch.device import resolve_device
from handwriting_line_generation_tpu_torch.inference.generate import \
    to_uint8
from handwriting_line_generation_tpu_torch.init import (
    init_autoencoder, init_params, init_spectral,
)
from handwriting_line_generation_tpu_torch.models.autoencoder import (
    AE_KINDS, build_encoder,
)
from handwriting_line_generation_tpu_torch.models.hw_with_style import (
    HWWithStyle, _flat_style, pack_style,
)
from handwriting_line_generation_tpu_torch.ops.align import viterbi_align
from handwriting_line_generation_tpu_torch.ops.augment import (
    apply_augmentation, dequantize_image, fg_to_float, quantize_image_u8,
)
from handwriting_line_generation_tpu_torch.ops.ctc import (
    ctc_loss_fast, mask_frames_to_blank,
)
from handwriting_line_generation_tpu_torch.ops.spacing import (
    counts_from_spaced, onehot,
)
from handwriting_line_generation_tpu_torch.parallel.mesh import (
    Mesh, check_group_local, is_writer,
)
from handwriting_line_generation_tpu_torch.training.curriculum import \
    Curriculum
from handwriting_line_generation_tpu_torch.training.loop import (
    CheckpointedTrainer, resume_seed, validation_batches,
)
from handwriting_line_generation_tpu_torch.training.losses import (
    disc_hinge_loss, gen_adv_loss, vae_kl,
)
from handwriting_line_generation_tpu_torch.training.train_state import (
    GanTrainState, balance_and_merge, bank_push, bank_sample,
    create_gan_state, global_norm, multipliers_at, swa_update,
)
from handwriting_line_generation_tpu_torch.utils import msgpack
from handwriting_line_generation_tpu_torch.utils.checkpoint import (
    checkpoint_exists, checkpoint_file, extract_subtree, load_checkpoint,
    load_meta, load_raw_checkpoint,
)
from handwriting_line_generation_tpu_torch.utils.error_rates import \
    batch_cer_wer
from handwriting_line_generation_tpu_torch.utils.png import write_png_gray

Draws = Optional[Mapping[str, Any]]
GROUPS = ("genRecog", "genAdv", "autoGenAdv", "reconRecog")
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def active_stage(schedule: Optional[Dict], iteration: int) -> int:
    """Start iteration of the schedule stage active at ``iteration``."""
    best = 0
    for k in (schedule or {}):
        if best < int(k) <= iteration:
            best = int(k)
    return best


def resolve_text_data(path: Optional[str], root: str = REPO_ROOT
                      ) -> Optional[str]:
    """The corpus file of the generation-only lessons: ``path`` (the
    config's ``data.text_data``) resolved against the checkout ``root``;
    None, the sampler's built-in text, when it is unset or absent (with a
    warning).  A path that leaves the checkout is refused, so the text the
    lessons sample never depends on files beside it."""
    if not path:
        return None
    root = os.path.abspath(root)
    full = os.path.normpath(os.path.join(root, path))
    if os.path.commonpath([full, root]) != root:
        raise ValueError(
            f"data.text_data {path!r} lies outside the checkout {root}: put "
            "the corpus inside it, or set data.text_data to null for the "
            "built-in text")
    if not os.path.exists(full):
        warnings.warn(f"data.text_data {full} does not exist: the "
                      "generation-only lessons sample the built-in text")
        return None
    return full


def _load_model_state(path: str) -> Dict[str, torch.Tensor]:
    """The model state_dict of a port trainer's checkpoint (``.pt``)."""
    return torch.load(path, map_location="cpu", weights_only=True)["model"]



def _grads(outputs, params, grad_outputs, retain_graph: bool
           ) -> List[torch.Tensor]:
    """``torch.autograd.grad`` over every parameter, zeros where one does
    not reach the outputs."""
    got = torch.autograd.grad(outputs, params, grad_outputs,
                              retain_graph=retain_graph, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for g, p in zip(got, params)]


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class GanTrainer(CheckpointedTrainer):
    """``GanTrainer(cfg, device=None)``: ``cuda`` unless ``device`` names
    another; call :meth:`init_state` before stepping (``train`` calls it
    with ``trainer.seed``)."""

    VAL_BATCHES = 5                   # the JAX loop's val_batches
    LOG_AT_VALIDATION = True

    def __init__(self, cfg: Config, device=None):
        c = cfg
        self.cfg = cfg
        self.device = resolve_device(device)
        self.charset = get_charset(c.data.charset)
        c.model.num_class = self.charset.num_class
        self.curriculum = Curriculum(c.trainer.curriculum)
        lw = c.trainer.loss_weights
        self.w = {
            "auto": lw.get("auto", 0.5),
            "perceptual": lw.get("perceptual", 0.5),
            "count": lw.get("count", 0.5),
            "reconRecog": lw.get("reconRecog", 1e-6),
            "genRecog": lw.get("genRecog", 1e-4),
            "discriminator": lw.get("discriminator", 1.0),
            "generator": lw.get("generator", 1.0),
            "styleReg": lw.get("styleReg", 1.0),
        }
        self.use_perceptual = "perceptual" in (c.trainer.loss or
                                               {"perceptual": 1})
        self.no_bg_loss = c.trainer.no_bg_loss
        il = c.trainer.interpolate_gen_styles
        if isinstance(il, str) and il.startswith("extra-"):
            extra = float(il[6:])
            self.interp_low, self.interp_high = -extra, 1.0 + extra
        else:
            self.interp_low, self.interp_high = 0.0, 1.0
        self.balance = bool(c.trainer.balance_loss)
        self.gen_spaced_len = min(c.model.max_gen_length,
                                  max(c.data.label_buckets) * 6)
        self.text = TextSampler(
            self.charset, batch_size=c.data.batch_size * c.data.a_batch_size,
            corpus_path=resolve_text_data(c.data.text_data),
            max_len=c.trainer.text_data_max_len or max(c.data.label_buckets),
            seed=c.trainer.seed)
        self.encoder = None
        self.model: Optional[HWWithStyle] = None
        self.state: Optional[GanTrainState] = None
        self._last_pred = None
        # SWA running mean of the parameters (not the u's), in
        # ``state.params`` order, and how many it has averaged
        self.swa: Optional[List[torch.Tensor]] = None
        self.swa_n = 0

    @property
    def step(self) -> int:
        return self.state.step

    def use_mesh(self, mesh: Optional[Mesh], fsdp: bool = False) -> None:
        """As ``CheckpointedTrainer.use_mesh``; author groups must stay
        whole on each rank, and the text lessons take the rank's share of
        the batch."""
        super().use_mesh(mesh, fsdp)
        d = self.cfg.data
        lines = d.batch_size * d.a_batch_size
        if mesh is not None:
            check_group_local(lines, d.a_batch_size, mesh.data)
        self.text.batch_size = lines // (1 if mesh is None else mesh.data)

    # -- setup -----------------------------------------------------------

    def init_state(self, seed: int = 0, params: Optional[Mapping] = None,
                   spectral: Optional[Mapping] = None,
                   encoder_state: Optional[Mapping] = None) -> GanTrainState:
        """Seeded weights (or flax ``params`` and ``spectral`` trees), the
        pretrained recognizer of ``model.pretrained_hwr`` (a port
        ``HWRTrainer`` checkpoint or a JAX ``.msgpack``), the frozen
        perceptual encoder (from ``encoder_state``, else
        ``trainer.encoder_weights``, a port ``AutoTrainer`` checkpoint or a
        JAX ``.msgpack``, when the file exists, else seeded), the
        optimizers and a generator seeded with ``seed + 1``."""
        c = self.cfg
        model = HWWithStyle(c.model)
        if params is None:
            params, spectral = (init_params(c.model, seed),
                                init_spectral(c.model, seed))
        model.load_state_dict(convert_params(params, spectral))
        if c.model.pretrained_hwr:
            self.load_pretrained_hwr(model, c.model.pretrained_hwr)
        self.model = model.to(self.device)
        kind, dt = c.trainer.encoder_type, c.model.torch_compute_dtype()
        self.encoder = (init_autoencoder(kind, 0, seed + 2, dt).encoder
                        if kind in AE_KINDS else build_encoder(kind, dt))
        ep = c.trainer.encoder_weights
        if encoder_state is not None:
            self.encoder.load_state_dict(encoder_state)
        elif ep and os.path.exists(checkpoint_file(ep)):
            self.load_encoder_weights(ep)
        self.encoder = self.encoder.to(self.device).requires_grad_(False)
        self.state = create_gan_state(
            c, self.model, seed + 1,
            need_sep_gen_opt=self.curriculum.need_sep_gen_opt,
            need_sep_style_ex_opt=self.curriculum.need_sep_style_ex_opt,
            shard=self._shard)
        return self.state

    @staticmethod
    def load_pretrained_hwr(model: HWWithStyle, path: str) -> None:
        """The recognizer's weights from a port checkpoint (an
        ``HWRTrainer``'s, the model being the recognizer, or a composite
        one's ``hwr.*`` entries) or a JAX one (``.msgpack``: a standalone
        HWR state's tree or a composite checkpoint's ``hwr`` subtree, as
        the JAX GAN finds them); its submodules must be the model's."""
        path = checkpoint_file(path)
        if path.endswith(".msgpack"):
            sd = convert_hwr_params(hwr_tree(msgpack.read(path)))
        else:
            sd = _load_model_state(path)
            if any(k.startswith("hwr.") for k in sd):
                sd = extract_subtree(sd, "hwr")
        expect = {k.split(".")[0] for k in model.hwr.state_dict()}
        got = {k.split(".")[0] for k in sd}
        if expect != got:
            raise ValueError(
                f"pretrained_hwr {path}: submodule mismatch (missing "
                f"{sorted(expect - got)}, extra {sorted(got - expect)})")
        model.hwr.load_state_dict(sd)

    def load_encoder_weights(self, path: str) -> None:
        """The perceptual encoder from an ``AutoTrainer`` checkpoint's
        ``encoder.*`` entries, or a JAX autoencoder state's
        (``.msgpack``) ``encoder`` subtree."""
        path = checkpoint_file(path)
        if path.endswith(".msgpack"):
            sd = convert_autoencoder_params(
                {"encoder": encoder_tree(msgpack.read(path))})
        else:
            sd = _load_model_state(path)
        self.encoder.load_state_dict(extract_subtree(sd, "encoder"))

    # -- shared pieces -----------------------------------------------------

    def _tensor(self, x) -> Optional[torch.Tensor]:
        return None if x is None else torch.as_tensor(x).to(self.device)

    def _augment(self, image, fg_mask, draws: Draws):
        """``apply_augmentation`` with the config's kind, its draws from
        ``draws["aug"]`` or the state's generator."""
        aug = {k: self._tensor(v)
               for k, v in ((draws or {}).get("aug") or {}).items()}
        return apply_augmentation(self.cfg.data.augmentation, image, fg_mask,
                                  self._rows(self.state.generator),
                                  draws=aug)

    def _perceptual(self, image: torch.Tensor, recon: torch.Tensor
                    ) -> torch.Tensor:
        """L1 between the frozen encoder's outputs (bottleneck and mid) of
        the image and of its reconstruction, two encoder applies."""
        bo, mo = self.encoder(image.permute(0, 3, 1, 2))
        br, mr = self.encoder(recon.permute(0, 3, 1, 2))
        return ((bo.float() - br.float()).abs().mean()
                + (mo.float() - mr.float()).abs().mean())

    def _ctc(self, logp, label, lens, weight):
        return weight * ctc_loss_fast(logp, label, lens)

    def _cond_style(self, style: torch.Tensor) -> Dict:
        """The discriminator's ``style`` keyword: the style's first
        ``style_dim`` entries for a ``cond`` discriminator, else none."""
        if not self.cfg.model.discriminator.cond:
            return {}
        return {"style": style[:, :self.cfg.model.style.style_dim].detach()}

    def _frames(self, width, wscale, W: int) -> torch.Tensor:
        return torch.clamp(torch.ceil(width.float() * wscale / 4.0).long(),
                           1, W // 4)

    def _bank_style(self, B: int, draws: Draws) -> torch.Tensor:
        s = self.state
        return bank_sample(s.style_bank, s.bank_count, B, self.interp_low,
                           self.interp_high, self.cfg.model.packed_style_dim(),
                           self._rows(s.generator), (draws or {}).get("bank"))

    def _generate(self, label, lens, style, spaced_len: int, draws: Draws):
        d = draws or {}
        return self.model.generate(label, lens, style, spaced_len=spaced_len,
                                   generator=self._rows(self.state.generator),
                                   normals=d.get("normals"),
                                   noise=d.get("noise"))

    # -- lesson steps --------------------------------------------------------

    def step_count(self, image, label, lens, width, a_batch: int,
                   spaced_label=None, draws: Draws = None) -> Dict:
        """Lesson ``["count"]``.  ``spaced_label``: a precomputed alignment
        in place of ``viterbi_align``."""
        s, c = self.state, self.cfg
        image, label, lens, width = map(self._tensor,
                                        (image, label, lens, width))
        image = dequantize_image(image, width)
        image, _, wscale = self._augment(image, None, draws)
        frames = self._frames(width, wscale, image.shape[2])
        with torch.no_grad():
            pred = mask_frames_to_blank(self.model.recognize(image), frames)
        style, _ = self.model.extract_style(image, a_batch, pred)
        style = _flat_style(style)
        if c.trainer.style_detach:
            style = style.detach()
        aligned = (self._tensor(spaced_label) if spaced_label is not None
                   else viterbi_align(pred, label, lens))
        gt_counts, n_rec = counts_from_spaced(aligned, label.shape[1])
        counts = self.model.spacer(onehot(label, c.model.num_class), style)
        mask = (torch.arange(label.shape[1], device=self.device)[None, :]
                < torch.minimum(n_rec, lens.long())[:, None])[..., None]
        loss = self.w["count"] * ((torch.where(mask, counts, 0.0)
                                   - torch.where(mask, gt_counts, 0.0)) ** 2
                                  ).mean()
        grads = _grads(loss, s.params, None, retain_graph=False)
        loss = loss.detach().clone()
        self._average(grads + [loss])
        s.opt_main.step(grads)
        s.step += 1
        return {"countLoss": loss, "grads": grads}

    def step_gen_nostep(self, label, lens, spaced_len: int,
                        draws: Draws = None) -> Dict:
        """Lesson ``["no-step", "gen"]``: add the genRecog and genAdv
        gradient groups to the saved ones; no update."""
        s, c = self.state, self.cfg
        label, lens = self._tensor(label), self._tensor(lens)
        style_gen = self._bank_style(label.shape[0], draws)
        img, aux = self._generate(label, lens, style_gen, spaced_len, draws)
        frames = torch.clamp(aux["total_len"], 1, spaced_len)
        im = img.detach().requires_grad_(True)
        recog_params = [] if c.model.hwr_frozen else s.params
        logp = mask_frames_to_blank(self.model.recognize(im), frames)
        recog_l = self._ctc(logp, label, lens, self.w["genRecog"])
        ct_recog, *recog_p = torch.autograd.grad(
            recog_l, [im] + recog_params, allow_unused=True)
        adv_l = self.w["generator"] * gen_adv_loss(
            self.model.discriminate(im, **self._cond_style(style_gen)))
        ct_adv, = torch.autograd.grad(adv_l, im)
        recog_g = _grads(img, s.params, ct_recog, retain_graph=True)
        adv_g = _grads(img, s.params, ct_adv, retain_graph=False)
        for i, g in enumerate(recog_p):
            if g is not None:
                recog_g[i] += g
        losses = [recog_l.detach().clone(), adv_l.detach().clone()]
        self._average(recog_g + adv_g + losses)
        torch._foreach_add_(s.saved_recog, recog_g)
        torch._foreach_add_(s.saved_adv, adv_g)
        s.have_saved = True
        s.step += 1
        return {"genRecogLoss": losses[0], "generatorLoss": losses[1],
                "recog_g": recog_g, "adv_g": adv_g}

    def step_auto(self, image, label, lens, fg_mask, width, a_batch: int,
                  opt_kind: str = "main", bal_stage: int = 0,
                  spaced_label=None, draws: Draws = None) -> Dict:
        """Lesson ``["auto", "auto-gen"]``: main, adversarial and reconRecog
        groups, balance-merged with the saved ones, into the ``opt_kind``
        optimizer (``main``, ``gen_only`` for ``auto-style`` lessons,
        ``style_ex`` for ``style-ex-only`` ones)."""
        s, c = self.state, self.cfg
        image, label, lens, width = map(self._tensor,
                                        (image, label, lens, width))
        d, vae = draws or {}, c.model.style.vae
        image = dequantize_image(image, width)
        fg_mask = fg_to_float(self._tensor(fg_mask))
        image, fg_mask, wscale = self._augment(image, fg_mask, draws)
        frames = self._frames(width, wscale, image.shape[2])
        g = self._rows(s.generator)
        recon, aux = self.model.autoencode(
            image, label, lens, a_batch,
            spaced_label=self._tensor(spaced_label), frame_lengths=frames,
            noise=d.get("noise"), generator=g,
            vae_generator=g if vae else None,
            vae_eps=self._tensor(d.get("vae")))
        r = recon.detach().requires_grad_(True)
        # main group: fg-masked L1 + perceptual
        if self.no_bg_loss and fg_mask is not None:
            auto = (r * fg_mask - image * fg_mask).abs().mean()
        else:
            auto = (r - image).abs().mean()
        main_l = self.w["auto"] * auto
        logs = {"autoLoss": auto.detach().clone()}
        if self.use_perceptual:
            perc = self._perceptual(image, r)
            main_l = main_l + self.w["perceptual"] * perc
            logs["perceptualLoss"] = perc.detach().clone()
        ct_main, = torch.autograd.grad(main_l, r)
        adv_l = self.w["generator"] * gen_adv_loss(self.model.discriminate(
            r, **self._cond_style(_flat_style(aux["style"]))))
        ct_adv, = torch.autograd.grad(adv_l, r)
        recog_params = [] if c.model.hwr_frozen else s.params
        logp = mask_frames_to_blank(self.model.recognize(r), frames)
        recog_l = self._ctc(logp, label, lens, self.w["reconRecog"])
        ct_recog, *recog_p = torch.autograd.grad(
            recog_l, [r] + recog_params, allow_unused=True)
        if vae:
            # the KL is a second output of the same forward: its gradient
            # reaches the style extractor directly, not through the recon
            kl = vae_kl(*aux["style"])
            logs["klLoss"] = kl.detach().clone()
            main_g = _grads([recon, kl], s.params,
                            [ct_main, torch.full_like(kl, self.w["styleReg"])],
                            retain_graph=True)
        else:
            main_g = _grads(recon, s.params, ct_main, retain_graph=True)
        logs.update(autoGenLoss=adv_l.detach().clone(),
                    reconRecogLoss=recog_l.detach().clone())
        if self.balance:
            adv_g = _grads(recon, s.params, ct_adv, retain_graph=True)
            recog_g = _grads(recon, s.params, ct_recog, retain_graph=False)
            for i, g in enumerate(recog_p):
                if g is not None:
                    recog_g[i] += g
            # the groups balanced are the global ones
            self._average(main_g + adv_g + recog_g + list(logs.values()))
            mults = (multipliers_at(c.trainer.balance_var_x, bal_stage)
                     + [1.0] * 4)[:4]
            groups = [s.saved_recog, s.saved_adv, adv_g, recog_g]
            merged = balance_and_merge(main_g, groups, mults)
            for name, g in zip(GROUPS, groups):
                logs[f"gnorm_{name}"] = global_norm(g)
            logs["gnorm_main"] = global_norm(main_g)
            logs["gnorm_merged"] = global_norm(merged)
        else:
            both_g = _grads(recon, s.params, ct_adv + ct_recog,
                            retain_graph=False)
            for i, g in enumerate(recog_p):
                if g is not None:
                    both_g[i] += g
            self._average(main_g + both_g + list(logs.values()))
            merged = [m + b + ra + rr for m, b, ra, rr in
                      zip(main_g, both_g, s.saved_recog, s.saved_adv)]
        opt = {"main": s.opt_main, "gen_only": s.opt_gen_only,
               "style_ex": s.opt_style_ex}[opt_kind]
        out = {**logs, "pred_am": aux["pred"].argmax(-1),
               "main_g": main_g, "merged": merged}
        if self.balance:
            out.update(adv_g=adv_g, recog_g=recog_g)
        opt.step(merged)
        styles = pack_style(aux["style"])[::a_batch].detach()
        if self.mesh is not None:
            styles = self.mesh.gather_rows(styles)
        s.style_bank, s.bank_count = bank_push(s.style_bank, s.bank_count,
                                               styles)
        s.clear_saved()
        s.step += 1
        return out

    def step_disc(self, image, label, lens, width=None, a_batch: int = 1,
                  style_gen=None, draws: Draws = None) -> Dict:
        """Lesson ``["disc"]``: hinge on real against generated lines, the
        discriminator's update.  ``style_gen``: packed styles for the fake
        branch (a precomputed bank's rows) in place of a bank draw."""
        s, c = self.state, self.cfg
        image, label, lens, width = map(self._tensor,
                                        (image, label, lens, width))
        image = dequantize_image(image, width)
        image, _, _ = self._augment(image, None, draws)
        B = label.shape[0]
        style_gen = (self._bank_style(B, draws) if style_gen is None
                     else self._tensor(style_gen).float())
        with torch.no_grad():
            fake, _ = self._generate(label, lens, style_gen,
                                     image.shape[2] // 4, draws)
            kwr = {}
            if c.model.discriminator.cond:
                style_real, _ = self.model.extract_style(image, a_batch)
                kwr = {"style": _flat_style(style_real)}
        real_s = self.model.discriminate(image, **kwr)
        fake_s = self.model.discriminate(fake, **self._cond_style(style_gen))
        loss = self.w["discriminator"] * disc_hinge_loss(real_s, fake_s)
        grads = _grads(loss, s.params, None, retain_graph=False)
        loss = loss.detach().clone()
        self._average(grads + [loss])
        s.opt_disc.step(grads)
        s.step += 1
        return {"discriminatorLoss": loss, "grads": grads}

    # -- lessons -------------------------------------------------------------

    def run_lesson(self, lesson: List[str], data_iter: Iterator[Dict],
                   iteration: int = 0, draws: Draws = None) -> Dict:
        """One lesson: a text batch from the sampler for a generation-only
        lesson, else the next batch dict of ``data_iter`` (``image`` u8 or
        normalized float ``[B, H, W, 1]``, ``label``, ``label_lengths``,
        ``width``, ``gt``, and optionally ``a_batch_size``, ``fg_mask``,
        ``spaced_label``, ``style``).  Returns the step's losses (floats
        stay on the device)."""
        if not lesson:
            raise ValueError(
                "curriculum produced no lesson for this iteration: the "
                "first stage starts later than iteration 0")
        c = self.cfg
        keep = lambda out: {k: v for k, v in out.items()
                            if not isinstance(v, list)}
        if all(l[:3] == "gen" or l == "no-step" for l in lesson):
            tb = self.text.get_batch(label_len=max(c.data.label_buckets))
            return keep(self.step_gen_nostep(tb["label"],
                                             tb["label_lengths"],
                                             self.gen_spaced_len, draws))
        batch = self._common(next(data_iter))
        image = batch["image"]
        if (c.data.u8_transfer and isinstance(image, np.ndarray)
                and image.dtype != np.uint8):
            image = quantize_image_u8(image)
        if "$UNKOWN$" in batch.get("gt", []):
            image = self._tensor(image)       # one transfer for both uses
            batch = self.pseudo_label_unknown(batch, image=image)
        args = (image, batch["label"], batch["label_lengths"])
        a_batch = batch.get("a_batch_size", 1)
        spaced = batch.get("spaced_label")
        if spaced is not None and c.data.identity_spaced and "auto" in lesson \
                and 4 * batch["label"].shape[1] != batch["image"].shape[2]:
            raise ValueError(
                "identity_spaced + auto lesson needs 4*label_len == image "
                f"width (got 4*{batch['label'].shape[1]} vs "
                f"{batch['image'].shape[2]})")
        if "count" in lesson:
            return keep(self.step_count(*args, batch["width"], a_batch,
                                        spaced, draws))
        if "auto" in lesson:
            fg = batch.get("fg_mask")
            if fg is not None and c.data.u8_transfer:
                fg = fg > 0.5                 # numpy or tensor, as bool
            opt_kind = ("gen_only" if "auto-style" in lesson else
                        "style_ex" if "style-ex-only" in lesson else "main")
            out = self.step_auto(
                *args, fg, batch["width"], a_batch, opt_kind,
                active_stage(c.trainer.balance_var_x, iteration), spaced,
                draws)
            self._last_pred = (out.pop("pred_am"), list(batch["gt"]))
            return keep(out)
        if "disc" in lesson:
            style_gen = None
            if c.trainer.use_style_cache:
                if batch.get("style") is None:
                    raise ValueError(
                        "trainer.use_style_cache is on but the batch has no "
                        "'style' rows")
                style_gen = np.asarray(batch["style"], np.float32)
            return keep(self.step_disc(*args, batch["width"], a_batch,
                                       style_gen, draws))
        raise ValueError(f"no step for lesson {lesson}")

    def pseudo_label_unknown(self, batch: Dict, image=None) -> Dict:
        """``$UNKOWN$`` lines relabelled with the recognizer's greedy decode
        of their image (frames past the ink width blank), so they still
        feed the alignment-dependent losses.  A line whose decode is empty
        stays, with length 0, as in JAX.  ``image``: the batch's image
        already on the device.  A batch without such lines is returned as
        it is."""
        if "$UNKOWN$" not in batch.get("gt", []):
            return batch
        image = self._tensor(batch["image"] if image is None else image)
        width = self._tensor(batch["width"])
        frames = torch.clamp((width + 3) // 4, 1, image.shape[2] // 4)
        with torch.no_grad():
            logp = mask_frames_to_blank(
                self.model.recognize(dequantize_image(image, width)), frames)
        preds = ctc_greedy_decode_batch(_host(logp), self.charset)
        label = np.array(_host(batch["label"]), copy=True)
        lens = np.array(_host(batch["label_lengths"]), copy=True)
        gt = list(batch["gt"])
        L = label.shape[1]
        for b, g in enumerate(gt):
            if g != "$UNKOWN$":
                continue
            enc = self.charset.encode(preds[b])[:L]
            label[b] = 0
            label[b, :len(enc)] = enc
            lens[b] = len(enc)
            gt[b] = preds[b]
        return dict(batch, label=label, label_lengths=lens, gt=gt)

    # -- evaluation ------------------------------------------------------------

    def _eval_autoencode(self, image, label, lens, width, a_batch: int,
                         draws: Draws):
        """The batch autoencoded for evaluation: no augmentation, ``mu`` for
        a VAE style, the generator's noise from a generator seeded 0 (or
        ``draws["noise"]``), frames past each ink width blank.  Returns
        ``(image, recon, aux, frames, label, lens)`` on the device."""
        image, label, lens, width = map(self._tensor,
                                        (image, label, lens, width))
        image = dequantize_image(image, width)
        frames = torch.clamp((width + 3) // 4, 1, image.shape[2] // 4)
        noise = (draws or {}).get("noise")
        recon, aux = self.model.autoencode(
            image, label, lens, a_batch, frame_lengths=frames, noise=noise,
            generator=(self._rows(torch.Generator(self.device).manual_seed(0))
                       if noise is None else None))
        return image, recon, aux, frames, label, lens

    def _probe(self, label, lens, spaced_len: int, seed: int, draws: Draws):
        """Lines generated from ``label`` in bank-interpolated styles, the
        draws from a generator seeded with ``seed`` (or ``draws``).
        Returns ``(image, aux, style)``."""
        label, lens = self._tensor(label), self._tensor(lens)
        s, d = self.state, draws or {}
        g = self._rows(torch.Generator(self.device).manual_seed(seed))
        style = bank_sample(s.style_bank, s.bank_count, label.shape[0],
                            self.interp_low, self.interp_high,
                            self.cfg.model.packed_style_dim(), g,
                            d.get("bank"))
        img, aux = self.model.generate(label, lens, style,
                                       spaced_len=spaced_len, generator=g,
                                       normals=d.get("normals"),
                                       noise=d.get("noise"))
        return img, aux, style

    @torch.no_grad()
    def eval_step(self, image, label, lens, width, a_batch: int = 1,
                  draws: Draws = None) -> Dict:
        """Validation losses of one batch (:meth:`_eval_autoencode`) and the
        recognizer's argmaxes on the originals (``pred_am``) and on their
        reconstructions (``recon_am``)."""
        c = self.cfg
        image, recon, aux, frames, label, lens = self._eval_autoencode(
            image, label, lens, width, a_batch, draws)
        out = {"val_autoLoss": (recon - image).abs().mean()}
        if self.use_perceptual:
            out["val_perceptualLoss"] = self._perceptual(image, recon)
        gt_counts, n_rec = counts_from_spaced(aux["spaced_label"],
                                              label.shape[1])
        counts = self.model.spacer(onehot(label, c.model.num_class),
                                   _flat_style(aux["style"]))
        mask = (torch.arange(label.shape[1], device=self.device)[None, :]
                < torch.minimum(n_rec, lens.long())[:, None])[..., None]
        out["val_countLoss"] = ((torch.where(mask, counts, 0.0)
                                 - torch.where(mask, gt_counts, 0.0)) ** 2
                                ).mean()
        recon_logp = mask_frames_to_blank(self.model.recognize(recon), frames)
        out["pred_am"] = aux["pred"].argmax(-1)
        out["recon_am"] = recon_logp.argmax(-1)
        return out

    @torch.no_grad()
    def eval_gen_step(self, label, lens, spaced_len: int, seed: int = 0,
                      draws: Draws = None) -> Dict:
        """The gen-CER probe: :meth:`_probe`'s lines read back by the
        recognizer: ``gen_am``."""
        img, aux, _ = self._probe(label, lens, spaced_len, seed, draws)
        frames = torch.clamp(aux["total_len"], 1, spaced_len)
        logp = mask_frames_to_blank(self.model.recognize(img), frames)
        return {"gen_am": logp.argmax(-1)}

    @contextlib.contextmanager
    def _weights(self, params: Optional[Sequence[torch.Tensor]]):
        """The model with ``params`` (in ``state.params`` order) in place of
        its own parameters, restored after."""
        if params is None:
            yield
            return
        own = [p.detach().clone() for p in self.state.params]
        with torch.no_grad():
            torch._foreach_copy_(self.state.params, list(params))
        try:
            yield
        finally:
            with torch.no_grad():
                torch._foreach_copy_(self.state.params, own)

    def validate(self, batches: Iterable[Dict],
                 max_batches: Optional[int] = None,
                 params: Optional[Sequence[torch.Tensor]] = None,
                 draws: Optional[Sequence[Tuple[Draws, Draws]]] = None
                 ) -> Dict[str, float]:
        """``val_autoLoss``, ``val_perceptualLoss`` and ``val_countLoss``
        (each batch's, averaged over batches), ``val_CER``/``val_WER`` of
        the recognizer on the originals, ``val_recon_CER`` on their
        reconstructions and ``val_gen_CER`` on lines generated from their
        text (batch ``i``'s probe seeded ``1000 + i``).  ``params``: weights
        to validate in place of the model's (the SWA average); ``draws``:
        per batch, the ``(eval_step, eval_gen_step)`` draws.  Under a mesh
        the losses are means over every rank's batches, the CERs this
        rank's."""
        # the same keys on every rank, one without validation rows too
        totals = dict.fromkeys(
            ["val_autoLoss", "val_countLoss"]
            + ["val_perceptualLoss"] * self.use_perceptual, 0.0)
        gts: List[str] = []
        preds: List[str] = []
        rpreds: List[str] = []
        gpreds: List[str] = []
        n = 0
        decode = lambda am: collapse_argmax_batch(_host(am), self.charset)
        with self._weights(params):
            for i, batch in enumerate(itertools.islice(batches, max_batches)):
                d_eval, d_gen = draws[i] if draws else (None, None)
                out = self.eval_step(batch["image"], batch["label"],
                                     batch["label_lengths"], batch["width"],
                                     batch.get("a_batch_size", 1), d_eval)
                gen = self.eval_gen_step(batch["label"],
                                         batch["label_lengths"],
                                         self.gen_spaced_len, 1000 + i, d_gen)
                gts.extend(batch["gt"])
                preds.extend(decode(out.pop("pred_am")))
                rpreds.extend(decode(out.pop("recon_am")))
                gpreds.extend(decode(gen["gen_am"]))
                for k, v in out.items():
                    totals[k] += float(v)
                n += 1
        res = self._global_means(totals, n)
        if gts:
            res["val_CER"], res["val_WER"] = batch_cer_wer(gts, preds)
            res["val_recon_CER"], _ = batch_cer_wer(gts, rpreds)
            res["val_gen_CER"], _ = batch_cer_wer(gts, gpreds)
        return res

    # -- SWA -------------------------------------------------------------------

    def _swa_step(self) -> None:
        """Start the running mean at the current parameters, or add them."""
        if self.swa is None:
            self.swa = [p.detach().clone() for p in self.state.params]
            self.swa_n = 1
            return
        swa_update(self.swa, self.state.params, self.swa_n)
        self.swa_n += 1

    # -- checkpoints -----------------------------------------------------------

    def state_dict(self) -> Dict[str, Any]:
        """Everything a resumed run needs to continue exactly: the model
        (parameters and the spectral-norm ``u``'s), every optimizer, the
        saved gradient groups, the style bank, the step, the generator and
        the text sampler's position."""
        s = self.state
        opt = lambda o: None if o is None else o.state_dict()
        return {"model": self.model.state_dict(), "step": s.step,
                "opt_main": opt(s.opt_main), "opt_disc": opt(s.opt_disc),
                "opt_gen_only": opt(s.opt_gen_only),
                "opt_style_ex": opt(s.opt_style_ex),
                "saved_recog": list(s.saved_recog),
                "saved_adv": list(s.saved_adv), "have_saved": s.have_saved,
                "style_bank": s.style_bank, "bank_count": s.bank_count,
                "generator": s.generator.get_state(),
                "text_rng": self.text.rng.bit_generator.state}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        s = self.state
        self.model.load_state_dict(state["model"])
        for name in ("opt_main", "opt_disc", "opt_gen_only", "opt_style_ex"):
            if getattr(s, name) is not None:
                getattr(s, name).load_state_dict(state[name])
        with torch.no_grad():
            torch._foreach_copy_(s.saved_recog + s.saved_adv,
                                 [t.to(self.device) for t in
                                  state["saved_recog"] + state["saved_adv"]])
            s.style_bank.copy_(state["style_bank"])
        s.have_saved = bool(state["have_saved"])
        s.bank_count = int(state["bank_count"])
        s.step = int(state["step"])
        s.generator.set_state(state["generator"])
        self.text.rng.bit_generator.state = state["text_rng"]

    # -- the loop's hooks ------------------------------------------------------

    def monitor(self) -> Tuple[Optional[str], str]:
        return self.cfg.trainer.monitor, self.cfg.trainer.monitor_mode

    def _train_step(self, batches: Iterator[Dict], iteration: int,
                    log_step: bool) -> Optional[Dict]:
        try:
            return self.run_lesson(self.curriculum.get_lesson(iteration - 1),
                                   batches, iteration=iteration - 1)
        except StopIteration:
            return None

    def _log_extra(self) -> Dict:
        """CER/WER of the recognizer on the last auto lesson's batch."""
        if self._last_pred is None:
            return {}
        am, gt = self._last_pred
        cer, wer = batch_cer_wer(gt, collapse_argmax_batch(_host(am),
                                                           self.charset))
        return {"CER": cer, "WER": wer}

    def _validation(self, valid: Any, val_batches: int) -> Dict:
        """The model's validation, and once SWA has started, the SWA
        weights' under ``swa_`` keys."""
        val = self.validate(validation_batches(valid), val_batches)
        if self.swa is not None:
            swa = self.validate(validation_batches(valid), val_batches,
                                params=self.swa)
            val.update({f"swa_{k}": v for k, v in swa.items()})
        return val

    def _after_step(self, iteration: int, run_dir: str, valid: Any) -> None:
        t = self.cfg.trainer
        if (t.swa and iteration >= t.swa_start
                and (iteration - t.swa_start) % max(t.swa_c_iters, 1) == 0):
            self._swa_step()
        if t.print_every and iteration % t.print_every == 0 \
                and valid is not None:
            self._dump_samples(iteration, valid, run_dir)

    def _side_checkpoints(self) -> Tuple[Dict[str, Any], Dict]:
        side = ({} if self.swa is None else
                {"swa": dict(zip(self.state.names, self.swa))})
        return side, {"swa_n": self.swa_n}

    def _resume_side(self, run_dir: str) -> None:
        self._load_swa(run_dir)

    def _load_swa(self, run_dir: str) -> None:
        """The SWA weights of ``checkpoint-latest-swa`` (``.pt``, or a JAX
        run's ``.msgpack``: a bare params tree) and ``swa_n`` from its
        sidecar, when the file exists."""
        name = "checkpoint-latest-swa"
        if not checkpoint_exists(run_dir, name):
            return
        if checkpoint_file(os.path.join(run_dir, name)).endswith(".msgpack"):
            saved = convert_params(load_raw_checkpoint(run_dir, name))
        else:
            saved = load_checkpoint(run_dir, name)
        self.swa = [saved[n].to(self.device) for n in self.state.names]
        self.swa_n = int(load_meta(run_dir, name).get("swa_n", 1))

    def load_jax_state(self, raw: Dict[str, Any], run_dir: str) -> None:
        """Continue a JAX run from its ``checkpoint-latest.msgpack`` (a
        ``GanTrainState`` as ``load_raw_checkpoint`` reads it): the weights
        and ``u``'s, every optimizer's Adam moments, step counts and
        schedule position (``PartitionAdam.load_optax``; the separate
        ``gen_only``/``style_ex`` ones where the curriculum builds them),
        the saved gradient groups and ``have_saved``, the style bank and its
        count, the step, and ``checkpoint-latest-swa`` with its ``swa_n``.
        As JAX does on a resume, the text sampler starts again from
        ``trainer.seed``; JAX's ``rng`` key cannot drive torch, so the
        state's generator is seeded from ``trainer.seed`` and the resumed
        step (``loop.resume_seed``)."""
        s = self.state
        params = raw["params"]
        self.model.load_state_dict(convert_checkpoint(raw))
        step = int(raw["step"])
        for name in ("opt_main", "opt_disc", "opt_gen_only", "opt_style_ex"):
            opt = getattr(s, name)
            if opt is None:
                continue
            if not raw.get(name):
                raise ValueError(f"the JAX checkpoint in {run_dir} has no "
                                 f"{name} state")
            opt.load_optax(raw[name], params, convert_params, s.names, step)
        with torch.no_grad():
            for slot in ("saved_recog", "saved_adv"):
                got = convert_params(fill_masked(raw[slot], params))
                torch._foreach_copy_(getattr(s, slot),
                                     [got[n].to(self.device)
                                      for n in s.names])
            s.style_bank.copy_(torch.from_numpy(
                np.array(raw["style_bank"], np.float32)))
        s.have_saved = bool(raw["have_saved"])
        s.bank_count = int(raw["bank_count"])
        s.step = step
        s.generator.manual_seed(resume_seed(self.cfg.trainer.seed, step))
        self._load_swa(run_dir)

    # -- sample dumps ----------------------------------------------------------

    def _dump_samples(self, iteration: int, valid: Any, run_dir: str) -> None:
        """The first validation batch as two strips, ``iter<N>_gen.png``
        (generated from its text) and ``iter<N>_recon.png`` (each original
        above its reconstruction), under ``trainer.print_dir`` or
        ``<run_dir>/samples``, and the discriminator's mean scores of the
        real and the generated lines appended to ``disc_scores.txt``; rank
        0's alone under a mesh."""
        if not is_writer():
            return
        out_dir = self.cfg.trainer.print_dir or os.path.join(run_dir,
                                                             "samples")
        os.makedirs(out_dir, exist_ok=True)
        batch = next(iter(validation_batches(valid, seed=7)))
        gen = self.eval_gen_render(batch["label"], batch["label_lengths"],
                                   self.gen_spaced_len, seed=iteration)
        rec = self._recon_render(batch["image"], batch["label"],
                                 batch["label_lengths"], batch["width"],
                                 batch.get("a_batch_size", 1))
        self._write_strip(os.path.join(out_dir, f"iter{iteration}_gen.png"),
                          _host(gen["img"]), batch["gt"])
        self._write_strip(os.path.join(out_dir,
                                       f"iter{iteration}_recon.png"),
                          _host(rec["recon"]), batch["gt"],
                          originals=_host(rec["image"]))
        with open(os.path.join(out_dir, "disc_scores.txt"), "a") as f:
            f.write(f"iter {iteration}: real {float(rec['d_real']):.4f} "
                    f"fake {float(gen['d_fake']):.4f}\n")

    @torch.no_grad()
    def eval_gen_render(self, label, lens, spaced_len: int, seed: int = 0,
                        draws: Draws = None) -> Dict:
        """:meth:`_probe`'s lines and the discriminator's mean score of them
        (its ``u``'s unchanged)."""
        img, _, style = self._probe(label, lens, spaced_len, seed, draws)
        kw = {"style": style} if self.cfg.model.discriminator.cond else {}
        scores = self.model.discriminate(img, update_u=False, **kw)
        return {"img": img,
                "d_fake": sum(x.mean() for x in scores) / len(scores)}

    @torch.no_grad()
    def _recon_render(self, image, label, lens, width, a_batch: int = 1,
                      draws: Draws = None) -> Dict:
        """The batch autoencoded as :meth:`eval_step` does, and the
        discriminator's mean score of the originals (``u``'s unchanged)."""
        image, recon, aux, _, _, _ = self._eval_autoencode(
            image, label, lens, width, a_batch, draws)
        kw = ({"style": _flat_style(aux["style"])}
              if self.cfg.model.discriminator.cond else {})
        scores = self.model.discriminate(image, update_u=False, **kw)
        return {"recon": recon, "image": image,
                "d_real": sum(x.mean() for x in scores) / len(scores)}

    @staticmethod
    def _write_strip(path: str, imgs: np.ndarray, gts,
                     originals: Optional[np.ndarray] = None,
                     max_rows: int = 8) -> None:
        """Up to ``max_rows`` lines ``[B, H, W, 1]`` stacked as one 8-bit
        grayscale PNG: each line (below its original, white-padded to the
        line's width, and a grey rule, when ``originals`` are given) and a
        dark rule under it."""
        rows = []
        W = imgs.shape[2]
        for i in range(min(imgs.shape[0], max_rows)):
            if originals is not None:
                o = to_uint8(originals[i])
                if o.shape[1] < W:
                    o = np.pad(o, ((0, 0), (0, W - o.shape[1])),
                               constant_values=255)
                rows += [o[:, :W], np.full((2, W), 128, np.uint8)]
            rows += [to_uint8(imgs[i]), np.full((6, W), 60, np.uint8)]
        write_png_gray(path, np.concatenate(rows))
