"""Optimizers and train state of the port's trainers.

Counterpart of ``handwriting_line_generation_tpu/training/train_state.py``:

* :func:`make_lr_schedule` — the reference's learning-rate schedules, as
  functions of the 0-based update count, which is what optax passes its
  schedule; :func:`make_optimizer` pairs one with ``torch.optim.Adam``
  (or ``SGD``) through ``LambdaLR``.  optax's Adam and torch's compute the
  same update (bias-corrected moments, ``eps`` added to the square root),
  and torch's ``weight_decay`` is ``optax.add_decayed_weights`` chained in
  front of the update.
* :class:`ShardedAdam` — that Adam with its state sharded over a mesh's
  ``model`` axis (``--fsdp``); every optimizer here takes ``shard=`` (the
  mesh) to build one.
* The GAN's parameter partitions (main / disc / frozen, by name) and its
  two optimizers, :class:`PartitionAdam`: an element-value
  clip at ``±grad_clip``, then Adam over the optimizer's own partitions
  only.  As optax does for every leaf of its partition, each update takes a
  gradient for every one of them: a parameter that got none gets zeros,
  so its moments decay and its step count advances (``torch.optim.Adam``
  would skip a parameter whose ``.grad`` is None).
* :func:`balance_and_merge` and :func:`multipliers_at` — the saved-gradient
  balancing (arXiv:1903.00277): each saved group's tensor scaled by
  ``x * mean|D| / mean|R|`` before it is added to the dominant gradient.
* :func:`swa_update`, the running mean of stochastic weight averaging.
* The style bank (:func:`bank_push`, :func:`bank_sample`) and
  :class:`GanTrainState`.

Gradients travel as lists aligned with ``model.named_parameters()``: one
tensor per flax leaf, the same set.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import (Callable, Dict, Iterable, List, Mapping, Optional,
                    Sequence, Tuple)

import torch
from torch import nn

from handwriting_line_generation_tpu_torch.config import Config, OptimConfig
from handwriting_line_generation_tpu_torch.convert import (
    optax_adam, optax_partitions, torch_optimizer_state,
)
from handwriting_line_generation_tpu_torch.ops import rows
from handwriting_line_generation_tpu_torch.parallel.mesh import (
    all_gather, fsdp_axis,
)


def make_lr_schedule(kind, base_lr: float, total_iters: int,
                     warmup_steps: int = 1000, cycle_size: int = 500,
                     min_lr_mul: float = 0.001, low_lr_mul: float = 0.25
                     ) -> Callable[[int], float]:
    """``step -> lr`` for the reference's schedules: ``none``, ``LR_test``,
    ``cyclic``, ``cyclic-full``, ``1cycle``, ``rampup`` and
    ``warmup``/``detector``."""
    if not kind or kind == "none":
        return lambda step: base_lr
    if kind == "LR_test":
        start = 1e-6
        slope = (1.0 - start) / max(total_iters, 1)
        return lambda step: base_lr * (start + slope * step)
    if kind == "cyclic":
        return lambda step: base_lr * (
            1 - (1 - min_lr_mul) * ((step - 1) % cycle_size)
            / (cycle_size - 1))
    if kind == "cyclic-full":
        def tri(step):
            phase = (step % cycle_size) / (cycle_size - 1)
            rising = (step // cycle_size) % 2 == 0
            frac = (phase * (1 - low_lr_mul) + low_lr_mul if rising
                    else 1 - phase * (1 - low_lr_mul))
            return base_lr * frac
        return tri
    if kind == "1cycle":
        trail = max(total_iters - 2 * cycle_size, 1)

        def one(step):
            up = (step % cycle_size) / (cycle_size - 1)
            if step < cycle_size:
                frac = up * (1 - low_lr_mul) + low_lr_mul
            elif step < 2 * cycle_size:
                frac = 1 - up * (1 - low_lr_mul)
            else:
                t = min(max(step - 2 * cycle_size, 0), trail)
                frac = (low_lr_mul * (trail - t) / trail
                        + min_lr_mul * t / trail)
            return base_lr * frac
        return one
    if kind == "rampup":
        return lambda step: base_lr * min(1.0, (step + 0.001) / warmup_steps)
    if kind in ("detector", "warmup", "True", True):
        return lambda step: base_lr * min(
            (step + 1.0) ** -0.3, (step + 1.0) * warmup_steps ** -1.3)
    raise ValueError(f"unknown lr schedule {kind!r}")


class ShardedAdam(torch.optim.Adam):
    """``torch.optim.Adam`` over ``params`` (tensors or param-group dicts)
    with its moments sharded over ``shard``'s ``model`` axis.

    Each float tensor that :func:`~handwriting_line_generation_tpu_torch.
    parallel.mesh.fsdp_axis` shards is stood in for by this rank's slice of
    it along that axis; Adam keeps state for, and updates, the slice, and
    :meth:`step` gathers the updated slices back into the full tensors
    (one flat-bucket ``all_gather``).  The rest are Adam's own.  Adam is
    elementwise, so given the same gradients every element comes out as the
    replicated Adam's, bit for bit.  :meth:`state_dict` gathers the moments
    whole, in ``torch.optim.Adam``'s layout over ``params``, and
    :meth:`load_state_dict` takes that layout (from any grid) and keeps this
    rank's slices.  ``step`` and ``state_dict`` are collective over the
    ``model`` axis."""

    def __init__(self, params, shard, **adam):
        groups = list(params)
        if groups and not isinstance(groups[0], dict):
            groups = [{"params": groups}]
        self.shard = shard
        self._full: List[torch.Tensor] = []
        self._axis: List[Optional[int]] = []
        self._slices: List[torch.Tensor] = []
        standins = []
        for g in groups:
            group = dict(g, params=[])
            for p in g["params"]:
                ax = fsdp_axis(p.shape, shard.model, p.is_floating_point())
                s = p if ax is None else \
                    self._slice(p.detach(), ax).clone()
                self._full.append(p)
                self._axis.append(ax)
                self._slices.append(s)
                group["params"].append(s)
            standins.append(group)
        super().__init__(standins, **adam)

    def _slice(self, t: torch.Tensor, ax: int) -> torch.Tensor:
        n = t.shape[ax] // self.shard.model
        return t.narrow(ax, self.shard.model_index * n, n)

    def _sharded(self) -> List[int]:
        return [i for i, ax in enumerate(self._axis) if ax is not None]

    def _gather(self, parts: List[torch.Tensor], index: List[int]
                ) -> List[torch.Tensor]:
        """The whole tensors of this rank's slices ``parts`` (of
        ``self._full[i]`` for ``i`` in ``index``), gathered over the
        ``model`` axis in one bucket."""
        if not parts:
            return []
        flat = torch.cat([t.reshape(-1) for t in parts])
        ranks = all_gather(flat, self.shard.model_group, self.shard.staging)
        out, off = [], 0
        for t, i in zip(parts, index):
            n = t.numel()
            out.append(torch.cat([r[off:off + n].view(t.shape)
                                  for r in ranks], dim=self._axis[i]))
            off += n
        return out

    @torch.no_grad()
    def step(self, closure=None):
        """Adam on this rank's slices (fresh from the full tensors, whose
        ``.grad`` is read), then the full tensors gathered back."""
        index = self._sharded()
        for i in index:
            p, s, ax = self._full[i], self._slices[i], self._axis[i]
            s.copy_(self._slice(p, ax))
            s.grad = (None if p.grad is None
                      else self._slice(p.grad, ax).contiguous())
        super().step()
        whole = self._gather([self._slices[i] for i in index], index)
        for i, t in zip(index, whole):
            self._full[i].copy_(t)
            self._slices[i].grad = None

    def zero_grad(self, set_to_none: bool = True) -> None:
        super().zero_grad(set_to_none)
        for p in self._full:
            p.grad = None

    def state_dict(self) -> Dict:
        sd = super().state_dict()
        index = [i for i in self._sharded() if i in sd["state"]]
        keys = ("exp_avg", "exp_avg_sq")
        parts = [sd["state"][i][k] for i in index for k in keys]
        whole = iter(self._gather(parts, [i for i in index for _ in keys]))
        for i in index:
            sd["state"][i] = dict(sd["state"][i],
                                  **{k: next(whole) for k in keys})
        return sd

    def load_state_dict(self, state_dict: Dict) -> None:
        state = dict(state_dict["state"])
        for i in self._sharded():
            if i in state:
                state[i] = {k: (self._slice(v, self._axis[i]).clone()
                                if k.startswith("exp_avg") else v)
                            for k, v in state[i].items()}
        super().load_state_dict(dict(state_dict, state=state))


def _optimizer(params, cfg: OptimConfig, shard=None
               ) -> torch.optim.Optimizer:
    """The optimizer ``cfg.kind`` names, in any case, as the JAX ``_adam``
    reads it: ``adam`` (``cfg.betas``, eps 1e-8; a :class:`ShardedAdam`
    over ``shard``'s ``model`` axis when a mesh is given) or ``sgd``
    (plain steps, no momentum: ``optax.sgd``; it has no state to shard).
    ``cfg.weight_decay`` adds ``wd * p`` to each gradient before the
    update, as ``optax.add_decayed_weights`` chained in front of it does:
    coupled L2, not AdamW."""
    kind = cfg.kind.lower()
    if kind == "adam":
        kw = dict(lr=cfg.lr, betas=tuple(cfg.betas), eps=1e-8,
                  weight_decay=cfg.weight_decay)
        if shard is None:
            return torch.optim.Adam(params, **kw)
        return ShardedAdam(params, shard, **kw)
    if kind == "sgd":
        return torch.optim.SGD(params, lr=cfg.lr, momentum=0.0,
                               weight_decay=cfg.weight_decay)
    raise ValueError(f"unknown optimizer {cfg.kind!r}")


def make_optimizer(params: Iterable[torch.nn.Parameter], cfg: OptimConfig,
                   total_iters: int, shard=None
                   ) -> Tuple[torch.optim.Optimizer,
                              torch.optim.lr_scheduler.LambdaLR]:
    """The optimizer of :func:`_optimizer`, its learning rate following
    :func:`make_lr_schedule` (call the scheduler's ``step`` after each
    optimizer step); its state sharded over ``shard``'s ``model`` axis
    when a mesh is given."""
    sched = make_lr_schedule(cfg.lr_schedule, cfg.lr, total_iters,
                             cfg.warmup_steps, cfg.cycle_size)
    opt = _optimizer(params, cfg, shard)
    return opt, torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: sched(step) / cfg.lr)


# ---------------------------------------------------------------------------
# GAN: partitions and optimizers
# ---------------------------------------------------------------------------

PARTITIONS = ("main", "slow", "disc", "frozen")
SLOW_LR_SCALE = 0.1                 # the ``slow`` partition's rate, x lr


def partition_label(name: str, *, hwr_frozen: bool,
                    style_frozen: bool = False,
                    slow_names: Sequence[str] = ()) -> str:
    """Group of one parameter by its name (``/``- or ``.``-joined path),
    by the reference's substring rules in this order: ``slow`` when a
    ``slow_names`` entry is in it, ``disc`` for the discriminator,
    ``frozen`` for a frozen recognizer or style extractor, else ``main``."""
    if any(sp in name for sp in slow_names):
        return "slow"
    if "discriminator" in name:
        return "disc"
    if "hwr" in name and hwr_frozen:
        return "frozen"
    if "style_extractor" in name and style_frozen:
        return "frozen"
    return "main"


def partition_params(names: Iterable[str], *, hwr_frozen: bool,
                     style_frozen: bool = False,
                     slow_names: Sequence[str] = ()) -> List[str]:
    """The partition of each parameter name, in order."""
    return [partition_label(n, hwr_frozen=hwr_frozen,
                            style_frozen=style_frozen, slow_names=slow_names)
            for n in names]


class PartitionAdam:
    """``optax.chain(clip(grad_clip), multi_transform(...))`` for one
    optimizer over a model's parameter list: the optimizer ``cfg.kind``
    names (Adam or SGD), at ``cfg.lr`` times the partition's entry of
    ``scales``, steps the parameters whose label is in ``scales``; the rest
    get no update.  ``cfg.weight_decay`` comes after the element clip, as
    the transform's ``add_decayed_weights`` does inside the JAX chain, and
    a zero-filled gradient still decays its parameter.  :meth:`step` takes
    the gradients of every parameter (None counts as zeros).  ``shard``: a mesh whose
    ``model`` axis shards the state (:class:`ShardedAdam`)."""

    def __init__(self, params: Sequence[nn.Parameter], labels: Sequence[str],
                 scales: Dict[str, float], cfg: OptimConfig,
                 grad_clip: float, total_iters: int, shard=None):
        self.params = list(params)
        self.grad_clip = grad_clip
        self.index = [i for i, l in enumerate(labels) if l in scales]
        self.parts = list(scales)
        self.labels = list(labels)
        # the parameters' indices in the optimizer's order (its groups')
        self.order = [i for part in scales for i in self.index
                      if labels[i] == part]
        groups = [{"params": [self.params[i] for i in self.index
                              if labels[i] == part], "lr": cfg.lr * scale}
                  for part, scale in scales.items()]
        self.optimizer = _optimizer([g for g in groups if g["params"]],
                                    cfg, shard)
        sched = make_lr_schedule(cfg.lr_schedule, cfg.lr, total_iters,
                                 cfg.warmup_steps, cfg.cycle_size)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.optimizer, lambda step: sched(step) / cfg.lr)

    def state_dict(self) -> Dict:
        """Adam's moments and step counts, and the schedule's position."""
        return {"optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict()}

    def load_state_dict(self, state: Dict) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])

    def load_optax(self, opt_state: Mapping, params: Mapping,
                   convert: Callable[[Mapping], Dict[str, torch.Tensor]],
                   names: Sequence[str], step: int) -> None:
        """Take the state of the JAX package's optimizer for the same
        partitions: ``chain(clip, multi_transform({part: adam, ...}))`` as
        msgpack stores it, each partition's ``ScaleByAdamState`` (its
        moments param-shaped, empty maps outside the partition) converted
        by ``convert`` (``convert_params``) for ``params`` (the flax
        params tree), ``names`` the model's parameter names; ``step``
        stands in for the count of a partition whose state holds none
        (SGD at a constant rate)."""
        parts = optax_partitions(opt_state)
        counts, mu, nu = set(), {}, {}
        for part in self.parts:
            count, m, v = optax_adam(parts[part], params, convert)
            counts.add(step if count is None else count)
            if m is not None:        # the partition's own parameters
                mine = [names[i] for i in self.order
                        if self.labels[i] == part]
                mu.update((n, m[n]) for n in mine)
                nu.update((n, v[n]) for n in mine)
        if len(counts) != 1:
            raise ValueError(f"partition counts {sorted(counts)} differ")
        opt, sched = torch_optimizer_state(
            self.optimizer, self.scheduler, [names[i] for i in self.order],
            counts.pop(), mu or None, nu or None)
        self.load_state_dict({"optimizer": opt, "scheduler": sched})

    def step(self, grads: Sequence[Optional[torch.Tensor]]) -> None:
        for i in self.index:
            p, g = self.params[i], grads[i]
            g = torch.zeros_like(p) if g is None else g.detach()
            if self.grad_clip:
                g = torch.clamp(g, -self.grad_clip, self.grad_clip)
            p.grad = g
        self.optimizer.step()
        self.scheduler.step()
        for i in self.index:
            self.params[i].grad = None


def make_optimizers(params: Sequence[nn.Parameter], labels: Sequence[str],
                    opt_cfg: OptimConfig, disc_cfg: OptimConfig,
                    grad_clip: float = 2.0, total_iters: int = 175_000,
                    shard=None) -> Tuple[PartitionAdam, PartitionAdam]:
    """(main, disc): main steps ``main``, and ``slow`` at
    :data:`SLOW_LR_SCALE` times its rate; disc steps ``disc``; ``frozen``
    is never stepped."""
    main = PartitionAdam(params, labels,
                         {"main": 1.0, "slow": SLOW_LR_SCALE}, opt_cfg,
                         grad_clip, total_iters, shard)
    disc = PartitionAdam(params, labels, {"disc": 1.0}, disc_cfg, grad_clip,
                         total_iters, shard)
    return main, disc


def make_sep_optimizers(params: Sequence[nn.Parameter], names: Sequence[str],
                        opt_cfg: OptimConfig, grad_clip: float = 2.0,
                        total_iters: int = 175_000, shard=None
                        ) -> Tuple[PartitionAdam, PartitionAdam]:
    """(generator-only, style-extractor-only) optimizers for curricula with
    ``auto-style`` / ``style-ex-only`` lessons, at a constant rate (the JAX
    package builds them without the schedule)."""
    const = OptimConfig(kind=opt_cfg.kind, lr=opt_cfg.lr,
                        betas=opt_cfg.betas,
                        weight_decay=opt_cfg.weight_decay)

    def only(prefix):
        labels = ["on" if prefix in n else "off" for n in names]
        return PartitionAdam(params, labels, {"on": 1.0}, const, grad_clip,
                             total_iters, shard)
    return only("generator"), only("style_extractor")


# ---------------------------------------------------------------------------
# GAN: gradient balancing
# ---------------------------------------------------------------------------


def _abs_means(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """``mean|g|`` of each tensor, stacked: ``[n]`` float32."""
    norms = torch._foreach_norm([g.float() for g in grads], 1)
    numel = torch.tensor([g.numel() for g in grads], dtype=torch.float32,
                         device=grads[0].device)
    return torch.stack(norms) / numel


def balance_and_merge(d_grads: Sequence[torch.Tensor],
                      saved: Sequence[Sequence[torch.Tensor]],
                      multipliers: Sequence[float]) -> List[torch.Tensor]:
    """``D + sum_i x_i * R_i * (mean|D| / mean|R_i|)``, tensor by tensor.

    A tensor whose D is all zero takes the mean of the non-zero ``mean|D|``
    in its place; a saved tensor that is all zero adds nothing."""
    ad = _abs_means(d_grads)
    nz = ad != 0
    nz_mean = torch.where(nz, ad, 0.0).sum() / torch.clamp(nz.sum(), min=1)
    ad = torch.where(nz, ad, nz_mean)
    out = [g.clone() for g in d_grads]
    for x, r_grads in zip(multipliers, saved):
        ar = _abs_means(r_grads)
        scale = torch.where(ar != 0, ad / torch.clamp(ar, min=1e-30), 0.0)
        for i, (r, s) in enumerate(zip(r_grads, scale.unbind())):
            out[i] += x * r * s
    return out


def multipliers_at(balance_var_x: Dict[str, List[float]],
                   iteration: int) -> List[float]:
    """The schedule entry with the latest start ``<= iteration``."""
    best_start, best = -1, [1.0]
    for k, v in balance_var_x.items():
        if int(k) <= iteration and int(k) > best_start:
            best_start = int(k)
            best = v if isinstance(v, list) else [v]
    return best


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """``sqrt(sum g²)`` over every tensor (``optax.global_norm``)."""
    return torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm([g.float() for g in grads], 2)))


def swa_update(swa: Sequence[torch.Tensor], params: Sequence[torch.Tensor],
               n_averaged: int) -> None:
    """One stochastic-weight-averaging step, in place: ``swa += (p - swa) /
    (n_averaged + 1)`` tensor by tensor, the running mean of the parameters
    after ``n_averaged + 1`` of them."""
    diff = torch._foreach_sub([p.detach() for p in params], list(swa))
    torch._foreach_div_(diff, float(n_averaged) + 1.0)
    torch._foreach_add_(list(swa), diff)


# ---------------------------------------------------------------------------
# GAN: style bank and state
# ---------------------------------------------------------------------------


def bank_push(bank: torch.Tensor, count: int, styles: torch.Tensor
              ) -> Tuple[torch.Tensor, int]:
    """Circular-buffer push of per-author styles: rows ``count ..
    count + n - 1`` (mod the bank size) of ``bank``, in place."""
    n = styles.shape[0]
    idx = torch.arange(count, count + n, device=bank.device) % bank.shape[0]
    bank[idx] = styles.detach().to(bank.dtype)
    return bank, count + n


def bank_sample(bank: torch.Tensor, count: int, batch_size: int,
                low: float, high: float, style_dim: int,
                generator: Optional[torch.Generator] = None,
                draws: Optional[Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]] = None
                ) -> torch.Tensor:
    """Interpolated style draw ``[B, style_dim]``: ``a * mix + b * (1 -
    mix)`` of two random rows among the bank's first ``min(count, size)``,
    ``mix`` uniform in ``[low, high]``; N(0, 1) while the bank is empty.
    ``draws``: ``(idx [B, 2] int, mix [B, 1], normal [B, style_dim])``,
    which tests inject; else they come from ``generator``."""
    dev = bank.device
    if draws is None:
        limit = min(max(count, 1), bank.shape[0])
        draws = (rows.randint(0, limit, (batch_size, 2), generator,
                              device=dev),
                 low + (high - low) * rows.rand((batch_size, 1), generator,
                                                device=dev),
                 rows.randn((batch_size, style_dim), generator, device=dev))
    idx, mix, normal = (torch.as_tensor(d, device=dev) for d in draws)
    if count == 0:
        return normal.float()
    pair = bank[idx.long()]                                   # [B, 2, D]
    return pair[:, 0] * mix + pair[:, 1] * (1 - mix)


@dataclass
class GanTrainState:
    """What the GAN's lesson steps thread: the parameters (and the
    discriminator's ``u`` buffers) live in ``model``; ``params`` and
    ``labels`` follow ``model.named_parameters()``."""
    step: int
    model: nn.Module
    names: List[str]
    params: List[nn.Parameter]
    labels: List[str]
    opt_main: PartitionAdam
    opt_disc: PartitionAdam
    # no-step saved gradient groups (genRecog, genAdv) and their validity
    saved_recog: List[torch.Tensor]
    saved_adv: List[torch.Tensor]
    have_saved: bool
    style_bank: torch.Tensor                  # [prev_style_size, packed dim]
    bank_count: int
    generator: torch.Generator                # every random draw of a step
    opt_gen_only: Optional[PartitionAdam] = None
    opt_style_ex: Optional[PartitionAdam] = None

    def clear_saved(self) -> None:
        for g in self.saved_recog + self.saved_adv:
            g.zero_()
        self.have_saved = False


def create_gan_state(cfg: Config, model: nn.Module, seed: int,
                     need_sep_gen_opt: bool = False,
                     need_sep_style_ex_opt: bool = False,
                     shard=None) -> GanTrainState:
    """Partitions, both optimizers (and the separate ones a curriculum asks
    for; their state sharded over ``shard``'s ``model`` axis when a mesh is
    given), zeroed saved groups, an empty style bank on the model's device
    and a generator there seeded with ``seed``."""
    names, params = zip(*model.named_parameters())
    names, params = list(names), list(params)
    labels = partition_params(names, hwr_frozen=cfg.model.hwr_frozen)
    t = cfg.trainer
    main, disc = make_optimizers(params, labels, cfg.optimizer,
                                 cfg.optimizer_discriminator, t.grad_clip,
                                 t.iterations, shard)
    gen_only = style_ex = None
    if need_sep_gen_opt or need_sep_style_ex_opt:
        gen_only, style_ex = make_sep_optimizers(params, names,
                                                 cfg.optimizer, t.grad_clip,
                                                 t.iterations, shard)
    dev = params[0].device
    zeros = lambda: [torch.zeros_like(p) for p in params]
    return GanTrainState(
        step=0, model=model, names=names, params=params, labels=labels,
        opt_main=main, opt_disc=disc, saved_recog=zeros(), saved_adv=zeros(),
        have_saved=False,
        style_bank=torch.zeros((t.prev_style_size,
                                cfg.model.packed_style_dim()), device=dev),
        bank_count=0, generator=torch.Generator(dev).manual_seed(seed),
        opt_gen_only=gen_only if need_sep_gen_opt else None,
        opt_style_ex=style_ex if need_sep_style_ex_opt else None)
