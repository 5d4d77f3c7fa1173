"""Rank grid and collectives of the port's multi-process training.

Counterpart of ``handwriting_line_generation_tpu/parallel/mesh.py``.  There
one SPMD program spans a ``data x model`` device mesh and XLA inserts the
collectives; here each rank is a process with one device, launched by
``torchrun``, and the trainers call the collectives themselves through
``torch.distributed``:

* :func:`init_distributed` joins the process group from torchrun's
  ``env://`` variables; :func:`make_mesh` lays the ranks out as a
  ``data x model`` grid (rank ``r`` at ``(r // model, r % model)``) with
  one process group along each axis through each rank;
* the batch is split over ``data``: ranks of one data index read the same
  record shard (:func:`shard_records_for_host`, whole authors per shard),
  and each step's gradients are averaged over ``data`` in one flat bucket
  (:func:`all_reduce_mean`), so every replicated tensor stays bit-equal
  across ranks;
* with ``--fsdp`` the Adam moments of each large float tensor are sharded
  over ``model`` along the axis :func:`fsdp_axis` picks (JAX's
  ``fsdp_sharding`` rule) and the updated slices gathered back
  (``training.train_state.ShardedAdam``);
* rank 0 alone writes the run directory (:func:`is_writer`), behind a
  barrier (:func:`barrier`).

The pure helpers keep the JAX package's signatures and results, with the
process count and index passed where JAX reads ``jax.process_*``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from handwriting_line_generation_tpu_torch.device import resolve_device
from handwriting_line_generation_tpu_torch.ops.rows import MaybeShard, RowShard

FSDP_MIN_SIZE = 2048          # elements: smaller tensors stay replicated


def _on() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank_device(device="cuda") -> torch.device:
    """The device of this rank: ``cuda:{LOCAL_RANK % device_count()}`` for
    ``cuda`` with no index (made current), else ``device`` as named."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def init_distributed(backend: Optional[str] = None, device="cuda") -> int:
    """Join the process group from torchrun's ``env://`` variables
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``); returns the world size.  Nothing happens when
    ``WORLD_SIZE`` is unset, or 1 with no ``backend`` named.  The backend is
    ``nccl`` for a ``cuda`` device and ``gloo`` for the CPU unless named;
    NCCL refuses two ranks on one card (its error is raised, never worked
    around: two ranks on one card need ``gloo``); a first barrier makes
    it surface here.  Each rank prints its device."""
    if _on():
        return dist.get_world_size()
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 and backend is None:
        return 1
    dev = rank_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method="env://")
    dist.barrier()
    print(f"rank {dist.get_rank()} of {dist.get_world_size()}: {backend} "
          f"on {dev}", flush=True)
    return dist.get_world_size()


@dataclass
class Mesh:
    """A ``data x model`` grid of ranks.  ``data_group``: the ranks of this
    rank's model index (gradients are averaged over them); ``model_group``:
    the ranks of its data index (sharded Adam state is gathered over them);
    None on an axis of size 1.  ``staging``: host buffers of gloo
    collectives on CUDA tensors, kept between calls."""
    data: int
    model: int
    rank: int = 0
    data_group: Any = None
    model_group: Any = None
    host_group: Any = None
    staging: Dict = field(default_factory=dict)

    @property
    def world(self) -> int:
        return self.data * self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    def rows(self, generator: Optional[torch.Generator]) -> MaybeShard:
        """``generator`` as this rank's share of the global batch's draws
        (``ops.rows``); itself when ``data`` is 1."""
        if self.data == 1 or generator is None:
            return generator
        return RowShard(generator, self.data, self.data_index)

    def all_reduce_mean(self, tensors: Sequence[torch.Tensor]) -> None:
        """Average ``tensors`` over ``data``, in place."""
        if self.data > 1:
            all_reduce_mean(tensors, self.data_group, self.staging)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The ``data`` ranks' ``x`` concatenated on axis 0, in rank
        order."""
        if self.data == 1:
            return x
        return all_gather_rows(x, self.data_group, self.staging)

    def max_ints(self, values: Sequence[int]) -> List[int]:
        """Each of ``values``' largest over every rank (host tensors)."""
        if self.world == 1:
            return list(values)
        t = torch.tensor(list(values), dtype=torch.int64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.host_group)
        return t.tolist()

    def any(self, flag: bool) -> bool:
        """True on every rank when ``flag`` is true on any (the SIGINT
        agreement: a host tensor, so no device sync)."""
        if self.world == 1:
            return flag
        t = torch.tensor([int(flag)], dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.host_group)
        return bool(t.item())


def make_mesh(data: int = 0, model: int = 1) -> Mesh:
    """The ``data x model`` grid over the process group's ranks (one rank
    when no group is initialized); ``data`` 0 takes ``world // model``.
    Every rank creates every axis group, in the same order."""
    world = dist.get_world_size() if _on() else 1
    rank = dist.get_rank() if _on() else 0
    model = max(model, 1)
    data = data if data > 0 else world // model
    if data * model != world:
        raise ValueError(f"mesh {data} x {model} does not cover the "
                         f"{world} rank(s)")
    mesh = Mesh(data, model, rank)
    if world == 1:
        return mesh
    for m in range(model):                       # ranks along ``data``
        g = dist.new_group([d * model + m for d in range(data)])
        if m == mesh.model_index and data > 1:
            mesh.data_group = g
    for d in range(data):                        # ranks along ``model``
        g = dist.new_group([d * model + m for m in range(model)])
        if d == mesh.data_index and model > 1:
            mesh.model_group = g
    mesh.host_group = (dist.group.WORLD if dist.get_backend() == "gloo"
                       else dist.new_group(backend="gloo"))
    return mesh


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _staged(x: torch.Tensor, group, staging: Optional[Dict]
            ) -> Optional[torch.Tensor]:
    """A pinned host copy of ``x`` (flat) when ``group`` is gloo and ``x``
    lies on the card, else None: the one place where a collective leaves
    the device, for gloo only."""
    if not x.is_cuda or dist.get_backend(group) != "gloo":
        return None
    key = (x.dtype, x.numel())
    buf = None if staging is None else staging.get(key)
    if buf is None:
        buf = torch.empty(x.numel(), dtype=x.dtype, pin_memory=True)
        if staging is not None:
            staging[key] = buf
    buf.copy_(x.reshape(-1))
    return buf


def all_reduce_mean(tensors: Sequence[torch.Tensor], group,
                    staging: Optional[Dict] = None) -> None:
    """Average ``tensors`` over ``group``'s ranks and write them back: one
    flat-bucket ``all_reduce`` (sum, then ÷ size on every rank, so every
    rank holds the same bits) per dtype."""
    n = dist.get_world_size(group)
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        host = _staged(flat, group, staging)
        dist.all_reduce(flat if host is None else host, group=group)
        if host is not None:
            flat.copy_(host)
        flat.div_(n)
        parts = flat.split([t.numel() for t in ts])
        with torch.no_grad():
            torch._foreach_copy_(list(ts), [p.view(t.shape)
                                            for p, t in zip(parts, ts)])


def all_gather_rows(x: torch.Tensor, group,
                    staging: Optional[Dict] = None) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated on axis 0 in rank
    order, on ``x``'s device."""
    return torch.cat(all_gather(x, group, staging))


def all_gather(x: torch.Tensor, group, staging: Optional[Dict] = None
               ) -> List[torch.Tensor]:
    """Every rank's ``x`` (equal shapes), in rank order, on ``x``'s
    device."""
    n = dist.get_world_size(group)
    host = _staged(x, group, staging)
    src = x.contiguous() if host is None else host
    out = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(out, src, group=group)
    return [o.view(x.shape).to(x.device) for o in out]


def fetch(x: torch.Tensor, group=None) -> np.ndarray:
    """Host numpy of every rank's rows of ``x`` in rank order (JAX's
    ``fetch`` of a batch-sharded array); ``x`` itself without a group."""
    if group is None:
        return x.detach().cpu().numpy()
    return all_gather_rows(x.detach(), group).cpu().numpy()


def local_rows(arr: np.ndarray, n: int, index: int) -> np.ndarray:
    """Rank ``index``'s rows of a fetched batch of ``n`` equal shares."""
    if n == 1:
        return arr
    per = arr.shape[0] // n
    return arr[index * per:(index + 1) * per]


def is_writer() -> bool:
    """Rank 0, or a run outside a process group: the one process that
    writes checkpoints, logs and samples."""
    return not _on() or dist.get_rank() == 0


def barrier() -> None:
    """Wait for every rank (nothing outside a process group)."""
    if _on() and dist.get_world_size() > 1:
        dist.barrier()


def end_of_train_sync() -> None:
    """Hold every rank until rank 0's end-of-run writes are done, so no
    rank exits (or reads the run directory) before them."""
    barrier()


def shutdown() -> None:
    """Leave the process group (nothing outside one)."""
    if _on():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# pure helpers
# ---------------------------------------------------------------------------


def fsdp_axis(shape: Sequence[int], model: int, floating: bool = True,
              min_size: int = FSDP_MIN_SIZE) -> Optional[int]:
    """The axis a tensor of ``shape`` is sharded on over ``model`` ranks,
    or None (replicated): JAX's ``fsdp_sharding`` rule, float tensors of
    ``min_size`` elements or more, their largest ``model``-divisible axis,
    ties to the last such axis."""
    if model == 1 or not floating or int(np.prod(shape)) < min_size:
        return None
    best = -1
    for ax, d in enumerate(shape):
        if d % model == 0 and d >= (shape[best] if best >= 0 else 0):
            best = ax
    return None if best < 0 else best


def check_group_local(batch_lines: int, a_batch_size: int,
                      n_devices: int) -> None:
    """Require whole author groups on each rank: the style extractor's
    group collapse must not straddle two.  ``batch_lines`` counts lines
    (``batch_size * a_batch_size`` for author batchers)."""
    per_dev, rem = divmod(batch_lines, n_devices)
    if rem or (a_batch_size > 1 and per_dev % a_batch_size):
        raise ValueError(
            f"batch of {batch_lines} lines over {n_devices} devices gives "
            f"{batch_lines / n_devices} lines/device, which does not hold "
            f"whole author groups of {a_batch_size} — the group collapse "
            f"would all-to-all across devices")


def shard_records_for_host(records: List, n_hosts: int, host_id: int,
                           by_author: Optional[Callable] = None) -> List:
    """Share ``host_id`` of ``n_hosts`` of a record list: with
    ``by_author`` (a key function), whole authors round-robin in sorted
    order; else every ``n_hosts``-th record."""
    if n_hosts == 1:
        return records
    if by_author is not None:
        authors = sorted({by_author(r) for r in records})
        mine = set(authors[host_id::n_hosts])
        return [r for r in records if by_author(r) in mine]
    return records[host_id::n_hosts]


def local_batch_size(global_lines: int, a_batch_size: int = 1,
                     n_processes: int = 1) -> int:
    """One process's share of a ``global_lines``-line batch, in whole
    author groups."""
    per, rem = divmod(global_lines, n_processes)
    if rem or (a_batch_size > 1 and per % a_batch_size):
        raise ValueError(
            f"global batch of {global_lines} lines over {n_processes} "
            f"processes gives {per} (+{rem}) lines/process — must split "
            f"into whole author groups of {a_batch_size}")
    return per


def pad_batch_to_devices(batch: Dict[str, Any], n_devices: int
                         ) -> Dict[str, Any]:
    """The batch padded to a multiple of ``n_devices`` rows: paper-white
    images (-1), ``width`` 4 (one frame, an empty line), zero labels and
    lengths, empty strings."""
    b = batch["image"].shape[0] if "image" in batch else \
        batch["label"].shape[0]
    rem = (-b) % n_devices
    if rem == 0:
        return batch
    fill = {"image": -1.0, "width": 4}
    out = {}
    for k, v in batch.items():
        if hasattr(v, "shape") and getattr(v, "ndim", 0) >= 1 \
                and v.shape[0] == b:
            pad = [(0, rem)] + [(0, 0)] * (v.ndim - 1)
            out[k] = np.pad(np.asarray(v), pad,
                            constant_values=fill.get(k, 0))
        elif isinstance(v, list) and len(v) == b:
            out[k] = list(v) + [""] * rem
        else:
            out[k] = v
    return out
