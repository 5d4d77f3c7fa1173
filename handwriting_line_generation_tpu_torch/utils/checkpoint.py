"""Checkpoints of the port's trainers.

Counterpart of ``handwriting_line_generation_tpu/utils/checkpoint.py``, in
torch's idiom: a checkpoint is whatever the trainer's ``state_dict()``
returns (model, optimizer, LR scheduler, step and the dropout/augmentation
generator's state), written by ``torch.save`` to ``<name>.pt`` with an
atomic replace, beside a JSON sidecar ``<name>.json`` of metadata.  Files,
as there: ``checkpoint-iteration<N>`` every ``save_step``,
``checkpoint-latest`` every ``save_step_minor``, and ``model_best`` (the
model's weights only) when the monitored value improves; a trainer's side
objects (the GAN's SWA weights) go beside each as ``<name>-<key>``.

:func:`extract_subtree` takes one submodule's entries out of a state_dict
by key prefix (``encoder`` out of an autoencoder's model) and
:func:`graft_subtree` puts them back, the roles the JAX package's
``extract_subtree`` and ``graft_subtree`` play on nested param dicts;
:func:`param_summary` counts parameters by top-level submodule.

The JAX package's checkpoints are flax msgpack, ``<name>.msgpack`` beside
the same ``<name>.json``: :func:`load_raw_checkpoint` reads one as nested
dicts of arrays (``utils/msgpack.py``, no ``msgpack`` package), as the JAX
package's ``load_raw_checkpoint`` does, and :func:`checkpoint_file` picks
the ``.pt`` or the ``.msgpack`` file of a name.  A run directory may hold
both packages' files: the port resumes a JAX run (``train -c ... -r``) and
saves beside it.  So the manager counts either package's checkpoints when
it refuses to clobber a run, and the port's sidecars say ``"format":
"pt"``, which :func:`checkpoint_file` follows when a name has both files
(the JAX package's sidecars have no such field).

Multi-process runs: only rank 0 writes (:func:`save_checkpoint` does
nothing elsewhere), every rank builds the checkpoint (a sharded Adam
gathers its state whole, so a checkpoint has one layout whatever the grid
that wrote it, and resumes on any), and :meth:`CheckpointManager.maybe_save`
ends each save of a full checkpoint with a barrier, so no rank runs ahead
of a half-written ``checkpoint-latest``.  Every file a
:class:`CheckpointManager` writes is mirrored into the directory of
``INTERACTIVE_SESSION_ARCHIVE`` when that is set (the reference's archive
of interactive sessions).
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Callable, Dict, Optional, Union

import torch

from handwriting_line_generation_tpu_torch.parallel.mesh import (
    barrier, is_writer,
)

# train.py of the reference refuses to start a fresh run in a directory
# that already holds checkpoints; resume instead
CLOBBER_MSG = ("run directory {d} already contains checkpoints; resume "
               "instead, or use a new config name")


# file patterns of a run directory's checkpoints, the port's and the JAX
# package's
CHECKPOINT_PATTERNS = tuple(f"{stem}*{ext}" for stem in ("checkpoint-",
                                                          "model_best")
                            for ext in (".pt", ".msgpack"))
FORMAT = "pt"                     # the port's sidecar ``format`` field


def _path(directory: str, name: str) -> str:
    return os.path.join(directory, name + ".pt")


def save_checkpoint(directory: str, name: str, obj: Any,
                    meta: Optional[Dict] = None) -> str:
    """``torch.save`` ``obj`` to ``<directory>/<name>.pt`` (and ``meta``,
    with ``"format": "pt"``, to ``<name>.json``), each through a temporary
    file and an atomic replace,
    so a reader never sees half a checkpoint.  Only the writing rank
    (:func:`~handwriting_line_generation_tpu_torch.parallel.mesh.is_writer`)
    writes; the path is returned on every rank."""
    path = _path(directory, name)
    if not is_writer():
        return path
    os.makedirs(directory, exist_ok=True)
    torch.save(obj, path + ".tmp")
    os.replace(path + ".tmp", path)
    if meta is not None:
        mpath = os.path.join(directory, name + ".json")
        with open(mpath + ".tmp", "w") as f:
            json.dump(dict(meta, format=FORMAT), f, indent=2, default=str)
        os.replace(mpath + ".tmp", mpath)
    return path


def load_checkpoint(directory: str, name: str) -> Any:
    """The saved object, its tensors on the CPU (tensors, numbers, strings
    and containers only: ``weights_only``)."""
    return torch.load(_path(directory, name), map_location="cpu",
                      weights_only=True)


def load_meta(directory: str, name: str) -> Dict:
    """A checkpoint's sidecar metadata."""
    with open(os.path.join(directory, name + ".json")) as f:
        return json.load(f)


def checkpoint_exists(directory: str, name: str) -> bool:
    """``<name>.pt`` or the JAX package's ``<name>.msgpack`` exists."""
    return os.path.exists(checkpoint_file(os.path.join(directory, name)))


def load_raw_checkpoint(directory: str, name: str) -> Any:
    """A JAX checkpoint ``<directory>/<name>.msgpack`` as flax's
    ``msgpack_restore`` gives it: nested dicts of numpy arrays
    (``bfloat16`` leaves as torch tensors)."""
    from handwriting_line_generation_tpu_torch.utils import msgpack
    return msgpack.read(os.path.join(directory, name + ".msgpack"))


def checkpoint_file(path: str) -> str:
    """``path`` if it names a ``.pt`` or ``.msgpack`` file, else whichever
    of ``path.pt`` (the port's) and ``path.msgpack`` (the JAX package's)
    exists (``path.pt`` when neither does).  When both exist, the sidecar
    ``path.json`` decides: the port wrote it last if it says ``"format":
    "pt"`` (a port run that resumed a JAX run and saved); without the
    field it is the JAX package's, and both files are refused, as they
    might hold different weights."""
    if path.endswith((".pt", ".msgpack")):
        return path
    found = [path + ext for ext in (".pt", ".msgpack")
             if os.path.exists(path + ext)]
    if len(found) == 2:
        try:
            with open(path + ".json") as f:
                fmt = json.load(f).get("format")
        except (OSError, ValueError, AttributeError):
            fmt = None
        if fmt == FORMAT:
            return found[0]
        raise ValueError(f"both {found[0]} and {found[1]} exist; remove "
                         f"one, or name the file with its extension")
    return found[0] if found else path + ".pt"


def extract_subtree(state_dict: Dict[str, torch.Tensor], prefix: str
                    ) -> Dict[str, torch.Tensor]:
    """The entries under ``prefix`` (e.g. ``"encoder"``), with the prefix
    and its dot removed; raises ``KeyError`` if there are none."""
    head = prefix.rstrip(".") + "."
    out = {k[len(head):]: v for k, v in state_dict.items()
           if k.startswith(head)}
    if not out:
        raise KeyError(f"no entries under {prefix!r}")
    return out


def graft_subtree(state_dict: Dict[str, torch.Tensor], prefix: str,
                  subtree: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """A new state_dict: ``state_dict`` with its entries under ``prefix``
    (``.``- or ``/``-joined) replaced by ``subtree``'s, prefixed (the
    inverse of :func:`extract_subtree`); raises ``KeyError`` if there are
    none to replace."""
    head = prefix.replace("/", ".").rstrip(".") + "."
    out = {k: v for k, v in state_dict.items() if not k.startswith(head)}
    if len(out) == len(state_dict):
        raise KeyError(f"no entries under {prefix!r}")
    out.update({head + k: v for k, v in subtree.items()})
    return out


def param_summary(params: Union[torch.nn.Module, Dict[str, torch.Tensor]]
                  ) -> str:
    """Parameter counts: the total, then each top-level submodule's (the
    first component of the keys).  ``params``: a module (its parameters)
    or a state_dict; pass parameters only (``dict(m.named_parameters())``,
    or a :func:`~..convert.convert_params` result without ``spectral``) to
    leave buffers such as the spectral-norm ``u``'s out, as the JAX
    package's count of a flax ``params`` tree does."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    groups: Dict[str, int] = {}
    for k, v in params.items():
        top = k.split(".")[0]
        groups[top] = groups.get(top, 0) + v.numel()
    lines = [f"total params: {sum(groups.values()):,}"]
    lines += [f"  {k}: {groups[k]:,}" for k in sorted(groups)]
    return "\n".join(lines)


class CheckpointManager:
    """The save_step / save_step_minor / best-model policy of a run
    directory.  ``best`` starts from ``model_best.json``'s monitored value,
    so a resumed run's first validation does not overwrite a better
    ``model_best`` from before the restart.  When
    ``INTERACTIVE_SESSION_ARCHIVE`` is set, every file saved here is saved
    in that directory too."""

    def __init__(self, directory: str, save_step: int = 25000,
                 save_step_minor: int = 250):
        self.directory = directory
        self.archive_dir = (os.environ.get("INTERACTIVE_SESSION_ARCHIVE")
                            or None)
        self.save_step = save_step
        self.save_step_minor = save_step_minor
        self.best = float("inf")
        best_meta = os.path.join(directory, "model_best.json")
        if os.path.exists(best_meta):
            try:
                with open(best_meta) as f:
                    self.best = float(json.load(f).get("monitor_value",
                                                       float("inf")))
            except (ValueError, OSError):
                pass

    def save(self, name: str, obj: Any, meta: Dict,
             extra: Optional[Dict[str, Any]] = None) -> None:
        """``obj`` as ``name`` in the run directory and the archive, and
        each of ``extra`` (the GAN's ``{"swa": ...}``) beside it as
        ``<name>-<key>``; rank 0 alone writes."""
        for d in [self.directory] + ([self.archive_dir] if self.archive_dir
                                     else []):
            save_checkpoint(d, name, obj, meta)
            for key, side in (extra or {}).items():
                save_checkpoint(d, f"{name}-{key}", side, meta)

    def maybe_save(self, iteration: int, state: Callable[[], Any],
                   meta: Dict, monitor_value: Optional[float] = None,
                   best: Optional[Callable[[], Any]] = None,
                   extra: Optional[Dict[str, Any]] = None) -> None:
        """Save what is due at ``iteration``.  ``state`` and ``best`` are
        called only when a save needs them: ``state()`` is the full
        checkpoint, ``best()`` what ``model_best`` holds (``state()`` when
        not given).  ``extra``: as :meth:`save`, beside every checkpoint
        written here.

        Every rank calls this at every iteration.  The numbered and latest
        checkpoints fall due at the same iterations on every rank:
        ``state()`` runs on all of them (it may gather sharded state), rank
        0 writes, and all wait for it.  ``model_best`` follows the writer's
        ``monitor_value``, which the ranks need not share (a rank's
        validation rows may be none), so it is written by the writer alone,
        with no barrier (no rank reads it during the run), and ``best()``
        must not be collective."""
        meta = dict(meta, iteration=iteration)
        due = False
        if self.save_step and iteration % self.save_step == 0:
            self.save(f"checkpoint-iteration{iteration}", state(), meta,
                      extra)
            due = True
        if self.save_step_minor and iteration % self.save_step_minor == 0:
            self.save("checkpoint-latest", state(), meta, extra)
            due = True
        if monitor_value is not None and monitor_value < self.best:
            self.best = monitor_value
            if is_writer():
                self.save("model_best", (best or state)(),
                          dict(meta, monitor_value=float(monitor_value)),
                          extra)
        if due:
            barrier()

    def latest_file(self) -> str:
        """The path of ``checkpoint-latest``: the port's ``.pt`` or the JAX
        package's ``.msgpack`` (:func:`checkpoint_file`)."""
        return checkpoint_file(os.path.join(self.directory,
                                            "checkpoint-latest"))

    def latest(self) -> Any:
        """The port's ``checkpoint-latest`` object, or the JAX package's
        as nested dicts of arrays (:func:`load_raw_checkpoint`)."""
        if self.latest_file().endswith(".msgpack"):
            return load_raw_checkpoint(self.directory, "checkpoint-latest")
        return load_checkpoint(self.directory, "checkpoint-latest")

    def has_latest(self) -> bool:
        return checkpoint_exists(self.directory, "checkpoint-latest")

    def _found(self):
        return sorted(os.path.basename(p) for pat in CHECKPOINT_PATTERNS
                      for p in glob.glob(os.path.join(self.directory, pat)))

    def has_checkpoints(self) -> bool:
        """Any numbered, latest or best checkpoint in the run directory,
        the port's or the JAX package's (a run with ``save_step_minor=0``
        writes no ``-latest`` but is just as clobberable)."""
        return bool(self._found())

    def refuse_clobber(self, resume: bool) -> None:
        """Raise rather than start a fresh run over a directory that holds
        checkpoints; and, when resuming, rather than restart from step 0
        over checkpoints that include no ``checkpoint-latest``."""
        if not resume and self.has_checkpoints():
            raise RuntimeError(CLOBBER_MSG.format(d=self.directory))
        if resume and self.has_checkpoints() and not self.has_latest():
            raise RuntimeError(
                f"resume requested but {self.directory} has no "
                f"checkpoint-latest to resume from (found: "
                f"{', '.join(self._found())}). Restarting fresh would "
                "overwrite these; move them away or point the run at a new "
                "save_dir.")
