"""Quick drives of the port: the counterpart of the root
``__graft_entry__.py`` (which stays JAX).

``entry()``              — ``(fn, example_args)``: the tiny config's
                           generation forward (text + style -> line through
                           the spacer and the generator) on one device.
``dryrun_multichip(n)``  — the GAN's heaviest lessons on ``n`` ranks, which
                           it spawns itself: ``auto`` with the balanced
                           merge, then ``disc``, then a no-step ``gen``, on
                           a ``data x model`` grid (``model`` 2 when ``n``
                           is even and at least 4, the Adam state sharded
                           over it), one author group a data index of a
                           synthetic batch.  Every output must be finite;
                           rank 0 prints one summary line.

    python -m handwriting_line_generation_tpu_torch.graft_entry [N] \\
        [--device cpu] [--backend gloo]

On the CPU the ranks talk over ``gloo``; on the card over the backend the
caller names (``nccl`` by default: two ranks on one card need ``gloo``).
"""

from __future__ import annotations

import argparse
import os
import socket
import sys
from typing import Optional

import numpy as np
import torch


def _tiny_cfg():
    from handwriting_line_generation_tpu_torch.config import (
        Config, DataConfig, DiscriminatorConfig, GeneratorConfig, HWRConfig,
        ModelConfig, SpacerConfig, StyleConfig, TrainerConfig)
    cfg = Config(name="graft_entry")
    cfg.data = DataConfig(dataset="synthetic", batch_size=4, a_batch_size=2,
                          width_buckets=(192,), label_buckets=(12,),
                          augmentation=None)
    cfg.model = ModelConfig(
        hwr=HWRConfig(kind="cnn_only", norm="group"),
        style=StyleConfig(style_dim=32, dim=16, char_dim=16, window=2,
                          char_capacity=4),
        generator=GeneratorConfig(dim=64),
        discriminator=DiscriminatorConfig(dim=16),
        spacer=SpacerConfig(dim=32),
        hwr_frozen=True)
    cfg.trainer = TrainerConfig(
        kind="gan", iterations=10, log_step=5, val_step=0,
        save_step=10 ** 9, save_step_minor=10 ** 9,
        curriculum={"0": [["count"], ["no-step", "gen"],
                          ["auto", "auto-gen"], ["disc"]]})
    return cfg


def entry(device="cuda"):
    """``(fn, (model, label, lens, style))``: ``fn`` renders the text
    "graft entry" in a zero style with the tiny config's seeded model,
    ``[1, 64, 192, 1]``."""
    from handwriting_line_generation_tpu_torch.charset import IAM_CHARSET
    from handwriting_line_generation_tpu_torch.device import resolve_device
    from handwriting_line_generation_tpu_torch.init import init_model

    dev = resolve_device(device)
    cfg = _tiny_cfg()
    model = init_model(cfg.model, seed=0).to(dev).eval()
    label = torch.as_tensor(IAM_CHARSET.encode("graft entry"),
                            device=dev)[None]
    lens = torch.tensor([label.shape[1]], device=dev)
    style = torch.zeros((1, cfg.model.style.style_dim), device=dev)

    @torch.no_grad()
    def fn(model, label, lens, style):
        g = torch.Generator(label.device).manual_seed(1)
        img, _ = model.generate(label, lens, style, spaced_len=48,
                                generator=g)
        return img

    return fn, (model, label, lens, style)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _finite(out) -> None:
    for k, v in out.items():
        for t in (v if isinstance(v, list) else [v]):
            if isinstance(t, torch.Tensor) and t.is_floating_point() \
                    and not bool(torch.isfinite(t).all()):
                raise AssertionError(f"non-finite {k}")


def _dryrun_rank(rank: int, n: int, device: str, backend: Optional[str],
                 port: int) -> None:
    from handwriting_line_generation_tpu_torch.data.datasets import (
        forever, make_batcher)
    from handwriting_line_generation_tpu_torch.parallel.mesh import (
        barrier, init_distributed, make_mesh, rank_device, shutdown)
    from handwriting_line_generation_tpu_torch.training.gan_trainer import \
        GanTrainer

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(n),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    init_distributed(backend, device)
    dev = rank_device(device)
    if dev.type == "cuda":            # one build, before any rank loads
        if rank == 0:
            from handwriting_line_generation_tpu_torch import kernels
            kernels.build()
        barrier()
    n_model = 2 if n % 2 == 0 and n >= 4 else 1
    n_data = n // n_model
    cfg = _tiny_cfg()
    # one author group (a_batch 2 lines) a data index
    cfg.data.batch_size = n_data
    mesh = make_mesh(n_data, n_model)
    trainer = GanTrainer(cfg, device=dev)
    trainer.use_mesh(mesh, fsdp=n_model > 1)
    trainer.init_state(seed=0)
    batch = next(forever(make_batcher(cfg.data, "train",
                                      (mesh.data, mesh.data_index)), seed=0))
    args = (batch["image"], batch["label"], batch["label_lengths"])
    out = trainer.step_auto(*args, batch["fg_mask"], batch["width"],
                            batch["a_batch_size"])
    out2 = trainer.step_disc(*args, batch["width"], batch["a_batch_size"])
    out3 = trainer.step_gen_nostep(batch["label"], batch["label_lengths"],
                                   trainer.gen_spaced_len)
    for o in (out, out2, out3):
        _finite(o)
    if rank == 0:
        print(f"dryrun_multichip({n}): mesh={n_data}x{n_model}"
              f"{' fsdp' if n_model > 1 else ''} "
              f"auto={float(out['autoLoss']):.4f} "
              f"disc={float(out2['discriminatorLoss']):.4f} "
              f"gen={float(out3['generatorLoss']):.4f} ok", flush=True)
    barrier()
    shutdown()


def dryrun_multichip(n_devices: int, device="cuda",
                     backend: Optional[str] = None) -> None:
    """One auto, disc and gen lesson of the tiny GAN on ``n_devices`` ranks
    (see the module docstring), spawned here; raises with a rank's
    traceback if one fails."""
    if device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the ranks on the CPU")
    torch.multiprocessing.spawn(
        _dryrun_rank, args=(n_devices, device, backend, _free_port()),
        nprocs=n_devices, join=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m handwriting_line_generation_tpu_torch.graft_entry",
        description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None)
    args = ap.parse_args(argv)
    fn, ex = entry(args.device)
    img = fn(*ex)
    print("entry:", tuple(img.shape),
          "finite" if np.isfinite(img.cpu().numpy()).all() else "NON-FINITE")
    dryrun_multichip(args.n, args.device, args.backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
