"""Writes this directory's JAX checkpoint and the JAX package's render of
it, for the PyTorch port to load and match.

A test helper (it imports JAX and the JAX package); run from the repo root:

    JAX_PLATFORMS=cpu python tests/fixtures/jax_ckpt/make_fixture.py

It writes, through the JAX package's own ``save_checkpoint``:

* ``model_best.msgpack`` / ``.json`` — a GAN ``model_best`` (``{params,
  spectral}``) of ``configs/iam_gan_paper.json`` at the narrow widths of
  ``OVERRIDES`` (no recognizer, no style extractor: their trunks are
  64-512 wide whatever the config says), every leaf the seeded flax init
  plus seeded N(0, 0.05^2) so no zero bias hides a dropped term;
* ``render.npz`` — a fixed spaced class map, style vectors and the ten
  noise planes, and the generator's float32 image on them (``image``);
* ``fixture.json`` — the config path and the overrides.

``python ... make_fixture.py OUT_DIR`` writes the same files into OUT_DIR.
"""

import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..",
                                    ".."))
sys.path.insert(0, ROOT)

from handwriting_line_generation_tpu.config import (  # noqa: E402
    apply_overrides, load_config,
)
from handwriting_line_generation_tpu.models.hw_with_style import \
    HWWithStyle  # noqa: E402
from handwriting_line_generation_tpu.ops.spacing import onehot  # noqa: E402
from handwriting_line_generation_tpu.utils.checkpoint import \
    save_checkpoint  # noqa: E402

CONFIG = "configs/iam_gan_paper.json"
OVERRIDES = ["model.hwr.kind=none", "model.style.kind=none",
             "model.style.style_dim=16", "model.generator.dim=32",
             "model.spacer.dim=32", "model.discriminator.dim=8"]
B, T, SEED = 4, 24, 0


def build(out_dir: str) -> None:
    cfg = load_config(os.path.join(ROOT, CONFIG))
    apply_overrides(cfg, OVERRIDES)
    cfg.model.num_class = 80
    model = HWWithStyle(cfg.model)
    image = jnp.zeros((B, 64, 4 * T, 1))
    labels = jnp.ones((B, 8), jnp.int32)
    lens = jnp.full((B,), 8, jnp.int32)
    variables = model.init({"params": jax.random.PRNGKey(SEED),
                            "noise": jax.random.PRNGKey(SEED + 1)},
                           image, labels, lens, spaced_len=T,
                           method="init_all")
    rng = np.random.default_rng(SEED)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
                   ).astype(np.float32), variables["params"])
    spectral = jax.tree_util.tree_map(np.asarray, variables["spectral"])
    save_checkpoint(out_dir, "model_best",
                    {"params": params, "spectral": spectral},
                    meta={"iteration": 7, "monitor_value": 0.5})

    spaced = rng.integers(0, cfg.model.num_class, (B, T)) * \
        (rng.random((B, T)) < 0.5)
    style = rng.standard_normal((B, cfg.model.style.style_dim))
    hw = [(4, T), (8, T), (16, T), (32, 2 * T), (64, 4 * T)]
    noise = [rng.standard_normal((B, h, w, 1)).astype(np.float32)
             for h, w in hw for _ in range(2)]
    img = model.apply({"params": params}, onehot(jnp.asarray(spaced),
                                                 cfg.model.num_class),
                      jnp.asarray(style, jnp.float32), noise=noise,
                      method=lambda m, o, s, noise: m.generator(
                          o, s, noise=noise))
    np.savez(os.path.join(out_dir, "render.npz"),
             spaced=spaced.astype(np.int32),
             style=style.astype(np.float32),
             image=np.asarray(img, np.float32),
             **{f"noise{i}": n for i, n in enumerate(noise)})
    with open(os.path.join(out_dir, "fixture.json"), "w") as f:
        json.dump({"config": CONFIG, "overrides": OVERRIDES}, f, indent=1)


if __name__ == "__main__":
    build(sys.argv[1] if len(sys.argv) > 1 else os.path.dirname(
        os.path.abspath(__file__)))
