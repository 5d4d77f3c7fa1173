"""Dataset visual-inspection dump.

    python -m handwriting_line_generation_tpu_torch.inspect_dataset \\
        -c CONFIG [-d train|valid] [-n BATCHES] [-o dataset_dump] \\
        [--augment] [--device cuda]

Counterpart of the repository's root ``inspect_dataset.py``: the first
``-n`` batches of ``make_batcher(cfg.data, split)`` (shuffled by
``default_rng(0)``), each line written as ``b<i>_<j>_line.png`` (RGB: the
line, with the ink centre line red, the top extent green and the bottom
blue at every second column, as ``ops.masks.line_geometry`` gives them),
``_mask.png`` (``make_mask(morph_kernel=9)``), ``_fg.png`` (the batch's fg
mask, when it has one) and with ``--augment`` ``_aug.png``: the config's
augmentation (``warp`` when none) applied on the device by
``ops.augment.apply_augmentation`` with a generator seeded from the batch
index, so a run writes the same files again.  ``gt.txt`` lists
``b<i>_<j>``, the author and the transcription; the last line printed is
the count and the widths' min/mean/max.  The masks and the augmentation
run on ``--device`` (``cuda`` unless named).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

# the overlay's colours, RGB: the root script's BGR tuples as its files
# hold them
CENTER, TOP, BOTTOM = (255, 0, 0), (0, 255, 0), (0, 0, 255)


def _u8(img):
    import numpy as np
    return ((1 - img) * 127.5).clip(0, 255).astype(np.uint8)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m handwriting_line_generation_tpu_torch.inspect_dataset",
        description="Dump a few batches of a dataset as images.")
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("-d", "--split", default="train")
    ap.add_argument("-n", "--batches", type=int, default=2)
    ap.add_argument("-o", "--out-dir", default="dataset_dump")
    ap.add_argument("--augment", action="store_true",
                    help="also dump the device-side augmented versions")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from handwriting_line_generation_tpu_torch.config import load_config
    from handwriting_line_generation_tpu_torch.data.datasets import \
        make_batcher
    from handwriting_line_generation_tpu_torch.device import resolve_device
    from handwriting_line_generation_tpu_torch.ops.augment import \
        apply_augmentation
    from handwriting_line_generation_tpu_torch.ops.masks import (
        line_geometry, make_mask,
    )
    from handwriting_line_generation_tpu_torch.utils.png import (
        write_png_gray, write_png_rgb,
    )

    device = resolve_device(args.device)
    cfg = load_config(args.config)
    b = make_batcher(cfg.data, args.split)
    os.makedirs(args.out_dir, exist_ok=True)
    out = lambda i, j, kind: os.path.join(args.out_dir, f"b{i}_{j}_{kind}.png")
    gts, widths = [], []
    rng = np.random.default_rng(0)
    for i, batch in enumerate(b.batches(rng)):
        if i >= args.batches:
            break
        host = np.asarray(batch["image"], np.float32)
        img = torch.from_numpy(host).to(device)
        with torch.no_grad():
            mask = make_mask(img, morph_kernel=9)
            tb, center = (t.cpu().numpy() for t in line_geometry(img, mask))
            mask = mask.cpu().numpy()
            aug = None
            if args.augment:
                gen = torch.Generator(device).manual_seed(i)
                aug = apply_augmentation(cfg.data.augmentation or "warp",
                                         img, None, gen)[0].cpu().numpy()
        for j in range(host.shape[0]):
            vis = np.repeat(_u8(host[j, :, :, 0])[..., None], 3, axis=2)
            w = int(batch["width"][j])
            for x in range(0, w, 2):
                vis[int(center[j, x]) % 64, x] = CENTER
                vis[int(tb[j, 0, x]) % 64, x] = TOP
                vis[int(tb[j, 1, x]) % 64, x] = BOTTOM
            write_png_rgb(out(i, j, "line"), vis)
            write_png_gray(out(i, j, "mask"),
                           (mask[j, :, :, 0] * 255).astype(np.uint8))
            if "fg_mask" in batch:
                write_png_gray(out(i, j, "fg"),
                               (batch["fg_mask"][j, :, :, 0] * 255
                                ).astype(np.uint8))
            if aug is not None:
                write_png_gray(out(i, j, "aug"), _u8(aug[j, :, :, 0]))
            gts.append(f"b{i}_{j}\t{batch['author'][j]}\t{batch['gt'][j]}")
            widths.append(w)
    with open(os.path.join(args.out_dir, "gt.txt"), "w") as f:
        f.write("\n".join(gts) + "\n")
    print(f"dumped {len(gts)} lines -> {args.out_dir}/ | width "
          f"min/mean/max = {min(widths)}/{sum(widths) // len(widths)}/"
          f"{max(widths)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
