"""Generation CLI of the port.

    python -m handwriting_line_generation_tpu_torch.generate -c CONFIG \\
        -k RUN_DIR [-s STYLES.npz] [-m MODE] [-t TEXT | --text-file F] \\
        [-a AUTHOR] [-n COUNT] [-o OUT_DIR] [--seed S] \\
        [--from-image PNG --to-image PNG] [--override PATH=VALUE ...] \\
        [--device cuda]

Counterpart of the repository's root ``generate.py`` (which stays JAX), the
scriptable form of the reference's mode menu (``generate.py:259-788``):
``render`` (the text in random interpolated bank styles, 'R'), ``interp``
(a sweep between two bank styles), ``stretch`` ('s'), ``math`` (``a - b +
c``, 'm'), ``author`` (one author's styles, 'a'), ``mturk`` (one random
style a line, 't'), ``from-to`` (a sweep between the styles of two
handwriting images, 'f') and ``vae`` (styles from N(0, I), 'v').  The
weights are ``checkpoint-latest``'s; images go to
``<OUT_DIR>/<mode>_<i:03d>.png``.  ``-a`` is the author, so config
overrides take ``--override`` only (``--override
model.generator.fused_epilogue=true`` runs the epilogue kernel).  The
device is ``cuda`` unless ``--device`` names another.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import numpy as np

MODES = ["render", "interp", "stretch", "math", "author", "mturk",
         "from-to", "vae"]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m handwriting_line_generation_tpu_torch.generate",
        description="Render handwritten lines from a trained model.")
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("-k", "--checkpoint", required=True)
    ap.add_argument("-s", "--styles", default=None,
                    help="styles .npz (required except in from-to and vae "
                         "modes)")
    ap.add_argument("-m", "--mode", default="render", choices=MODES)
    ap.add_argument("--from-image", default=None,
                    help="from-to mode: source handwriting image (PNG)")
    ap.add_argument("--to-image", default=None,
                    help="from-to mode: target handwriting image (PNG)")
    ap.add_argument("-t", "--text", default="the quick brown fox")
    ap.add_argument("--text-file", default=None,
                    help="file with one line of text per render")
    ap.add_argument("-a", "--author", default=None)
    ap.add_argument("-n", "--count", type=int, default=8)
    ap.add_argument("-o", "--out-dir", default="generated")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--override", action="append", default=[],
                    metavar="PATH=VALUE",
                    help="nested config override, e.g. "
                         "--override model.generator.fused_epilogue=true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    return ap


def style_of_image(path: str, model, img_height: int, device) -> np.ndarray:
    """The packed style of one handwriting image: read as grey, resized by
    cubic interpolation to ``img_height`` rows and a width that keeps the
    aspect, rounded down to a multiple of 4."""
    import torch

    from handwriting_line_generation_tpu_torch.data.imageops import \
        resize_cubic_to_u8
    from handwriting_line_generation_tpu_torch.data.synthetic import \
        normalize_image
    from handwriting_line_generation_tpu_torch.inference.styles import \
        StyleExtractor
    from handwriting_line_generation_tpu_torch.utils.png import read_png_gray
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    img = read_png_gray(path)
    h = img_height
    w = max(4, round(img.shape[1] * h / img.shape[0]) // 4 * 4)
    img = resize_cubic_to_u8(img, (w, h))
    x = torch.from_numpy(normalize_image(img)[None, :, :, None])
    frames = torch.tensor([max(1, w // 4)])
    style, _ = StyleExtractor(model, device=device).extract(
        x.to(device), frames.to(device), 1)
    return style[0].float().cpu().numpy()


def render_mode(args, session, cfg, data, ap=None) -> np.ndarray:
    """The images ``[N, 64, W, 1]`` of ``args.mode``."""
    from handwriting_line_generation_tpu_torch.inference.styles import \
        styles_by_author
    bank = data["styles"] if data else None
    if args.text_file:
        with open(args.text_file) as f:
            texts = [ln.rstrip("\n") for ln in f if ln.strip()]
    else:
        texts = [args.text] * args.count
    rng = np.random.default_rng(args.seed)
    if args.mode == "render":
        return session.random_interpolated(texts, bank, seed=args.seed)
    if args.mode == "interp":
        a, b = bank[rng.integers(0, len(bank), 2)]
        return session.interpolate(texts[0], a, b, steps=args.count,
                                   seed=args.seed)
    if args.mode == "stretch":
        style = bank[rng.integers(0, len(bank))]
        return np.concatenate(session.stretch_sweep(texts[0], style,
                                                    seed=args.seed), axis=0)
    if args.mode == "math":
        a, b, c = bank[rng.integers(0, len(bank), 3)]
        return session.style_math(texts[0], a, b, c, seed=args.seed)
    if args.mode == "author":
        by = styles_by_author(data)
        author = args.author or sorted(by)[0]
        return session.author_samples(texts, by, author, seed=args.seed)
    if args.mode == "vae":
        # styles from the VAE prior N(0, I) (generate.py:444-470;
        # meaningful with a VAE-trained extractor, style.vae=true)
        z = rng.standard_normal(
            (len(texts), cfg.model.style.style_dim)).astype(np.float32)
        return session.render(texts, z, seed=args.seed)
    if args.mode == "from-to":
        if not (args.from_image and args.to_image):
            ap.error("from-to mode needs --from-image and --to-image")
        h = cfg.data.img_height
        a, b = (style_of_image(p, session.model, h, session.device)
                for p in (args.from_image, args.to_image))
        return session.interpolate(texts[0], a, b, steps=args.count,
                                   seed=args.seed)
    return np.stack(session.mturk_batch(texts, bank, seed=args.seed))


def main(argv: Optional[List[str]] = None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.mode not in ("from-to", "vae") and not args.styles:
        ap.error("-s/--styles is required except in from-to/vae modes")
    from handwriting_line_generation_tpu_torch.config import (
        apply_overrides, load_config,
    )
    from handwriting_line_generation_tpu_torch.data.datasets import \
        get_charset
    from handwriting_line_generation_tpu_torch.inference.generate import (
        GenerationSession, to_uint8,
    )
    from handwriting_line_generation_tpu_torch.inference.load import \
        load_model
    from handwriting_line_generation_tpu_torch.inference.styles import \
        load_styles
    from handwriting_line_generation_tpu_torch.utils.png import \
        write_png_gray
    cfg = apply_overrides(load_config(args.config), args.override)
    model, _ = load_model(cfg, args.checkpoint, device=args.device)
    session = GenerationSession(model, get_charset(cfg.data),
                                device=args.device)
    data = load_styles(args.styles) if args.styles else None
    imgs = render_mode(args, session, cfg, data, ap)
    os.makedirs(args.out_dir, exist_ok=True)
    for i in range(imgs.shape[0]):
        write_png_gray(os.path.join(args.out_dir, f"{args.mode}_{i:03d}.png"),
                       to_uint8(imgs[i]))
    print(f"wrote {imgs.shape[0]} images to {args.out_dir}/", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
