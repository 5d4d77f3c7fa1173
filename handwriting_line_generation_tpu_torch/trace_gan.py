"""Where the time of the GAN's 7-lesson cycle goes on the card.

Builds the ``configs/iam_gan_paper.json`` trainer (the paper model:
``cnn_only`` recognizer, char style encoder, generator 256, spacer 128,
discriminator 64 with the medium and low heads; the frozen ``2tight``
perceptual encoder; Adam 2e-4, betas (0.5, 0.999); float32; seeded
weights unless checkpoints are given) at its B = 2 authors x 2 lines = 4,
on seeded u8 glyph lines of 64 x 1024 with labels at 72
(``profiling.glyph_batch``) for the image lessons and ``TextSampler`` labels at
96 (generated lines of 500 frames) for the text lessons, and prints:

* ms per lesson kind (count, no-step gen, auto, disc) and per 7-lesson
  cycle, by CUDA events, TF32 off and then on, and GAN-trained lines/s
  = 4 x 7 x 1000 / ms per cycle;
* per layer, by CUDA events with TF32 off: style extraction,
  ``viterbi_align``, the generator forward, the discriminator forward +
  backward, the perceptual encoder, the recognizer on a generated line
  (forward + backward to the image), the CTC kernel at (4, 500, 96), one
  per-group VJP through the autoencode graph, ``balance_and_merge`` and the
  main Adam step;
* over one profiled cycle, TF32 off (``profiling.profiled_window``): wall
  time, device busy time, the idle share 1 - busy / wall, and device time
  by kernel group and by kernel;
* ms per cycle in each precision (``profiling.by_precision``): float32
  with TF32 off, with TF32 on, and bf16, over 3 cycles after one.

    python -m handwriting_line_generation_tpu_torch.trace_gan

Needs a CUDA device.  Prints one JSON line last.
"""

from __future__ import annotations

import itertools
import json
import pathlib
from typing import Dict, List, Optional

import torch

from handwriting_line_generation_tpu_torch import profiling as prof
from handwriting_line_generation_tpu_torch.charset import IAM_CHARSET
from handwriting_line_generation_tpu_torch.config import load_config
from handwriting_line_generation_tpu_torch.models.hw_with_style import \
    _flat_style
from handwriting_line_generation_tpu_torch.ops import ctc
from handwriting_line_generation_tpu_torch.ops.align import viterbi_align
from handwriting_line_generation_tpu_torch.ops.augment import \
    dequantize_image
from handwriting_line_generation_tpu_torch.training.gan_trainer import (
    GanTrainer, _grads,
)
from handwriting_line_generation_tpu_torch.training.losses import \
    disc_hinge_loss
from handwriting_line_generation_tpu_torch.training.train_state import \
    balance_and_merge

CONFIG = (pathlib.Path(__file__).resolve().parents[1]
          / "configs/iam_gan_paper.json")
_cfg = load_config(str(CONFIG))
A = _cfg.data.a_batch_size                               # 2 lines an author
B = _cfg.data.batch_size * A                             # 4 lines
KINDS = ("count", "gen", "auto", "disc")


def trainer(device, seed: int = 0, pretrained_hwr: Optional[str] = None,
            encoder_weights: Optional[str] = None,
            dtype: str = "float32") -> GanTrainer:
    """The paper config's trainer in ``dtype``; ``pretrained_hwr`` /
    ``encoder_weights`` name port checkpoints (seeded weights without
    them)."""
    cfg = load_config(str(CONFIG))
    cfg.model.compute_dtype = dtype
    cfg.data.text_data = None           # the sampler's built-in text
    cfg.model.pretrained_hwr = pretrained_hwr
    cfg.trainer.encoder_weights = encoder_weights
    tr = GanTrainer(cfg, device=device)
    tr.init_state(seed)
    return tr


def batch(device, seed: int = 0) -> Dict:
    """A batch dict of ``B`` seeded u8 lines (2 author pairs) on the card:
    ``profiling.glyph_batch``'s lines, their text, the ink as the fg
    mask."""
    image, label, lens, width = prof.glyph_batch(B, seed, device)
    lab, n = label.cpu().numpy(), lens.cpu().numpy()
    return dict(image=image, label=label, label_lengths=lens, width=width,
                gt=[IAM_CHARSET.decode(lab[b, :n[b]]) for b in range(B)],
                a_batch_size=A, fg_mask=image < 128)


def cycle(tr: GanTrainer, batches, start: int = 0) -> List[Dict]:
    """One curriculum cycle (7 lessons) over ``batches``, an iterator."""
    n = len(tr.curriculum.stages[0][1])
    return [tr.run_lesson(tr.curriculum.get_lesson(i), batches, iteration=i)
            for i in range(start, start + n)]


def lesson_times(tr: GanTrainer, batches) -> Dict[str, float]:
    """ms of each lesson kind and of a whole cycle."""
    lessons = {k: next(l for l in tr.curriculum.distinct_lessons() if k in l)
               for k in KINDS}
    times = {k: prof.event_ms(lambda l=l: tr.run_lesson(l, batches))
             for k, l in lessons.items()}
    times["cycle"] = prof.event_ms(lambda: cycle(tr, batches), iters=5,
                                   warmup=1)
    return times


def layer_times(tr: GanTrainer, data: Dict) -> Dict[str, float]:
    """Per-layer ms (CUDA events), TF32 as set."""
    m, s = tr.model, tr.state
    image = dequantize_image(data["image"], data["width"])
    label, lens = data["label"], data["label_lengths"]
    frames = torch.clamp((data["width"] + 3) // 4, 1, image.shape[2] // 4)
    text = tr.text.get_batch(label_len=max(tr.cfg.data.label_buckets))
    tlab = torch.as_tensor(text["label"], device=tr.device)
    tlen = torch.as_tensor(text["label_lengths"], device=tr.device)
    T = tr.gen_spaced_len
    times = {}
    with torch.no_grad():
        style, pred = m.extract_style(image, A, frame_lengths=frames)
        times["style extraction (recognizer + style encoder)"] = \
            prof.event_ms(lambda: m.extract_style(image, A,
                                                  frame_lengths=frames))
        times["viterbi_align"] = prof.event_ms(
            lambda: viterbi_align(pred, label, lens))
        spaced = viterbi_align(pred, label, lens)
        g = s.generator
        times["generator forward (T = W/4)"] = prof.event_ms(
            lambda: m.generate_spaced(spaced, style, generator=g))
        gen_img, _ = m.generate(tlab, tlen, _flat_style(style), spaced_len=T,
                                generator=g)
        recon = m.generate_spaced(spaced, style, generator=g)
        times["perceptual encoder (2 applies)"] = prof.event_ms(
            lambda: tr._perceptual(image, recon))
    disc_params = [p for p, l in zip(s.params, s.labels) if l == "disc"]

    def disc_fwd_bwd():
        loss = disc_hinge_loss(m.discriminate(image), m.discriminate(recon))
        torch.autograd.grad(loss, disc_params)
    times["discriminator forward + backward (real + fake)"] = \
        prof.event_ms(disc_fwd_bwd)
    im = gen_img.detach().requires_grad_(True)
    gframes = torch.full((B,), T, device=tr.device)

    def recog_fwd_bwd():
        logp = ctc.mask_frames_to_blank(m.recognize(im), gframes)
        torch.autograd.grad(ctc.ctc_loss_fast(logp, tlab, tlen), im)
    times["recognizer on the generated line, fwd + bwd"] = \
        prof.event_ms(recog_fwd_bwd)
    lp = ctc.mask_frames_to_blank(m.recognize(im), gframes).detach()
    lab32, len32 = tlab.int().contiguous(), tlen.int().contiguous()
    times[f"ctc kernel fwd + bwd ({B}, {T}, {tlab.shape[1]})"] = \
        prof.event_ms(lambda: ctc._launch(lp.contiguous(), lab32, len32,
                                          True), 50)
    recon_g, _ = m.autoencode(image, label, lens, A, frame_lengths=frames,
                              generator=s.generator)
    ct = torch.randn_like(recon_g)
    times["one group's VJP through autoencode"] = prof.event_ms(
        lambda: _grads(recon_g, s.params, ct, retain_graph=True))
    groups = [_grads(recon_g, s.params, ct, retain_graph=True)
              for _ in range(5)]
    times["balance_and_merge"] = prof.event_ms(
        lambda: balance_and_merge(groups[0], groups[1:], [0.6, 0.5, 0.4,
                                                          0.75]))
    times["main Adam step (clip + zero-fill)"] = prof.event_ms(
        lambda: s.opt_main.step(groups[0]))
    return times


def report(tr: GanTrainer, batches, card: str = "") -> Dict:
    """Print lesson and cycle times and rates with TF32 off and on, the
    per-layer split and one profiled cycle; return them.  ``batches``: an
    endless iterator of image batch dicts.  Leaves TF32 off."""
    out = {}
    for on in (False, True):
        prof.set_tf32(on)
        key = "tf32" if on else "f32"
        times = lesson_times(tr, batches)
        out[f"lesson_ms_{key}"] = times
        out[f"lines_per_s_{key}"] = B * 7 * 1e3 / times["cycle"]
        print(f"GAN lessons (iam_gan_paper, B={B}, 64x{prof.W}, f32, TF32 "
              f"{'on' if on else 'off'}): "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items())
              + f"; {out[f'lines_per_s_{key}']:.1f} GAN-trained lines/s "
              f"{card}", flush=True)
    prof.set_tf32(False)
    layers = layer_times(tr, next(batches))
    for k, v in layers.items():
        print(f"  {k:48s} {v:9.3f} ms (B={B}, TF32 off) {card}")
    cycle(tr, batches)
    win = prof.profiled_window(lambda: cycle(tr, batches), n=1)
    prof.print_window("cycle", win, card=card)
    return {**out, "layers_ms": layers,
            **{k: v for k, v in win.items() if k != "kernels_ms"}}


def precision_ms(batches, card: str = "", **weights) -> Dict[str, float]:
    """ms per cycle in each precision (``weights``: the trainers'
    ``pretrained_hwr`` / ``encoder_weights``); prints the rates."""
    cycles = prof.by_precision(
        lambda dt: trainer("cuda", dtype=dt, **weights),
        lambda tr: cycle(tr, batches), iters=3, warmup=1)
    print(f"GAN cycle (iam_gan_paper, B={B}, 64x{prof.W}) by precision: "
          + ", ".join(f"{k} {v:.3f} ms ({B * 7 * 1e3 / v:.1f} lines/s)"
                      for k, v in cycles.items()) + f" {card}", flush=True)
    return cycles


def main() -> None:
    tr = trainer("cuda")
    batches = itertools.cycle([batch("cuda", s) for s in range(3)])
    out = report(tr, batches)
    del tr
    out["cycle_ms_by_precision"] = precision_ms(batches)
    print(json.dumps({"batch": B, "width": prof.W, **out,
                      "device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
