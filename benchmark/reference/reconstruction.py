"""The reference of a reconstruction request, and the numbers that judge
one.

A request is a batch of u8 lines with their transcripts, dequantized on
the card, through ``StyleExtractor.reconstruct`` (``HWWithStyle
.autoencode``): the recognizer, its frames past each line's ink set to
blank; the char style encoder over each author's lines; the CTC forced
alignment of the masked prediction to the transcript (``viterbi_align``);
the generator regenerating every line from its spaced label in its
author's style, the noise planes drawn from a ``torch.Generator`` seeded
with the request's seed.  Its outputs: the reconstructions, the spaced
labels, one packed style an author, and (read by a hook) the masked
log-probabilities.

The judgement follows the request stage by stage, each stage given the
program's own output of the stage before it:

* ``pred_gap``: the widest gap between the program's and the reference's
  masked log-probabilities over every line's frames;
* ``style_gap``: over the authors, the largest ``|style - ref| / |ref|``;
* ``spaced_mismatch``: the positions where the program's spaced labels
  differ from the reference's ``viterbi_align`` of the program's own
  prediction (exact: the alignment is discrete, and its tie-breaks are
  part of it);
* ``path_score_gap``: over the lines, the largest ``|best - path|`` in
  nats, ``path`` the float64 sum of the program's prediction along its
  spaced label, ``best`` the best path's score from :func:`best_path_score`,
  a float64 dynamic programme written from the definition of the CTC
  lattice; a path that is no path of the lattice can score above the best,
  so the gap counts both ways;
* ``image_gap``: over the lines, the largest ``|recon - ref| / |ref|`` (L2
  over the line's pixels), the reference regenerating the program's spaced
  labels in the program's styles with the same noise planes.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from reference.extraction import frames_of
from reference.generation import noise_planes
from reference.models.hw_with_style import pack_style
from reference.ops.align import viterbi_align
from reference.ops.augment import dequantize_image


@torch.no_grad()
def request(model, image_u8, width, labels, lens, a_batch: int, seed: int
            ) -> Dict:
    """The whole request by the reference model, as the program runs it:
    ``{"recon", "spaced", "styles", "pred"}`` (the control's output)."""
    image = dequantize_image(image_u8, width)
    frames = frames_of(width, image.shape[2])
    g = torch.Generator(image.device).manual_seed(seed)
    recon, aux = model.autoencode(image, labels, lens, a_batch,
                                  frame_lengths=frames, generator=g)
    return {"recon": recon.float(), "spaced": aux["spaced_label"],
            "styles": pack_style(aux["style"])[::a_batch].float(),
            "pred": aux["pred"].float()}


def best_path_score(log_probs: torch.Tensor, labels: torch.Tensor,
                    lens: torch.Tensor) -> torch.Tensor:
    """``[B]`` float64: the score of the best path through each line's CTC
    lattice, from the definition.  The lattice's states are the label with
    a blank before, between and after its characters (``S = 2L + 1``); a
    path enters at the first blank or the first character, moves each frame
    to the same state, the next, or past a blank to the next character
    when that character differs from the one before the blank, and leaves
    at the last character or the last blank.  Its score is the sum of the
    frames' log-probabilities of the states it visits."""
    lp = log_probs.double()
    B, T, _ = lp.shape
    L = labels.shape[1]
    S = 2 * L + 1
    dev = lp.device
    states = torch.zeros(B, S, dtype=torch.long, device=dev)
    states[:, 1::2] = labels.long()
    s = torch.arange(S, device=dev)
    inside = s[None, :] < (2 * lens.long()[:, None] + 1)
    prev2 = F.pad(states, (2, 0))[:, :S]
    jump = (states != 0) & (states != prev2) & (s[None, :] >= 2)
    ninf = torch.tensor(float("-inf"), dtype=torch.float64, device=dev)
    emit = torch.gather(lp, 2, states[:, None, :].expand(B, T, S))
    score = torch.where(inside & (s[None, :] < 2), emit[:, 0], ninf)
    for t in range(1, T):
        stay = score
        step = F.pad(score, (1, 0), value=float("-inf"))[:, :S]
        skip = torch.where(jump, F.pad(score, (2, 0),
                                       value=float("-inf"))[:, :S], ninf)
        best = torch.stack([stay, step, skip]).amax(dim=0)
        score = torch.where(inside, best + emit[:, t], ninf)
    last = 2 * lens.long()
    ends = torch.stack([score.gather(1, last[:, None])[:, 0],
                        score.gather(1, (last - 1).clamp(min=0)[:, None])
                        [:, 0]])
    return ends.amax(dim=0)


def path_score(log_probs: torch.Tensor, spaced: torch.Tensor
               ) -> torch.Tensor:
    """``[B]`` float64: the sum over frames of each line's log-probability
    of the class its spaced label holds there."""
    lp = log_probs.double()
    return torch.gather(lp, 2, spaced.long()[..., None])[..., 0].sum(dim=1)


@torch.no_grad()
def judge(model, image_u8, width, labels, lens, a_batch: int, seed: int,
          out: Dict) -> Dict[str, float]:
    """The five numbers for one request whose output (``recon``,
    ``spaced``, ``styles``, ``pred``) is ``out``."""
    dev = image_u8.device
    image = dequantize_image(image_u8, width)
    frames = frames_of(width, image.shape[2])
    style, pred = model.extract_style(image, a_batch, frame_lengths=frames)
    ref_styles = pack_style(style)[::a_batch].float()
    p = out["pred"].float().to(dev)
    s = out["styles"].float().to(dev)
    num = (s - ref_styles).norm(dim=1)
    den = ref_styles.norm(dim=1).clamp(min=1e-12)

    spaced = out["spaced"].long().to(dev)
    mismatch = int((spaced != viterbi_align(p, labels, lens).long()).sum())
    path_gap = (best_path_score(p, labels, lens)
                - path_score(p, spaced)).abs().max()

    B, T = spaced.shape
    # the generation reference draws from a generator seeded ``seed + 1``
    noise = noise_planes(model, B, T, seed - 1, torch.float32, dev)
    ref = model.generate_spaced(spaced, s.repeat_interleave(a_batch, dim=0),
                                noise=noise).float()
    img = out["recon"].float().to(dev)
    inum = (img - ref).flatten(1).norm(dim=1)
    iden = ref.flatten(1).norm(dim=1).clamp(min=1e-12)
    return {"pred_gap": float((p - pred.float()).abs().max()),
            "style_gap": float((num / den).max()),
            "spaced_mismatch": float(mismatch),
            "path_score_gap": float(path_gap),
            "image_gap": float((inum / iden).max())}
