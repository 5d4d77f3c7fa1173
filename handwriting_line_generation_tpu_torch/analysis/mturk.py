"""Human (MTurk-style) real-vs-generated study tooling.

A copy of ``handwriting_line_generation_tpu/analysis/mturk.py`` (standard
library only), the counterpart of the reference's human-eval pipeline:
generation mode 't' renders study batches (``generate.py:529-637``),
``mturk_hwg.html`` is the form, and ``parse_mturk.py`` scores the result CSV
with gold-standard traps and a transcription check.  Here:

* :func:`score_study` — aggregate + per-worker stats over clean records;
* :func:`load_reference_csv` — adapter for the reference's raw MTurk export
  column layout (worker id col 15, gt col 31 'real'/'gold', answer cols
  32/33, transcription-check cols 34/35 — ``parse_mturk.py:19-60``);
* :func:`write_form` — standalone HTML study form for a set of images.

Record schema: ``{worker, gt: real|gen|gold, answered_real: bool,
transcription_ok: bool}`` (a 'gold' item is an obviously-generated trap the
worker must flag as generated).
"""

from __future__ import annotations

import csv
import html
from collections import defaultdict
from typing import Dict, Iterable, List


def load_reference_csv(path: str) -> List[Dict]:
    records = []
    with open(path) as f:
        reader = csv.reader(f, delimiter=",", quotechar='"')
        header = None
        for row in reader:
            if header is None:
                header = row
                continue
            answered_human = row[33] == "true"
            answered_gen = row[32] == "true"
            if answered_human == answered_gen:
                continue                     # anomalous double/blank answer
            gt = "gold" if row[31] == "gold" else (
                "real" if row[31] == "real" else "gen")
            ok = (row[34] == "false") if row[34] else (row[35] == "true")
            records.append({"worker": row[15], "gt": gt,
                            "answered_real": answered_human,
                            "transcription_ok": ok})
    return records


def score_study(records: Iterable[Dict],
                min_gold_accuracy: float = 1.0) -> Dict:
    """Aggregate study metrics.

    Workers failing the gold traps (accuracy < ``min_gold_accuracy``) or the
    transcription check are excluded from the headline numbers, mirroring
    the reference's approve/reject logic.
    """
    records = list(records)
    by_worker: Dict[str, List[Dict]] = defaultdict(list)
    for r in records:
        by_worker[r["worker"]].append(r)

    worker_stats = {}
    excluded = set()
    for w, rs in by_worker.items():
        gold = [r for r in rs if r["gt"] == "gold"]
        gold_right = sum(1 for r in gold if not r["answered_real"])
        trans_ok = sum(1 for r in rs if r["transcription_ok"])
        stats = {
            "n": len(rs),
            "gold_total": len(gold),
            "gold_right": gold_right,
            "transcription_ok": trans_ok,
        }
        gold_acc = gold_right / len(gold) if gold else 1.0
        trans_acc = trans_ok / len(rs) if rs else 1.0
        stats["gold_accuracy"] = gold_acc
        stats["transcription_accuracy"] = trans_acc
        if gold_acc < min_gold_accuracy or trans_acc < 0.5:
            excluded.add(w)
        worker_stats[w] = stats

    clean = [r for r in records
             if r["worker"] not in excluded and r["gt"] != "gold"]
    n_gen = sum(1 for r in clean if r["gt"] == "gen")
    n_real = sum(1 for r in clean if r["gt"] == "real")
    fooled = sum(1 for r in clean
                 if r["gt"] == "gen" and r["answered_real"])
    real_right = sum(1 for r in clean
                     if r["gt"] == "real" and r["answered_real"])
    correct = sum(1 for r in clean
                  if (r["gt"] == "real") == r["answered_real"])
    return {
        "n_records": len(records),
        "n_clean": len(clean),
        "n_workers": len(by_worker),
        "n_workers_excluded": len(excluded),
        # headline: fraction of generated lines judged real by clean workers
        "fool_rate": fooled / n_gen if n_gen else 0.0,
        "real_recognized_rate": real_right / n_real if n_real else 0.0,
        "accuracy": correct / len(clean) if clean else 0.0,
        "worker_stats": worker_stats,
    }


_FORM_TMPL = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>Handwriting study</title>
<style>
 body {{ font-family: sans-serif; max-width: 900px; margin: 2em auto; }}
 .item {{ margin: 1.5em 0; border-bottom: 1px solid #ccc; padding: 1em 0; }}
 img {{ max-width: 100%; image-rendering: auto; }}
</style></head><body>
<h2>Was this line written by a person or by a computer?</h2>
<p>For each image, choose an answer and type the text you read.</p>
<form method="post" action="{action}">
{items}
<button type="submit">Submit</button>
</form></body></html>
"""

_ITEM_TMPL = """<div class="item">
 <img src="{src}" alt="handwriting sample {i}">
 <div>
  <label><input type="radio" name="ans_{i}" value="real" required> person</label>
  <label><input type="radio" name="ans_{i}" value="gen"> computer</label>
 </div>
 <input type="text" name="text_{i}" placeholder="type what it says" size="60">
 <input type="hidden" name="id_{i}" value="{item_id}">
</div>
"""


def write_form(path: str, images: List[Dict], action: str = "#") -> None:
    """Render the study form; ``images`` = [{src, id}] (order pre-shuffled
    by the caller so real/generated/gold interleave)."""
    items = "".join(
        _ITEM_TMPL.format(i=i, src=html.escape(im["src"]),
                          item_id=html.escape(str(im["id"])))
        for i, im in enumerate(images))
    with open(path, "w") as f:
        f.write(_FORM_TMPL.format(items=items, action=html.escape(action)))
