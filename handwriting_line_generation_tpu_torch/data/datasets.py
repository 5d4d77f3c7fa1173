"""Host-side batching of handwriting lines, numpy only.

Counterpart of the batching half of
``handwriting_line_generation_tpu/data/datasets.py``: line records, the
width- and label-bucketed batch assembly (pad value -1 = paper), the flat
and author-grouped batchers, the side caches of precomputed alignments and
style banks, the epoch-cycling iterator, a background prefetcher, and the
foreground mask — Otsu's threshold and a 9x9 elliptic dilation, bit-equal to
OpenCV's, without OpenCV.  The record sources (IAM, RIMES, the synthetic
renderer) and ``make_batcher`` are not ported yet (ROADMAP.md); callers
build :class:`LineRecord` lists themselves.

Batch contract (batch-major):
  image          [B, H, Wb, 1] float32
  label          [B, Lb]       int32
  label_lengths  [B]           int32
  width          [B]           int32 (true unpadded width)
  fg_mask        [B, H, Wb, 1] float32 (optional)
  gt, author, rid  lists of str; a_batch_size int
"""

from __future__ import annotations

import dataclasses
import glob
import itertools
import queue
import threading
import warnings
from collections import defaultdict
from typing import Callable, Dict, Iterator, List, Sequence

import numpy as np

from handwriting_line_generation_tpu_torch.charset import Charset
from handwriting_line_generation_tpu_torch.config import DataConfig

PAD_VALUE = -1.0


@dataclasses.dataclass
class LineRecord:
    author: str
    gt: str
    load: Callable[[], np.ndarray]        # -> normalized [H, W] float32
    rid: str = ""                         # stable record id (side caches)


# ---------------------------------------------------------------------------
# Foreground mask
# ---------------------------------------------------------------------------


def _otsu_threshold(u8: np.ndarray) -> int:
    """OpenCV's Otsu threshold of a u8 image, step for step: the 256-bin
    histogram, double-precision class means updated in place (including
    the quirk that a skipped bin leaves ``mu1`` scaled by ``q1``), the first
    maximum of the between-class variance."""
    hist = np.bincount(u8.ravel(), minlength=256)
    scale = 1.0 / u8.size
    mu = 0.0
    for i in range(256):
        mu += i * float(hist[i])
    mu *= scale
    mu1 = q1 = 0.0
    max_sigma = 0.0
    max_val = 0
    eps = float(np.finfo(np.float32).eps)
    for i in range(256):
        p_i = hist[i] * scale
        mu1 *= q1
        q1 += p_i
        q2 = 1.0 - q1
        if min(q1, q2) < eps or max(q1, q2) > 1.0 - eps:
            continue
        mu1 = (mu1 + i * p_i) / q1
        mu2 = (mu - q1 * mu1) / q2
        sigma = q1 * q2 * (mu1 - mu2) * (mu1 - mu2)
        if sigma > max_sigma:
            max_sigma = sigma
            max_val = i
    return max_val


def _ellipse(size: int) -> np.ndarray:
    """OpenCV's ``MORPH_ELLIPSE`` structuring element, ``size x size``."""
    r = c = size // 2
    elem = np.zeros((size, size), np.uint8)
    for i in range(size):
        dy = i - r
        if abs(dy) <= r:
            dx = int(np.rint(c * np.sqrt((r * r - dy * dy) / (r * r))))
            elem[i, max(c - dx, 0):min(c + dx + 1, size)] = 1
    return elem


ELLIPSE_9 = _ellipse(9)


def _dilate(img: np.ndarray, elem: np.ndarray) -> np.ndarray:
    """Grey dilation with the element centred; outside the image counts as
    0 (OpenCV's default border for dilation)."""
    r = elem.shape[0] // 2
    H, W = img.shape
    padded = np.pad(img, r)
    out = np.zeros_like(img)
    for i, j in zip(*np.nonzero(elem)):
        np.maximum(out, padded[i:i + H, j:j + W], out=out)
    return out


def fg_mask_of(img_norm: np.ndarray) -> np.ndarray:
    """Foreground mask in {0, 1}: Otsu binarisation of the u8 pixels (ink
    darker than the threshold), dilated by a 9x9 ellipse."""
    u8 = np.clip((1.0 - img_norm) * 128.0, 0, 255).astype(np.uint8)
    ink = np.where(u8 > _otsu_threshold(u8), 0, 255).astype(np.uint8)
    return (_dilate(ink, ELLIPSE_9) / 255.0).astype(np.float32)


# ---------------------------------------------------------------------------
# Batchers
# ---------------------------------------------------------------------------


def _bucket(value: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if value <= b:
            return b
    return buckets[-1]


def _assemble(records: List[LineRecord], charset: Charset,
              width_buckets, label_buckets, with_fg: bool,
              a_batch_size: int) -> Dict:
    imgs = [r.load() for r in records]
    H = imgs[0].shape[0]
    wb = _bucket(max(i.shape[1] for i in imgs), width_buckets)
    labels = [charset.encode(r.gt) for r in records]
    lb = _bucket(max(max(len(l) for l in labels), 1), label_buckets)

    B = len(records)
    image = np.full((B, H, wb, 1), PAD_VALUE, np.float32)
    label = np.zeros((B, lb), np.int32)
    lens = np.zeros(B, np.int32)
    widths = np.zeros(B, np.int32)
    fg = np.zeros((B, H, wb, 1), np.float32) if with_fg else None
    for i, (img, lab) in enumerate(zip(imgs, labels)):
        w = min(img.shape[1], wb)
        image[i, :, :w, 0] = img[:, :w]
        widths[i] = w
        n = min(len(lab), lb)
        label[i, :n] = lab[:n]
        lens[i] = n
        if with_fg:
            fg[i, :, :w, 0] = fg_mask_of(img[:, :w])
    out = {
        "image": image, "label": label, "label_lengths": lens,
        "width": widths, "gt": [r.gt for r in records],
        "author": [r.author for r in records],
        "rid": [r.rid for r in records],
        "a_batch_size": a_batch_size,
    }
    if with_fg:
        out["fg_mask"] = fg
    return out


class SideCaches:
    """Precomputed per-record side inputs: ``spaced_loc`` (cached
    alignments the trainer reads in place of live Viterbi/DTW) and
    ``style_loc`` (style banks; each line gets a random same-author style
    whose source group did not include the line)."""

    def __init__(self, cfg: DataConfig):
        self.spaced = None
        self.styles = None
        self._leaky_authors: set = set()
        if cfg.spaced_loc:
            self.spaced = np.load(cfg.spaced_loc, allow_pickle=False)
        self.identity_spaced = cfg.identity_spaced
        if cfg.style_loc:
            paths = sorted(glob.glob(cfg.style_loc))
            if not paths and not cfg.style_loc.endswith("*"):
                # a prefix path names its shard files
                paths = sorted(glob.glob(cfg.style_loc + "*"))
            paths = paths or [cfg.style_loc]
            by_author: Dict[str, List] = defaultdict(list)
            for p in paths:
                d = np.load(p, allow_pickle=True)
                ids = d["ids"] if "ids" in d else [""] * len(d["authors"])
                for s, a, i in zip(d["styles"], d["authors"], ids):
                    by_author[str(a)].append((s, set(str(i).split(";"))))
            self.styles = dict(by_author)

    @property
    def active(self) -> bool:
        return (self.spaced is not None or self.identity_spaced
                or self.styles is not None)

    def attach(self, batch: Dict, records: List[LineRecord],
               rng: np.random.Generator) -> None:
        B = len(records)
        if self.identity_spaced:
            # the label itself is the "alignment" (one frame per char)
            batch["spaced_label"] = batch["label"].copy()
        elif self.spaced is not None:
            T = batch["image"].shape[2] // 4
            arr = np.zeros((B, T), np.int32)
            for i, r in enumerate(records):
                row = np.asarray(self.spaced[r.rid], np.int32).ravel()
                arr[i, :min(row.size, T)] = row[:T]
            batch["spaced_label"] = arr
        if self.styles is not None:
            rows = []
            for r in records:
                cand = self.styles.get(r.author)
                if not cand:
                    raise KeyError(f"style_loc bank has no styles for "
                                   f"author {r.author!r}")
                ok = [s for s, ids in cand if r.rid not in ids]
                if not ok:
                    if r.author not in self._leaky_authors:
                        self._leaky_authors.add(r.author)
                        warnings.warn(
                            f"style_loc: every bank row for author "
                            f"{r.author!r} was computed from a group "
                            f"containing record {r.rid!r}; falling back to "
                            f"ALL rows — identity may leak into style "
                            f"conditioning (rebuild the bank with more "
                            f"groups per author)", RuntimeWarning)
                    ok = [s for s, _ in cand]
                rows.append(ok[int(rng.integers(len(ok)))])
            batch["style"] = np.stack(rows).astype(np.float32)


class LineBatcher:
    """Flat line batches (HWR pretraining)."""

    def __init__(self, records: List[LineRecord], charset: Charset,
                 batch_size: int, cfg: DataConfig, with_fg: bool = False):
        self.records = records
        self.charset = charset
        self.batch_size = batch_size
        self.cfg = cfg
        self.with_fg = with_fg
        self.caches = SideCaches(cfg)

    def __len__(self):
        return max(1, len(self.records) // self.batch_size)

    def batches(self, rng: np.random.Generator,
                shuffle: bool = True) -> Iterator[Dict]:
        order = np.arange(len(self.records))
        if shuffle:
            rng.shuffle(order)
        for i in range(0, len(order) - self.batch_size + 1, self.batch_size):
            recs = [self.records[j] for j in order[i:i + self.batch_size]]
            batch = _assemble(recs, self.charset, self.cfg.width_buckets,
                              self.cfg.label_buckets, self.with_fg, 1)
            if self.caches.active:
                self.caches.attach(batch, recs, rng)
            yield batch


class AuthorBatcher:
    """Author-grouped batches: ``batch_size`` authors x ``a_batch_size``
    lines.  An author's leftover lines are filled up from its first lines;
    with ``pair_combinations`` (RIMES, ``a_batch_size`` 2) every pair of an
    author's lines is a group."""

    def __init__(self, records: List[LineRecord], charset: Charset,
                 batch_size: int, a_batch_size: int, cfg: DataConfig,
                 with_fg: bool = True, pair_combinations: bool = False):
        self.charset = charset
        self.batch_size = batch_size
        self.a = a_batch_size
        self.cfg = cfg
        self.with_fg = with_fg
        self.caches = SideCaches(cfg)
        by_author: Dict[str, List[LineRecord]] = defaultdict(list)
        for r in records:
            by_author[r.author].append(r)
        self.groups: List[List[LineRecord]] = []
        for _, lines in sorted(by_author.items()):
            if pair_combinations and self.a == 2:
                self.groups.extend(
                    [list(p) for p in itertools.combinations(lines, 2)])
                continue
            for i in range(len(lines) // self.a):
                self.groups.append(lines[i * self.a:(i + 1) * self.a])
            leftover = len(lines) % self.a
            if leftover:
                fill = self.a - leftover
                self.groups.append(lines[:fill] + lines[-leftover:])

    def __len__(self):
        return max(1, len(self.groups) // self.batch_size)

    def batches(self, rng: np.random.Generator,
                shuffle: bool = True) -> Iterator[Dict]:
        order = np.arange(len(self.groups))
        if shuffle:
            rng.shuffle(order)
        for i in range(0, len(order) - self.batch_size + 1, self.batch_size):
            recs = [r for j in order[i:i + self.batch_size]
                    for r in self.groups[j]]
            batch = _assemble(recs, self.charset, self.cfg.width_buckets,
                              self.cfg.label_buckets, self.with_fg, self.a)
            if self.caches.active:
                self.caches.attach(batch, recs, rng)
            yield batch


def forever(batcher, seed: int = 0, shuffle: bool = True) -> Iterator[Dict]:
    """Infinite epoch-cycling iterator (the trainers are iteration-based)."""
    epoch = 0
    while True:
        rng = np.random.default_rng(seed + epoch)
        yield from batcher.batches(rng, shuffle)
        epoch += 1


_END = object()


class Prefetcher:
    """Keeps up to ``depth`` items of ``iterator`` assembled ahead on one
    daemon thread, so host-side batch assembly overlaps device work.  An
    exception in the iterator is raised in the consumer; the end of a
    finite iterator ends this one."""

    def __init__(self, iterator: Iterator[Dict], depth: int = 4):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._err = None

        def worker():
            try:
                for item in iterator:
                    self._q.put(item)
            except Exception as e:            # surfaced in the consumer
                self._err = e
            finally:
                self._q.put(_END)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is _END:
            self._q.put(_END)               # stays ended
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item
