"""Host-side datasets and batching, numpy only.

Counterpart of ``handwriting_line_generation_tpu/data/datasets.py``: the
record sources (IAM lines and words, RIMES lines, the synthetic renderer),
their page decode (:func:`~..utils.png.read_png_gray`, an LRU of decoded
pages) and height resize (:func:`.imageops.resize_cubic_u8`), the width-
and label-bucketed batch assembly (pad value -1 = paper), the flat and
author-grouped batchers, the side caches of precomputed alignments and
style banks, :func:`make_batcher`, the epoch-cycling iterator, a background
prefetcher, and the foreground mask — Otsu's threshold and a 9x9 elliptic
dilation, bit-equal to OpenCV's, without OpenCV.  The JAX package's
multi-host branch of ``make_batcher`` (per-process record shards) is not
here: the port trains in one process.

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
import functools
import glob
import itertools
import json
import os
import queue
import threading
import warnings
from collections import defaultdict
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from handwriting_line_generation_tpu_torch.charset import Charset
from handwriting_line_generation_tpu_torch.charset import \
    get_charset as _charset_named
from handwriting_line_generation_tpu_torch.config import DataConfig
from handwriting_line_generation_tpu_torch.data.iam import (
    parse_form_words, parse_form_xml,
)
from handwriting_line_generation_tpu_torch.data.imageops import \
    resize_cubic_u8
from handwriting_line_generation_tpu_torch.data.rimes import \
    parse_rimes_lines_xml
from handwriting_line_generation_tpu_torch.data.synthetic import (
    SyntheticCorpus, normalize_image,
)
from handwriting_line_generation_tpu_torch.parallel.mesh import (
    local_batch_size, shard_records_for_host,
)
from handwriting_line_generation_tpu_torch.utils.png import read_png_gray

PAD_VALUE = -1.0


@dataclasses.dataclass
class LineRecord:
    author: str
    gt: str
    load: Callable[[], np.ndarray]        # -> normalized [H, W] float32
    rid: str = ""                         # stable record id (side caches)


@functools.lru_cache(maxsize=48)
def _imread_gray(img_path: str) -> np.ndarray:
    """A decoded page, read-only, from an LRU of 48: every IAM form page
    holds ~9 line records, each of which would decode it again."""
    if not os.path.exists(img_path):
        raise FileNotFoundError(img_path)
    img = read_png_gray(img_path)
    img.setflags(write=False)
    return img


def load_crop_resize(img_path: str, bounds, img_height: int,
                     max_width: int) -> np.ndarray:
    """Page decode + line crop + cubic resize to ``img_height`` (width
    capped at ``max_width``; a line the cap leaves short is padded with
    paper, centred), normalized ``1 - px/128``."""
    img = _imread_gray(img_path)
    y0, y1, x0, x1 = bounds
    y0, x0 = max(0, y0), max(0, x0)
    img = img[y0:y1, x0:x1]
    if img.shape[0] != img_height:
        pct = img_height / img.shape[0]
        if img.shape[1] * pct > max_width:
            pct = max_width / img.shape[1]
        img = resize_cubic_u8(img, pct)
        if img.shape[0] < img_height:
            d = img_height - img.shape[0]
            img = np.pad(img, ((d // 2, d - d // 2), (0, 0)),
                         constant_values=255)
    elif img.shape[1] > max_width:
        img = resize_cubic_u8(img, max_width / img.shape[1])
    return normalize_image(img)


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
# Corpora
# ---------------------------------------------------------------------------


def iam_records(data_dir: str, split: str, img_height: int,
                max_width: int, sets_path: Optional[str] = None,
                words: bool = False) -> List[LineRecord]:
    """IAM line (or word) records of a split: the form names from a
    ``sets.json`` (``{split: [form names]}``) beside the data or given,
    each form's ``xmls/<name>.xml`` and ``forms/<name>.png``."""
    sets_path = sets_path or os.path.join(data_dir, "sets.json")
    with open(sets_path) as f:
        names = json.load(f)[split]
    parse = parse_form_words if words else parse_form_xml
    records: List[LineRecord] = []
    for name in names:
        lines, writer = parse(os.path.join(data_dir, "xmls", name + ".xml"))
        img_path = os.path.join(data_dir, "forms", name + ".png")
        for j, line in enumerate(lines):
            records.append(LineRecord(
                author=writer, gt=line.text,
                load=(lambda p=img_path, b=line.bounds:
                      load_crop_resize(p, b, img_height, max_width)),
                rid=f"{name}-{j}"))
    return records


def rimes_records(data_dir: str, split: str, img_height: int,
                  max_width: int) -> List[LineRecord]:
    """RIMES line records; the "authors" are pages."""
    xml_name = ("lines_training_2011.xml" if split == "train"
                else "lines_eval_2011_annotated.xml")
    pages = parse_rimes_lines_xml(os.path.join(data_dir, xml_name))
    records: List[LineRecord] = []
    for image, lines in pages.items():
        img_path = os.path.join(data_dir, "images_gray", image)
        for j, line in enumerate(lines):
            records.append(LineRecord(
                author=image, gt=line.text,
                load=(lambda p=img_path, b=line.bounds:
                      load_crop_resize(p, b, img_height, max_width)),
                rid=f"{image}-{j}"))
    return records


def synthetic_records(split: str, img_height: int, charset: Charset,
                      n_authors: int = 8, lines_per_author: int = 24,
                      version: int = 2, **kw) -> List[LineRecord]:
    """Records of the seeded synthetic corpus of a split (seed 0 train, 1
    valid, 2 test).  From version 3 the held-out splits draw disjoint
    author ids (offsets 100000, 200000), so validation measures unseen
    writer styles.  A line is rendered (and memoized) when first loaded."""
    seed = {"train": 0, "valid": 1, "test": 2}.get(split, 3)
    offset = 0
    if version >= 3:
        offset = {"train": 0, "valid": 100_000, "test": 200_000}.get(
            split, 300_000)
    corpus = SyntheticCorpus(n_authors, lines_per_author, charset,
                             img_height, seed=seed, version=version,
                             author_offset=offset, **kw)
    return [LineRecord(author=f"synth{corpus.records[i][0]:05d}",
                       gt=corpus.records[i][1],
                       load=(lambda c=corpus, j=i: c.get(j)[0]),
                       rid=f"syn-{split}-{i}")
            for i in range(len(corpus))]


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


def pad_batch(batch: Dict, width: int, label_len: int,
              spaced_len: int = 0) -> Dict:
    """``batch`` widened to ``width`` image columns, ``label_len`` label
    slots and ``spaced_len`` spaced-label frames (where it is narrower), as
    the batcher pads a shorter line in a wider bucket: paper-white columns
    (255 for u8 pixels), background fg mask, blank labels."""
    def pad(a, n, axis, value):
        if a is None or a.shape[axis] >= n:
            return a
        widths = [(0, 0)] * a.ndim
        widths[axis] = (0, n - a.shape[axis])
        return np.pad(np.asarray(a), widths, constant_values=value)
    image = batch["image"]
    out = dict(batch, image=pad(image, width, 2, 255 if image.dtype ==
                                np.uint8 else PAD_VALUE),
               label=pad(batch["label"], label_len, 1, 0))
    for key, n, axis in (("fg_mask", width, 2), ("spaced_label",
                                                 spaced_len, 1)):
        if batch.get(key) is not None:
            out[key] = pad(batch[key], n, axis, 0)
    return out


def forever(batcher, seed: int = 0, shuffle: bool = True) -> Iterator[Dict]:
    """Infinite epoch-cycling iterator (the trainers are iteration-based);
    epoch ``e`` shuffles with ``default_rng(seed + e)``.  An epoch that
    yields no batch (fewer records or groups than one batch) raises
    ``ValueError`` instead of cycling for ever."""
    epoch = 0
    while True:
        rng = np.random.default_rng(seed + epoch)
        n = 0
        for batch in batcher.batches(rng, shuffle):
            n += 1
            yield batch
        if n == 0:
            raise ValueError(f"an epoch of {type(batcher).__name__} holds "
                             f"no batch of {batcher.batch_size}")
        epoch += 1


def get_charset(cfg: DataConfig) -> Charset:
    """The charset a data config names (``iam``, ``rimes`` or a JSON)."""
    return _charset_named(cfg.charset)


def make_batcher(cfg: DataConfig, split: str,
                 shard: Tuple[int, int] = (1, 0)):
    """The batcher of ``cfg.dataset`` over ``split``: a
    :class:`LineBatcher` for ``iam_lines``/``iam_words``, else an
    :class:`AuthorBatcher` (fg masks as ``cfg.fg_masks`` says; RIMES pages
    paired every way when ``a_batch_size`` is 2).

    ``shard``: ``(n, i)``, share ``i`` of ``n`` data-parallel shares (a
    mesh's ``data`` size and this rank's data index): the records are
    whole authors dealt round-robin (every ``n``-th line for a line
    dataset), and the batch size is the share's: ``batch_size / n`` lines,
    or author groups for an author dataset."""
    charset = get_charset(cfg)
    if cfg.dataset == "synthetic":
        records = synthetic_records(split, cfg.img_height, charset,
                                    n_authors=cfg.synthetic_authors,
                                    lines_per_author=cfg.synthetic_lines,
                                    version=cfg.synthetic_version)
    elif cfg.dataset in ("iam_author", "iam_lines", "iam_words"):
        records = iam_records(cfg.data_dir, split, cfg.img_height,
                              cfg.max_width,
                              words=cfg.dataset == "iam_words")
    elif cfg.dataset == "rimes_author":
        records = rimes_records(cfg.data_dir, split, cfg.img_height,
                                cfg.max_width)
    else:
        raise ValueError(f"unknown dataset {cfg.dataset!r}")
    line_level = cfg.dataset in ("iam_lines", "iam_words")
    batch_size = cfg.batch_size
    n, i = shard
    if n > 1:
        if line_level:                # batch_size counts lines
            batch_size = local_batch_size(cfg.batch_size, 1, n)
        else:                         # batch_size counts author groups
            batch_size = local_batch_size(
                cfg.batch_size * cfg.a_batch_size, cfg.a_batch_size,
                n) // cfg.a_batch_size
        records = shard_records_for_host(
            records, n, i, by_author=None if line_level
            else (lambda r: r.author))
    if line_level:
        return LineBatcher(records, charset, batch_size, cfg,
                           with_fg=False)
    return AuthorBatcher(records, charset, batch_size, cfg.a_batch_size,
                         cfg, with_fg=cfg.fg_masks,
                         pair_combinations=cfg.dataset == "rimes_author")


_END = object()


class Prefetcher:
    """Keeps up to ``depth`` items of ``iterator`` assembled ahead on one
    daemon thread, so host-side batch assembly overlaps device work.  An
    exception in the iterator is raised in the consumer; the end of a
    finite iterator ends this one.  :meth:`close` stops the thread."""

    def __init__(self, iterator: Iterator[Dict], depth: int = 4):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._err = None
        self._stop = threading.Event()

        def put(item) -> bool:
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                for item in iterator:
                    if not put(item):
                        return
            except Exception as e:            # surfaced in the consumer
                self._err = e
            put(_END)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def close(self) -> None:
        """Stop the thread (once the item it is assembling is done) and wait
        for it; the iterator then ends."""
        self._stop.set()
        self._thread.join()
        self._q = queue.Queue()
        self._q.put(_END)

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
