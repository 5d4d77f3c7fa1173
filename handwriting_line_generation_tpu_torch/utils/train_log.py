"""Training log: a copy of ``handwriting_line_generation_tpu/utils/
train_log.py``'s ``TrainLog``.  Periodic entries keyed by iteration,
rolling averages over a window, ``sec_per_iter``, JSON / CSV / plot export.
In a multi-process run only rank 0 writes the JSON.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict, deque
from typing import Dict, List, Optional

import torch

from handwriting_line_generation_tpu_torch.parallel.mesh import is_writer


class TrainLog:
    def __init__(self, window: int = 250):
        self.entries: List[Dict] = []
        self.window = window
        self._rolling = defaultdict(lambda: deque(maxlen=window))
        self._last_t: Optional[float] = None

    def step(self, metrics: Dict[str, float]) -> None:
        """Record one step's metrics.  Values may be device tensors: they
        are held as they are and read at :meth:`record`, so logging forces
        no per-step device sync."""
        now = time.perf_counter()
        if self._last_t is not None:
            self._rolling["sec_per_iter"].append(now - self._last_t)
        self._last_t = now
        for k, v in metrics.items():
            self._rolling[k].append(v)

    def averages(self) -> Dict[str, float]:
        out = {}
        for k, v in self._rolling.items():
            if not v:
                continue
            if all(isinstance(x, torch.Tensor) for x in v):  # one transfer
                v = torch.stack([x.detach().double().reshape(())
                                 for x in v]).tolist()
            out[k] = float(sum(float(x) for x in v) / len(v))
        return out

    def record(self, iteration: int, extra: Optional[Dict] = None) -> Dict:
        entry = {"iteration": iteration, **self.averages(), **(extra or {})}
        self.entries.append(entry)
        return entry

    def save(self, path: str) -> None:
        """Atomic JSON write of the entries (rank 0 alone)."""
        if not is_writer():
            return
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.entries, f)
        os.replace(tmp, path)

    @staticmethod
    def load(path: str) -> "TrainLog":
        log = TrainLog()
        with open(path) as f:
            log.entries = json.load(f)
        return log

    def resume_from(self, path: str, upto_iteration: int) -> None:
        """Prepend a previous run's entries up to ``upto_iteration``."""
        if not os.path.exists(path):
            return
        try:
            prev = TrainLog.load(path)
        except (ValueError, OSError) as e:
            import logging
            logging.getLogger(__name__).warning(
                "train log %s unreadable (%s); starting curve history "
                "fresh", path, e)
            return
        self.entries = [e for e in prev.entries
                        if e.get("iteration", 0) <= upto_iteration] \
            + self.entries

    def export_csv(self, path: str) -> None:
        keys = sorted({k for e in self.entries for k in e})
        with open(path, "w") as f:
            f.write(",".join(keys) + "\n")
            for e in self.entries:
                f.write(",".join(str(e.get(k, "")) for k in keys) + "\n")

    def plot(self, path: str, keys: Optional[List[str]] = None) -> None:
        """Loss-curve PNG export (needs matplotlib)."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        keys = keys or sorted({k for e in self.entries
                               for k in e if k != "iteration"})
        fig, ax = plt.subplots(figsize=(10, 6))
        for k in keys:
            xs = [e["iteration"] for e in self.entries if k in e]
            ys = [e[k] for e in self.entries if k in e]
            if xs:
                ax.plot(xs, ys, label=k)
        ax.set_xlabel("iteration")
        ax.legend(fontsize=7)
        fig.savefig(path, dpi=100)
        plt.close(fig)
