"""Running-mean metric caches for per-curriculum-bin statistics (the
port's copy of the JAX package's ``learn/caches.py``, which is NumPy).

NumPy running means aggregated between log flushes and dumped into
``curriculum/info.pkl`` by the Runner. Host-side on purpose: they consume
the small per-iteration summaries of the training iteration.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


class DistCache:
    """Running mean of arbitrary arrays (metrics_caches.py:6-33)."""

    def __init__(self):
        self.cache: Dict[str, np.ndarray] = {}
        self.counts: Dict[str, float] = {}

    def log(self, **key_values):
        for k, v in key_values.items():
            v = np.asarray(v, dtype=np.float64)
            if k not in self.cache:
                self.cache[k] = np.zeros_like(v)
                self.counts[k] = 0.0
            n = self.counts[k]
            self.cache[k] = (self.cache[k] * n + v) / (n + 1)
            self.counts[k] = n + 1

    def get_summary(self) -> Dict[str, np.ndarray]:
        out = {f"dist/{k}": v.copy() for k, v in self.cache.items()}
        self.cache.clear()
        self.counts.clear()
        return out


class SlotCache:
    """Per-slot (curriculum-bin) running means (metrics_caches.py:47-78)."""

    def __init__(self, n: int):
        self.n = n
        self.cache: Dict[str, np.ndarray] = {}
        self.counts: Dict[str, np.ndarray] = {}

    def log(self, slots, **key_values):
        slots = np.asarray(slots, dtype=np.int64)
        for k, v in key_values.items():
            v = np.asarray(v, dtype=np.float64)
            if k not in self.cache:
                self.cache[k] = np.zeros(self.n)
                self.counts[k] = np.zeros(self.n)
            cnt = self.counts[k]
            mean = self.cache[k]
            for s, val in zip(slots, np.broadcast_to(v, slots.shape)):
                mean[s] = (mean[s] * cnt[s] + val) / (cnt[s] + 1)
                cnt[s] += 1

    def log_sums(self, key: str, sums, counts):
        """Merge PRE-aggregated per-slot (sum, count) arrays — the form the
        PPO update emits (learn/ppo.py sysid_residual per bin) —
        vectorized instead of the per-sample loop of :meth:`log`."""
        sums = np.asarray(sums, dtype=np.float64)
        counts = np.asarray(counts, dtype=np.float64)
        if key not in self.cache:
            self.cache[key] = np.zeros(self.n)
            self.counts[key] = np.zeros(self.n)
        cnt = self.counts[key]
        mean = self.cache[key]
        tot = cnt + counts
        nz = tot > 0
        mean[nz] = (mean[nz] * cnt[nz] + sums[nz]) / tot[nz]
        cnt[:] = tot

    def get_summary(self) -> Dict[str, np.ndarray]:
        out = {f"slot/{k}": v.copy() for k, v in self.cache.items()}
        for k in self.cache:
            self.cache[k][:] = 0
            self.counts[k][:] = 0
        return out


class DataCaches:
    """(ppo/__init__.py:36-44)"""

    def __init__(self, curriculum_bins: int = 1):
        self.slot_cache = SlotCache(curriculum_bins)
        self.dist_cache = DistCache()
