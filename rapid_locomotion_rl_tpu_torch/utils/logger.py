"""Local experiment logger (the port's copy of the JAX package's
``utils/logger.py``, which is plain Python).

Run layout mirrors the reference (`runs/<prefix>/...`):

    <logdir>/
      parameters.json      # full config snapshot (parameters.pkl analogue)
      metrics.pkl          # list of summary-row dicts (metrics.pkl analogue)
      metrics.jsonl        # same rows, human-greppable
      curriculum/info.pkl  # per-bin curriculum stats (appended)
      checkpoints/         # train-state checkpoints + deployment exports

Metric names follow the reference exactly
(``train/episode/rew_<term>/mean``, ``time_iter/mean``, ...), because the
learning-curve comparison keys on them."""

from __future__ import annotations

import json
import os
import pickle
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional


class MetricsLogger:
    """With ``write`` off (a rank other than 0 of a sharded run) it keeps
    its rows in memory and writes nothing."""

    def __init__(self, logdir: str, write: bool = True):
        self.logdir = logdir
        self.write = write
        if write:
            os.makedirs(logdir, exist_ok=True)
            os.makedirs(os.path.join(logdir, "checkpoints"), exist_ok=True)
            os.makedirs(os.path.join(logdir, "curriculum"), exist_ok=True)
        self._store: Dict[str, List[float]] = defaultdict(list)
        self._rows: List[Dict[str, Any]] = []
        self._timers: Dict[str, float] = {}

    # -- ml_logger-style timing (ppo/__init__.py:97, :205-211) -----------
    def start(self, *names):
        now = time.time()
        for n in names:
            self._timers[n] = now

    def split(self, name: str) -> float:
        now = time.time()
        dt = now - self._timers.get(name, now)
        self._timers[name] = now
        return dt

    def since(self, name: str) -> float:
        return time.time() - self._timers.get(name, time.time())

    # -- metric accumulation ---------------------------------------------
    def store_metrics(self, **kv):
        for k, v in kv.items():
            if v is None:
                continue
            self._store[k].append(float(v))

    def log_metrics_summary(self, key_values: Optional[Dict[str, Any]] = None):
        """Flush accumulated metrics as a `<name>/mean` summary row."""
        row: Dict[str, Any] = {}
        for k, vals in self._store.items():
            if not vals:
                continue
            row[f"{k}/mean"] = sum(vals) / len(vals)
        self._store.clear()
        if key_values:
            row.update(key_values)
        row["_timestamp"] = time.time()
        self._rows.append(row)
        if not self.write:
            return row
        with open(os.path.join(self.logdir, "metrics.pkl"), "wb") as f:
            pickle.dump(self._rows, f)
        with open(os.path.join(self.logdir, "metrics.jsonl"), "a") as f:
            f.write(json.dumps(row) + "\n")
        return row

    # -- artifacts --------------------------------------------------------
    def log_params(self, params: Dict[str, Any]):
        if not self.write:
            return
        with open(os.path.join(self.logdir, "parameters.json"), "w") as f:
            json.dump(params, f, indent=2, default=str)

    def save_pkl(self, obj: Any, path: str, append: bool = False):
        if not self.write:
            return
        full = os.path.join(self.logdir, path)
        os.makedirs(os.path.dirname(full), exist_ok=True)
        if append and os.path.exists(full):
            with open(full, "rb") as f:
                data = pickle.load(f)
            if not isinstance(data, list):
                data = [data]
            data.append(obj)
        else:
            data = [obj] if append else obj
        with open(full, "wb") as f:
            pickle.dump(data, f)
