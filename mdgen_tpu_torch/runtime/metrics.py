"""Metric accumulation and logging: the port's own copy of
``mdgen_tpu/runtime/metrics.py`` (reference `mdgen/wrapper.py:52-62,132-165`,
`mdgen/logger.py:12-34`), held to the original by
``tests/test_torch_selfcontained.py``.

Numeric metrics are accumulated host-side as plain Python numbers (torch
tensors: ``float(t)`` first). ``flush(save=True)`` writes the same CSV as the
JAX package's pandas ``DataFrame.to_csv`` with the ``csv`` module: the GPU
host has no pandas.
"""
from __future__ import annotations

import csv
import logging
import os
import time
from collections import defaultdict

import numpy as np


def get_logger(name: str) -> logging.Logger:
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    level = os.environ.get("LOGGER_LEVEL", "INFO").upper()
    logger.setLevel(level)
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    model_dir = os.environ.get("MODEL_DIR")
    if model_dir:
        os.makedirs(model_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(model_dir, "log.out"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.propagate = False
    return logger


def _cell(value):
    """A CSV cell as pandas writes it: NaN as an empty cell."""
    return "" if isinstance(value, float) and value != value else value


class MetricLogger:
    """defaultdict(list) accumulator with iter_/train_/val_ prefixes and
    periodic nanmean flushes, with CSV output."""

    def __init__(self, model_dir=None):
        self._log = defaultdict(list)
        self.model_dir = model_dir
        self.last_time = time.time()
        self.iter_step = 0
        self.logger = get_logger("mdgen_tpu")

    def log(self, key: str, value, stage: str = "train"):
        if hasattr(value, "item"):
            value = np.asarray(value).mean().item() if getattr(value, "size", 1) > 1 else value.item()
        if stage == "train":
            self._log["iter_" + key].append(value)
        self._log[stage + "_" + key].append(value)

    def log_dict(self, metrics: dict, stage: str = "train"):
        for k, v in metrics.items():
            self.log(k, v, stage)

    def flush(self, prefix: str = "iter", extra: dict | None = None, save=False,
              epoch: int = 0, step: int = 0) -> dict:
        keys = [k for k in self._log if k.startswith(prefix + "_")]
        out = {}
        for k in keys:
            vals = [v for v in self._log[k] if isinstance(v, (int, float))]
            if vals:
                out[k] = float(np.nanmean(vals))
        out.update({"epoch": epoch, "step": step})
        if extra:
            out.update(extra)
        self.logger.info(str({k: round(v, 6) if isinstance(v, float) else v
                              for k, v in out.items()}))
        cols = {k: self._log[k] for k in keys if self._log[k]}
        if save and self.model_dir and cols:
            rows = max(len(v) for v in cols.values())
            with open(os.path.join(self.model_dir, f"{prefix}_{epoch}.csv"), "w",
                      newline="") as fh:
                w = csv.writer(fh)
                w.writerow([""] + list(cols))
                for i in range(rows):
                    w.writerow([i] + [_cell(v[i]) if i < len(v) else "" for v in cols.values()])
        for k in keys:
            del self._log[k]
        return out
