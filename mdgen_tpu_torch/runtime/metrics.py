"""Metric logging: the JAX package's ``mdgen_tpu/runtime/metrics.py``
(logging, os, time and numpy), executed by file path and shared. Its
``flush(save=True)`` writes the CSV with pandas, which the GPU host lacks;
:class:`MetricLogger` writes the same CSV with the ``csv`` module."""
from __future__ import annotations

import csv
import os

from .._shared import load_module

_metrics = load_module("mdgen_tpu_torch._jax_metrics", "mdgen_tpu/runtime/metrics.py")
get_logger = _metrics.get_logger


class MetricLogger(_metrics.MetricLogger):
    """Values must be Python numbers (torch tensors: ``float(t)`` first)."""

    def flush(self, prefix: str = "iter", extra: dict | None = None, save=False,
              epoch: int = 0, step: int = 0) -> dict:
        cols = {k: list(v) for k, v in self._log.items() if k.startswith(prefix + "_") and v}
        out = super().flush(prefix, extra, save=False, epoch=epoch, step=step)
        if save and self.model_dir and cols:
            rows = max(len(v) for v in cols.values())
            with open(os.path.join(self.model_dir, f"{prefix}_{epoch}.csv"), "w",
                      newline="") as fh:
                w = csv.writer(fh)
                w.writerow([""] + list(cols))
                for i in range(rows):
                    w.writerow([i] + [v[i] if i < len(v) else "" for v in cols.values()])
        return out
