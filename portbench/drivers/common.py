"""What the drivers share: seeds, the cell's configuration in both forms,
the program's launch counters, the device's name and peak memory, and a
scratch directory for the run's data under ``TMPDIR``."""
from __future__ import annotations

import csv
import os
import shutil
import tempfile

import numpy as np

from ..harness import PKG, flat_config


def subseed(seed: int, *keys) -> int:
    """A seed below 2**63 for one stream of the run, from ``--seed`` (any
    whole number) and the stream's keys (strings or integers)."""
    words = [seed % 2**63] + [k if isinstance(k, int) else int.from_bytes(k.encode(), "little")
                              for k in keys]
    a, b = np.random.SeedSequence(words).generate_state(2)
    return (int(a) << 31) ^ int(b)


def read_split(name: str) -> dict:
    """{name: sequence} of ``portbench/data/<name>.csv``, in file order."""
    with open(os.path.join(PKG, "data", name + ".csv"), newline="") as fh:
        return {r["name"]: r["seqres"] for r in csv.DictReader(fh)}


def leaf_gaps(prog: dict, ref: dict, counted) -> dict:
    """{leaf: the gap between the program's norm and the reference's, over
    the reference's norm of that leaf or of the median leaf, whichever is
    larger}."""
    med = float(np.median([ref[k] for k in counted]))
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in counted}


def leaf_gap(prog: dict, ref: dict, counted) -> float:
    """The worst leaf's gap (``leaf_gaps``)."""
    return max(leaf_gaps(prog, ref, counted).values())


class Base:
    def __init__(self, cell, seed: int, device: str = "cuda"):
        import torch

        self.cell, self.seed, self.traffic = cell, seed, cell.traffic
        self.device = torch.device(device)
        self.cfg = flat_config(cell.config)
        self.attempted = self.failed = 0
        self.workdir = None
        self.marks = []  # (what set-up finished, host clock)

    def mark(self, what: str) -> None:
        import time

        self.marks.append((what, time.perf_counter()))

    def program_config(self):
        from mdgen_tpu_torch.config import MDGenConfig

        fields = MDGenConfig.__dataclass_fields__
        return MDGenConfig(**{k: v for k, v in self.cfg.items() if k in fields})

    def make_workdir(self) -> str:
        self.workdir = tempfile.mkdtemp(prefix="portbench-")
        return self.workdir

    def counters(self) -> dict:
        from mdgen_tpu_torch.ops import launch_counts

        return dict(launch_counts())

    def memory_peak(self) -> int:
        import torch

        if self.device.type != "cuda":
            return 0
        return torch.cuda.max_memory_allocated(self.device)

    def device_info(self, peak: int) -> dict:
        import torch

        if self.device.type != "cuda":
            return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": self.cell.chips, "memory_peak_bytes": peak}

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def numbers(self, values: dict) -> list:
        """[(name, value, limit)] in the traffic file's order of limits."""
        return [(k, float(values[k]), lim) for k, lim in self.traffic["limits"].items()
                if k in values]

    def close(self) -> None:
        if self.workdir:
            shutil.rmtree(self.workdir, ignore_errors=True)
            self.workdir = None
