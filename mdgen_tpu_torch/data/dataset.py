"""Trajectory dataset (port of ``mdgen_tpu/data/dataset.py``).

``{data_dir}/{name}{suffix}.npy`` atom14 trajectories in Angstroms and split
CSVs with ``name,seqres`` columns, read with the ``csv`` module. Items are
raw atom14 windows of ``num_frames`` frames (float32), the sequence and the
residue mask; tokenization runs on the device in the train step
(``runtime.wrapper.tokenize_atom14``). The overfit, ``frame_interval`` and
``copy_frames`` flags are kept; ATLAS crops are not ported yet.
"""
from __future__ import annotations

import csv
import os
from typing import Optional

import numpy as np

from ..geometry import constants as rc


def read_split(path: str) -> dict:
    """{name: seqres} in file order."""
    with open(path, newline="") as fh:
        return {row["name"]: row["seqres"] for row in csv.DictReader(fh)}


class MDGenDataset:
    def __init__(self, cfg, split: str, data_dir: str, repeat: int = 1,
                 seed: Optional[int] = None):
        """``seed`` seeds the window draws (None: fresh entropy, as the JAX
        package does)."""
        if cfg.atlas:
            raise NotImplementedError(
                "ATLAS crops and tokenization are not ported to mdgen_tpu_torch yet "
                "(ROADMAP queue 1, item 3)"
            )
        self.cfg = cfg
        self.split = read_split(split)
        self.names = list(self.split)
        self.data_dir = data_dir
        self.repeat = repeat
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        if self.cfg.overfit_peptide:
            return 1000
        return self.repeat * len(self.names)

    def __getitem__(self, idx: int) -> dict:
        cfg = self.cfg
        idx = 0 if cfg.overfit else idx % len(self.names)
        if cfg.overfit_peptide is None:
            name = self.names[idx]
            seqres = self.split[name]
        else:
            name = seqres = cfg.overfit_peptide

        arr = np.lib.format.open_memmap(
            os.path.join(self.data_dir, f"{name}{cfg.suffix}.npy"), "r"
        )
        if cfg.frame_interval:
            arr = arr[:: cfg.frame_interval]
        span = arr.shape[0] - cfg.num_frames
        frame_start = self.rng.integers(0, span) if span > 0 else 0
        if cfg.overfit_frame:
            frame_start = 0
        atom14 = np.array(arr[frame_start : frame_start + cfg.num_frames], dtype=np.float32)
        if cfg.copy_frames:
            atom14[1:] = atom14[0]
        return {
            "name": name,
            "frame_start": int(frame_start),
            "atom14": atom14,
            "seqres": rc.str_sequence_to_aatype(seqres),
            "mask": np.ones(atom14.shape[1], dtype=np.float32),
        }
