"""Trajectory dataset (port of ``mdgen_tpu/data/dataset.py``).

``{data_dir}/{name}{suffix}.npy`` atom14 trajectories in Angstroms and split
CSVs with ``name,seqres`` columns, read with the ``csv`` module. Items are
raw atom14 windows of ``num_frames`` frames (float32), the sequence and the
residue mask; tokenization runs on the device in the train step
(``runtime.wrapper.tokenize_atom14``). The overfit, ``frame_interval`` and
``copy_frames`` flags are kept.

ATLAS (``cfg.atlas``): each item reads a random replica ``{name}_R1..3``
and is cropped at random to ``crop`` residues, or padded to it (mask 0),
with ONE more residue column in front, the left context: the residue before
the crop, or a zero, mask-0 column at the chain's start. The tokenizer reads
the first residue's phi and omega from it and drops it. The draws come in
the JAX dataset's order (replica, frame start, crop start), so the same
generator state gives the same items.
"""
from __future__ import annotations

import csv
import os
from typing import Optional

import numpy as np

from ..geometry import constants as rc


def _prepend_ctx_pad(cfg, atom14, seqres_idx, mask):
    """Prepend an all-zero, mask-0 left-context column (chain start)."""
    atom14 = np.concatenate(
        [np.zeros((cfg.num_frames, 1, 14, 3), atom14.dtype), atom14], axis=1
    )
    seqres_idx = np.concatenate([np.zeros(1, seqres_idx.dtype), seqres_idx])
    mask = np.concatenate([np.zeros(1, np.float32), mask])
    return atom14, seqres_idx, mask


def read_split(path: str) -> dict:
    """{name: seqres} in file order."""
    with open(path, newline="") as fh:
        return {row["name"]: row["seqres"] for row in csv.DictReader(fh)}


class MDGenDataset:
    def __init__(self, cfg, split: str, data_dir: str, repeat: int = 1,
                 seed: Optional[int] = None):
        """``seed`` seeds the window draws (None: fresh entropy, as the JAX
        package does)."""
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
        return self._item(idx)

    def skip(self, idx: int) -> None:
        """Make item ``idx``'s random draws without reading its frames (only
        the file's header): a data-parallel rank walks the other ranks'
        items of a global batch so, and its own items get the draws they
        get in a one-rank run."""
        self._item(idx, load=False)

    def _item(self, idx: int, load: bool = True) -> Optional[dict]:
        cfg = self.cfg
        idx = 0 if cfg.overfit else idx % len(self.names)
        if cfg.overfit_peptide is None:
            name = self.names[idx]
            seqres = self.split[name]
        else:
            name = seqres = cfg.overfit_peptide
        if cfg.atlas:
            name = f"{name}_R{self.rng.integers(1, 4)}"

        arr = np.lib.format.open_memmap(
            os.path.join(self.data_dir, f"{name}{cfg.suffix}.npy"), "r"
        )
        if cfg.frame_interval:
            arr = arr[:: cfg.frame_interval]
        span = arr.shape[0] - cfg.num_frames
        frame_start = self.rng.integers(0, span) if span > 0 else 0
        if cfg.overfit_frame:
            frame_start = 0
        L = arr.shape[1]
        crop_start = self.rng.integers(0, L - cfg.crop + 1) if cfg.atlas and L > cfg.crop \
            else None
        if not load:
            return None
        atom14 = np.array(arr[frame_start : frame_start + cfg.num_frames], dtype=np.float32)
        if cfg.copy_frames:
            atom14[1:] = atom14[0]
        seqres_idx = rc.str_sequence_to_aatype(seqres)
        mask = np.ones(atom14.shape[1], dtype=np.float32)
        if cfg.atlas:
            atom14, seqres_idx, mask = self._atlas_crop(atom14, seqres_idx, mask, crop_start)
        return {
            "name": name,
            "frame_start": int(frame_start),
            "atom14": atom14,
            "seqres": seqres_idx,
            "mask": mask,
        }

    def _atlas_crop(self, atom14, seqres_idx, mask, start):
        """Crop at the drawn ``start`` (None: the chain fits) or pad to
        ``crop`` residues, plus the left-context column: [crop + 1] wide."""
        cfg = self.cfg
        L = atom14.shape[1]
        if start is not None:
            lo = max(start - 1, 0)
            atom14 = atom14[:, lo:start + cfg.crop]
            seqres_idx = seqres_idx[lo:start + cfg.crop]
            mask = mask[lo:start + cfg.crop].copy()
            if start == 0:
                return _prepend_ctx_pad(cfg, atom14, seqres_idx, mask)
            return atom14, seqres_idx, mask
        pad = cfg.crop - L
        atom14 = np.concatenate([atom14, np.zeros((cfg.num_frames, pad, 14, 3), atom14.dtype)],
                                axis=1)
        seqres_idx = np.concatenate([seqres_idx, np.zeros(pad, seqres_idx.dtype)])
        mask = np.concatenate([mask, np.zeros(pad, np.float32)])
        return _prepend_ctx_pad(cfg, atom14, seqres_idx, mask)
