"""Synthetic peptide and protein trajectories after the program's generator
(``data/synthetic.py``'s ``synthetic_trajectory``): idealized literature
residues along x with slowly varying random rotations and offsets, the same
numbers drawn in the same order, every frame computed at once."""
from __future__ import annotations

import numpy as np

from .reference import constants as rc


def _smooth_noise(rng, T, shape, smooth=20):
    """Temporally smooth gaussian noise: a moving average of ``smooth``
    frames (by cumulative sums, all columns at once)."""
    x = rng.normal(size=(T + smooth, *shape))
    c = np.concatenate([np.zeros((1, *shape)), np.cumsum(x, axis=0)])
    return ((c[smooth:] - c[:-smooth]) / smooth)[:T]


def synthetic_trajectory(seqres: str, num_frames: int, seed: int = 0) -> np.ndarray:
    """[T, L, 14, 3] float16 atom14 trajectory, every frame at once."""
    rng = np.random.default_rng(seed)
    aatype = rc.str_sequence_to_aatype(seqres)
    L = len(aatype)
    T = num_frames

    lit = rc.restype_atom14_rigid_group_positions[aatype]  # L, 14, 3
    mask = rc.restype_atom14_mask[aatype][..., None]  # L, 14, 1

    angles = _smooth_noise(rng, T, (L, 3), smooth=16) * 0.8
    offsets = _smooth_noise(rng, T, (L, 3), smooth=16) * 1.5

    c, s = np.cos(angles), np.sin(angles)  # [T, L, 3]
    one, zero = np.ones((T, L)), np.zeros((T, L))

    def rot(rows):
        return np.stack([np.stack(r, axis=-1) for r in rows], axis=-2)

    Rx = rot([[one, zero, zero], [zero, c[..., 0], -s[..., 0]], [zero, s[..., 0], c[..., 0]]])
    Ry = rot([[c[..., 1], zero, s[..., 1]], [zero, one, zero], [-s[..., 1], zero, c[..., 1]]])
    Rz = rot([[c[..., 2], -s[..., 2], zero], [s[..., 2], c[..., 2], zero], [zero, zero, one]])
    R = Rx @ Ry @ Rz  # [T, L, 3, 3]
    base = np.stack([np.arange(L) * 3.8, np.zeros(L), np.zeros(L)], axis=-1)
    pos = np.swapaxes(R @ np.swapaxes(lit, -1, -2), -1, -2) + (base + offsets)[:, :, None]
    return (pos * mask).astype(np.float32).astype(np.float16)
