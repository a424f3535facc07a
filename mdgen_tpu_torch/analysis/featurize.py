"""Torsion featurization from raw coordinates (port of
``mdgen_tpu/analysis/featurize.py``).

Backbone torsions (phi, psi) +/- sidechain chis, as cos/sin pairs or angles,
computed from atom14 trajectories with the geometry the model uses. The
interface is numpy; the geometry runs in torch on the CPU, in f32.
"""
from __future__ import annotations

import numpy as np
import torch

from ..geometry import atom14_to_atom37, atom37_to_torsions
from ..geometry import constants as rc

# torsion tensor layout: [omega, phi, psi, chi1..chi4]
_PHI, _PSI = 1, 2


def _torsions(atom14, aatype):
    """atom14 [T, L, 14, 3], aatype [L] -> (torsions [T, L, 7, 2] (sin, cos),
    torsion_mask [T, L, 7]) as f32 numpy."""
    T, L = atom14.shape[:2]
    pos = torch.from_numpy(np.ascontiguousarray(atom14, np.float32))
    aatype_tl = torch.from_numpy(np.asarray(aatype)).long().expand(T, L)
    with torch.no_grad():
        torsions, mask = atom37_to_torsions(atom14_to_atom37(pos, aatype_tl), aatype_tl)
    return torsions.numpy(), mask.numpy()


def featurize_torsions(
    atom14: np.ndarray,
    aatype: np.ndarray,
    sidechains: bool = False,
    cossin: bool = True,
):
    """atom14 [T, L, 14, 3], aatype [L] -> features [T, F].

    Backbone: phi (residues 1..L-1) and psi (residues 0..L-2). Sidechains:
    chi1..4 where defined by residue type. cossin=True emits (cos, sin) pairs
    (pyemma's convention), else wrapped angles.
    """
    T = atom14.shape[0]
    torsions, _ = _torsions(atom14, aatype)  # [T, L, 7, 2] (sin, cos)

    res_idx, tor_idx = _feature_index_arrays(np.asarray(aatype), sidechains)
    out = torsions[:, res_idx, tor_idx, :]  # [T, F, 2]
    if cossin:
        # pyemma emits (cos, sin); our torsions are (sin, cos)
        return out[..., ::-1].reshape(T, -1)
    return np.arctan2(out[..., 0], out[..., 1]).reshape(T, -1)


def _feature_index_arrays(aatype: np.ndarray, sidechains: bool):
    """(residue, torsion) gather indices in pyemma's feature order.

    pyemma's ``add_backbone_torsions`` sorts dihedrals by first atom index,
    which interleaves by residue: psi_0, phi_1, psi_1, ..., phi_{L-1}
    (phi_i starts at C(i-1), psi_i at N(i)). The reference relies on this:
    its 2D Ramachandran JSDs pair features i, i+1 for i in {1, 3}, which
    are (phi_i, psi_i) of one residue only under the interleaved order
    (reference `scripts/analyze_peptide_sim.py:57-59`).
    ``add_sidechain_torsions`` then appends chi1 for all residues, chi2, ...
    """
    L = len(aatype)
    pairs = []
    for i in range(L):
        if i > 0:
            pairs.append((i, _PHI))
        if i < L - 1:
            pairs.append((i, _PSI))
    if sidechains:
        chi_mask = rc.chi_angles_mask_with_unk[aatype]  # [L, 4]
        for k in range(4):
            for i in np.nonzero(chi_mask[:, k] > 0.5)[0]:
                pairs.append((int(i), 3 + k))
    res_idx = np.array([p[0] for p in pairs], np.int64)
    tor_idx = np.array([p[1] for p in pairs], np.int64)
    return res_idx, tor_idx


_TORSION_NAMES = ["OMEGA", "PHI", "PSI", "CHI1", "CHI2", "CHI3", "CHI4"]


def describe_features(aatype: np.ndarray, sidechains: bool = False,
                      cossin: bool = False):
    """Feature labels in the same order ``featurize_torsions`` emits them,
    pyemma-style: ``"PHI 0 ALA 1"``; cossin doubles each into
    COS(...)/SIN(...) pairs (reference `mdgen/analysis.py:8-21` describe())."""
    aatype = np.asarray(aatype)
    res_idx, tor_idx = _feature_index_arrays(aatype, sidechains)
    labels = [
        f"{_TORSION_NAMES[t]} 0 {rc.restype_1to3.get(rc.restypes_with_x[aatype[r]], 'UNK')} {r}"
        for r, t in zip(res_idx, tor_idx)
    ]
    if cossin:
        return [f"{fn}({lab})" for lab in labels for fn in ("COS", "SIN")]
    return labels


def torsion_angles(atom14: np.ndarray, aatype: np.ndarray):
    """All 7 torsions as wrapped angles + validity mask:
    ([T, L, 7], [L, 7])."""
    torsions, torsion_mask = _torsions(atom14, aatype)
    angles = np.arctan2(torsions[..., 0], torsions[..., 1])
    return angles, torsion_mask[0]
