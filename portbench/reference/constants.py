"""Residue-level stereochemistry constants for the benchmark's reference,
derived at import time from ``stereo_tables.txt`` beside this file: a
frozen copy, so that the yardstick does not move when the program's tables
do. The raw literature data (20 amino-acid types, atom37/atom14 layouts,
idealized rigid-group atom positions, chi-angle definitions) lives in the
text file; the frame transforms, masks and index maps are computed here
with NumPy.
"""
from __future__ import annotations

import os

import numpy as np

_HERE = os.path.dirname(__file__)

# ---------------------------------------------------------------------------
# Parse the raw tables
# ---------------------------------------------------------------------------


def _parse_tables(path):
    sections: dict[str, list[str]] = {}
    current = None
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if line.startswith("["):
                current = line.strip("[]")
                sections[current] = []
            else:
                sections[current].append(line)
    return sections


_S = _parse_tables(os.path.join(_HERE, "stereo_tables.txt"))

# Residue alphabet -----------------------------------------------------------
restypes: list[str] = []
restype_1to3: dict[str, str] = {}
for row in _S["restypes"]:
    one, three = row.split()
    restypes.append(one)
    restype_1to3[one] = three

restype_3to1 = {v: k for k, v in restype_1to3.items()}
restype_order = {letter: i for i, letter in enumerate(restypes)}
restype_num = len(restypes)  # 20
unk_restype_index = restype_num  # 20 == UNK
restypes_with_x = restypes + ["X"]
restype_order_with_x = {letter: i for i, letter in enumerate(restypes_with_x)}

# Atom alphabets --------------------------------------------------------------
atom_types: list[str] = _S["atom37"][0].split()
atom_order = {name: i for i, name in enumerate(atom_types)}
atom_type_num = len(atom_types)  # 37

restype_name_to_atom14_names: dict[str, list[str]] = {}
for row in _S["atom14"]:
    parts = row.split()
    restype_name_to_atom14_names[parts[0]] = [
        "" if p == "-" else p for p in parts[1:]
    ]
restype_name_to_atom14_names["UNK"] = [""] * 14

# Rigid group atom positions ---------------------------------------------------
# resname -> list of (atom_name, group_idx, xyz)
rigid_group_atom_positions: dict[str, list] = {
    restype_1to3[r]: [] for r in restypes
}
for row in _S["rigid_groups"]:
    name3, atom, group, x, y, z = row.split()
    rigid_group_atom_positions[name3].append(
        (atom, int(group), np.array([float(x), float(y), float(z)]))
    )

# Chi angles -------------------------------------------------------------------
chi_angles_atoms: dict[str, list[list[str]]] = {restype_1to3[r]: [] for r in restypes}
for row in _S["chi_atoms"]:
    parts = row.split()
    name3, k = parts[0], int(parts[1])
    assert k == len(chi_angles_atoms[name3])
    chi_angles_atoms[name3].append(parts[2:])
chi_angles_atoms["UNK"] = []

# chi_angles_mask[restype][k] = 1.0 iff chi_k exists for that residue type
chi_angles_mask: list[list[float]] = [
    [1.0 if k < len(chi_angles_atoms[restype_1to3[r]]) else 0.0 for k in range(4)]
    for r in restypes
]

chi_pi_periodic: list[list[float]] = []
for row in _S["chi_pi_periodic"]:
    parts = row.split()
    chi_pi_periodic.append([float(p) for p in parts[1:]])
chi_pi_periodic.append([0.0] * 4)  # UNK row

# ---------------------------------------------------------------------------
# Derived index maps and masks (atom14 <-> atom37)
# ---------------------------------------------------------------------------

_n_res = restype_num + 1  # include UNK row

RESTYPE_ATOM14_TO_ATOM37 = np.zeros((_n_res, 14), dtype=np.int32)
RESTYPE_ATOM37_TO_ATOM14 = np.zeros((_n_res, 37), dtype=np.int32)
RESTYPE_ATOM14_MASK = np.zeros((_n_res, 14), dtype=np.float32)
RESTYPE_ATOM37_MASK = np.zeros((_n_res, 37), dtype=np.float32)

for _i, _r in enumerate(restypes):
    _names14 = restype_name_to_atom14_names[restype_1to3[_r]]
    for _slot, _a in enumerate(_names14):
        if not _a:
            continue
        _a37 = atom_order[_a]
        RESTYPE_ATOM14_TO_ATOM37[_i, _slot] = _a37
        RESTYPE_ATOM37_TO_ATOM14[_i, _a37] = _slot
        RESTYPE_ATOM14_MASK[_i, _slot] = 1.0
        RESTYPE_ATOM37_MASK[_i, _a37] = 1.0

# Aliases matching the snake_case names used by geometry code.
restype_atom14_mask = RESTYPE_ATOM14_MASK
restype_atom37_mask = RESTYPE_ATOM37_MASK

# ---------------------------------------------------------------------------
# Rigid-group frames (8 groups: bb, pre-omega, phi, psi, chi1..chi4)
# ---------------------------------------------------------------------------


def _frame_from_axes(ex, ey, translation):
    """Build a 4x4 rigid transform whose x-axis is ex and whose xy-plane
    contains ey (Gram-Schmidt), positioned at ``translation``."""
    ex = np.asarray(ex, dtype=np.float64)
    ey = np.asarray(ey, dtype=np.float64)
    ex = ex / np.linalg.norm(ex)
    ey = ey - np.dot(ey, ex) * ex
    ey = ey / np.linalg.norm(ey)
    ez = np.cross(ex, ey)
    out = np.eye(4)
    out[:3, 0] = ex
    out[:3, 1] = ey
    out[:3, 2] = ez
    out[:3, 3] = translation
    return out


restype_atom14_to_rigid_group = np.zeros((_n_res, 14), dtype=np.int32)
restype_atom14_rigid_group_positions = np.zeros((_n_res, 14, 3), dtype=np.float32)
restype_atom37_to_rigid_group = np.zeros((_n_res, 37), dtype=np.int32)
restype_atom37_rigid_group_positions = np.zeros((_n_res, 37, 3), dtype=np.float32)
# Frames for groups that do not exist on a residue type (and the whole UNK
# row) are intentionally left as zeros: downstream one-hot group selection
# never picks them for a real atom, and zero-frames compose to zeros.
restype_rigid_group_default_frame = np.zeros((_n_res, 8, 4, 4), dtype=np.float32)

for _i, _r in enumerate(restypes):
    _name3 = restype_1to3[_r]
    _pos = {a: p for a, _g, p in rigid_group_atom_positions[_name3]}
    _names14 = restype_name_to_atom14_names[_name3]
    for _a, _g, _p in rigid_group_atom_positions[_name3]:
        _slot = _names14.index(_a)
        restype_atom14_to_rigid_group[_i, _slot] = _g
        restype_atom14_rigid_group_positions[_i, _slot] = _p
        _a37 = atom_order[_a]
        restype_atom37_to_rigid_group[_i, _a37] = _g
        restype_atom37_rigid_group_positions[_i, _a37] = _p

    # groups 0 (backbone) and 1 (pre-omega) are the identity transform
    restype_rigid_group_default_frame[_i, 0] = np.eye(4)
    restype_rigid_group_default_frame[_i, 1] = np.eye(4)
    # group 2: phi frame, anchored at N with x-axis along CA->N
    restype_rigid_group_default_frame[_i, 2] = _frame_from_axes(
        _pos["N"] - _pos["CA"], [1.0, 0.0, 0.0], _pos["N"]
    )
    # group 3: psi frame, anchored at C with x-axis along CA->C
    restype_rigid_group_default_frame[_i, 3] = _frame_from_axes(
        _pos["C"] - _pos["CA"], _pos["CA"] - _pos["N"], _pos["C"]
    )
    _chis = chi_angles_atoms[_name3]
    if _chis:
        # chi1 frame relative to backbone
        _a0, _a1, _a2, _ = _chis[0]
        restype_rigid_group_default_frame[_i, 4] = _frame_from_axes(
            _pos[_a2] - _pos[_a1], _pos[_a0] - _pos[_a1], _pos[_a2]
        )
        # chi2..chi4 frames relative to the previous chi frame; the rotation
        # axis of chi_{k+1} emanates from the origin of the chi_k frame.
        for _k in range(1, len(_chis)):
            _axis_end = _pos[_chis[_k][2]]
            restype_rigid_group_default_frame[_i, 4 + _k] = _frame_from_axes(
                _axis_end, [-1.0, 0.0, 0.0], _axis_end
            )

# ---------------------------------------------------------------------------
# Chi atom indices in atom37 numbering: [21, 4, 4] (UNK row = zeros)
# ---------------------------------------------------------------------------

chi_atom37_indices = np.zeros((_n_res, 4, 4), dtype=np.int32)
for _i, _r in enumerate(restypes):
    for _k, _quad in enumerate(chi_angles_atoms[restype_1to3[_r]]):
        chi_atom37_indices[_i, _k] = [atom_order[a] for a in _quad]

# chi mask padded with an UNK row: [21, 4]
chi_angles_mask_with_unk = np.concatenate(
    [np.array(chi_angles_mask, dtype=np.float32), np.zeros((1, 4), dtype=np.float32)],
    axis=0,
)


def aatype_to_str_sequence(aatype) -> str:
    """Integer aatype array -> one-letter string (X for UNK/out of range)."""
    return "".join(
        restypes_with_x[int(a)] if 0 <= int(a) <= restype_num else "X"
        for a in np.asarray(aatype).reshape(-1)
    )


def str_sequence_to_aatype(seq: str) -> np.ndarray:
    """One-letter sequence -> int32 aatype array (unknown letters -> 20)."""
    return np.array(
        [restype_order.get(c, unk_restype_index) for c in seq], dtype=np.int32
    )
