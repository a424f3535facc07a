"""Atom-layout conversions and (frames, torsions) tokenization on tensors.

Port of ``mdgen_tpu/geometry/frames.py``. Layouts: atom14 (slots 0..3 are
N, CA, C, O), atom37 (AF2 fixed atom types), torsions as 7 (sin, cos) pairs
(omega, phi, psi, chi1..chi4).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import constants as rc
from .rigid import Rigid, _matvec3

_TABLES = {
    "a14_to_a37": rc.RESTYPE_ATOM14_TO_ATOM37,  # [21, 14]
    "a37_to_a14": rc.RESTYPE_ATOM37_TO_ATOM14,  # [21, 37]
    "a14_mask": rc.RESTYPE_ATOM14_MASK,  # [21, 14]
    "a37_mask": rc.RESTYPE_ATOM37_MASK,  # [21, 37]
    "chi_idx37": rc.chi_atom37_indices,  # [21, 4, 4]
    "chi_mask": rc.chi_angles_mask_with_unk,  # [21, 4]
    "default_frames": rc.restype_rigid_group_default_frame,  # [21, 8, 4, 4]
    "group_idx": rc.restype_atom14_to_rigid_group,  # [21, 14]
    "lit_positions": rc.restype_atom14_rigid_group_positions,  # [21, 14, 3]
    # backbone axis flip diag(-1, 1, -1)
    "bb_flip": np.diag([-1.0, 1.0, -1.0]).astype(np.float32),
    # psi (sin, cos) is mirrored
    "torsion_sign": np.asarray([1.0, 1.0, -1.0, 1.0, 1.0, 1.0, 1.0], np.float32),
}


@functools.lru_cache(maxsize=None)
def _table(name: str, device: torch.device) -> torch.Tensor:
    arr = np.asarray(_TABLES[name])
    t = torch.from_numpy(arr.astype(np.int64) if arr.dtype.kind == "i" else arr)
    return t.to(device)


def atom37_mask_table(device: torch.device) -> torch.Tensor:
    """Each residue type's atom37 mask [21, 37] f32 on ``device``, made
    once (read-only)."""
    return _table("a37_mask", device)


def _gather_atoms(pos, idx):
    """pos [..., A, 3], idx [..., M] -> [..., M, 3]."""
    return torch.gather(pos, -2, idx[..., None].expand(*idx.shape, 3))


def _align_aatype(aatype, pos):
    return torch.as_tensor(aatype, device=pos.device).long().expand(pos.shape[:-2])


# ---------------------------------------------------------------------------
# atom14 <-> atom37
# ---------------------------------------------------------------------------


def atom14_to_atom37(atom14: torch.Tensor, aatype) -> torch.Tensor:
    """[..., L, 14, 3] -> [..., L, 37, 3]."""
    aatype = _align_aatype(aatype, atom14)
    dev = atom14.device
    atom37 = _gather_atoms(atom14, _table("a37_to_a14", dev)[aatype])
    return atom37 * _table("a37_mask", dev)[aatype][..., None]


def atom37_to_atom14(atom37: torch.Tensor, aatype) -> torch.Tensor:
    """[..., L, 37, 3] -> [..., L, 14, 3]."""
    aatype = _align_aatype(aatype, atom37)
    dev = atom37.device
    atom14 = _gather_atoms(atom37, _table("a14_to_a37", dev)[aatype])
    return atom14 * _table("a14_mask", dev)[aatype][..., None]


# ---------------------------------------------------------------------------
# backbone frames
# ---------------------------------------------------------------------------


def atom14_to_frames(atom14: torch.Tensor) -> Rigid:
    """Backbone frames from N/CA/C: Gram-Schmidt on (C, CA, N) composed with
    the axis flip diag(-1, 1, -1). [..., L, 14, 3] -> Rigid [..., L]."""
    n, ca, c = atom14[..., 0, :], atom14[..., 1, :], atom14[..., 2, :]
    frames = Rigid.from_3_points(c, ca, n)
    flip = _table("bb_flip", atom14.device).expand(frames.rots.shape)
    return frames.compose(Rigid(flip, torch.zeros_like(frames.trans)))


# ---------------------------------------------------------------------------
# torsions
# ---------------------------------------------------------------------------


def _shift_prev(x, res_axis_from_end):
    """Shift one step along the residue axis, zero-padding the front."""
    dim = x.ndim - res_axis_from_end
    pad = torch.zeros_like(x.narrow(dim, 0, 1))
    return torch.cat([pad, x.narrow(dim, 0, x.shape[dim] - 1)], dim=dim)


def atom37_to_torsions(all_atom_positions, aatype, all_atom_mask=None):
    """7 torsions per residue as (sin, cos): positions [..., L, 37, 3] ->
    (torsions [..., L, 7, 2], torsion_mask [..., L, 7])."""
    pos = all_atom_positions
    dev = pos.device
    aatype = _align_aatype(aatype, pos)
    mask = _table("a37_mask", dev)[aatype] if all_atom_mask is None else all_atom_mask

    prev_pos = _shift_prev(pos, 3)
    prev_mask = _shift_prev(mask, 2)

    pre_omega_atoms = torch.cat([prev_pos[..., 1:3, :], pos[..., :2, :]], dim=-2)
    phi_atoms = torch.cat([prev_pos[..., 2:3, :], pos[..., :3, :]], dim=-2)
    psi_atoms = torch.cat([pos[..., :3, :], pos[..., 4:5, :]], dim=-2)

    pre_omega_mask = torch.prod(prev_mask[..., 1:3], dim=-1) * torch.prod(
        mask[..., :2], dim=-1
    )
    phi_mask = prev_mask[..., 2] * torch.prod(mask[..., :3], dim=-1)
    psi_mask = torch.prod(mask[..., :3], dim=-1) * mask[..., 4]

    chi_idx = _table("chi_idx37", dev)[aatype]  # [..., L, 4, 4]
    flat_idx = chi_idx.reshape(*chi_idx.shape[:-2], 16)
    chi_atoms = _gather_atoms(pos, flat_idx).reshape(*chi_idx.shape, 3)
    chi_atom_mask = torch.prod(
        torch.gather(mask, -1, flat_idx).reshape(chi_idx.shape), dim=-1
    )
    chi_mask = _table("chi_mask", dev)[aatype] * chi_atom_mask

    atoms = torch.cat(
        [pre_omega_atoms[..., None, :, :], phi_atoms[..., None, :, :],
         psi_atoms[..., None, :, :], chi_atoms],
        dim=-3,
    )  # [..., L, 7, 4, 3]
    torsion_mask = torch.cat(
        [pre_omega_mask[..., None], phi_mask[..., None], psi_mask[..., None],
         chi_mask],
        dim=-1,
    )

    torsion_frames = Rigid.from_3_points(
        atoms[..., 1, :], atoms[..., 2, :], atoms[..., 0, :], eps=1e-8
    )
    fourth_rel = torsion_frames.invert_apply(atoms[..., 3, :])
    sin_cos = torch.stack([fourth_rel[..., 2], fourth_rel[..., 1]], dim=-1)
    sin_cos = sin_cos / torch.sqrt(torch.sum(sin_cos**2, dim=-1, keepdim=True) + 1e-8)
    sin_cos = sin_cos * _table("torsion_sign", dev)[:, None]
    return sin_cos, torsion_mask


# ---------------------------------------------------------------------------
# reconstruction: frames + torsions -> all-atom coordinates
# ---------------------------------------------------------------------------


def torsion_angles_to_frames(r: Rigid, alpha, aatype) -> Rigid:
    """The 8 rigid-group frames per residue in the global frame.
    r [..., L], alpha [..., L, 7, 2], aatype [..., L] -> Rigid [..., L, 8]."""
    default_r = Rigid.from_tensor_4x4(_table("default_frames", alpha.device)[aatype])
    bb = torch.tensor([0.0, 1.0], dtype=alpha.dtype, device=alpha.device).expand(
        *alpha.shape[:-2], 1, 2
    )
    a = torch.cat([bb, alpha], dim=-2)  # [..., L, 8, 2]
    sin, cos = a[..., 0], a[..., 1]
    zeros, ones = torch.zeros_like(sin), torch.ones_like(sin)
    rot = torch.stack(
        [
            torch.stack([ones, zeros, zeros], dim=-1),
            torch.stack([zeros, cos, -sin], dim=-1),
            torch.stack([zeros, sin, cos], dim=-1),
        ],
        dim=-2,
    )
    all_frames = default_r.compose(Rigid(rot, torch.zeros((*sin.shape, 3), dtype=sin.dtype, device=sin.device)))

    chi1 = all_frames[..., 4]
    chi2 = chi1.compose(all_frames[..., 5])
    chi3 = chi2.compose(all_frames[..., 6])
    chi4 = chi3.compose(all_frames[..., 7])
    to_bb = Rigid.cat(
        [all_frames[..., :5], chi2.expand_dims(-1), chi3.expand_dims(-1),
         chi4.expand_dims(-1)],
        axis=-1,
    )
    return r.expand_dims(-1).compose(to_bb)


def frames_to_atom14(frames8: Rigid, aatype) -> torch.Tensor:
    """Place the idealized literature atoms with their group frames.
    frames8 [..., L, 8] -> [..., L, 14, 3], masked to existing atoms."""
    dev = frames8.trans.device
    # one-hot contraction as in the JAX package (a NaN group frame spreads to
    # every atom of its residue there too), as an exact broadcast sum
    onehot = torch.nn.functional.one_hot(_table("group_idx", dev)[aatype], 8)
    onehot = onehot.to(frames8.rots.dtype)  # [..., L, 14, 8]
    rots = (frames8.rots[..., None, :, :, :] * onehot[..., None, None]).sum(-3)
    trans = (frames8.trans[..., None, :, :] * onehot[..., None]).sum(-2)
    lit = _table("lit_positions", dev)[aatype]
    pred = _matvec3(rots, lit) + trans
    return pred * _table("a14_mask", dev)[aatype][..., None]


def frames_torsions_to_atom14(frames: Rigid, torsions, aatype) -> torch.Tensor:
    aatype = torch.as_tensor(aatype, device=torsions.device).long()
    return frames_to_atom14(torsion_angles_to_frames(frames, torsions, aatype), aatype)
