"""Plain float32 geometry of the reference: rigid transforms as (rots
[*, 3, 3], trans [*, 3]) pairs, backbone frames and torsions from atoms.

Written after the published AlphaFold 2 conventions that MDGen's tokenizer
follows (frames from N, CA, C by Gram-Schmidt with the axis flip diag(-1, 1,
-1); seven (sin, cos) torsions: omega, phi, psi, chi1-4, from the
tables of ``constants``). The 3 x 3 products are broadcast sums, so no
backend routes them through a reduced-precision matmul.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import constants as rc

_TABLES = {
    "a14_to_a37": rc.RESTYPE_ATOM14_TO_ATOM37,
    "a37_to_a14": rc.RESTYPE_ATOM37_TO_ATOM14,
    "a37_mask": rc.RESTYPE_ATOM37_MASK,
    "chi_idx37": rc.chi_atom37_indices,
    "chi_mask": rc.chi_angles_mask_with_unk,
}


@functools.lru_cache(maxsize=None)
def table(name: str, device) -> torch.Tensor:
    arr = np.asarray(_TABLES[name])
    t = torch.from_numpy(arr.astype(np.int64) if arr.dtype.kind == "i" else arr.astype(np.float32))
    return t.to(device)


def matmul33(a, b):
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def matvec3(m, v):
    return (m * v[..., None, :]).sum(-1)


# -- rigid transforms: (rots, trans) ----------------------------------------


def compose(r1, r2):
    """r1 o r2 (r2 applied first)."""
    return matmul33(r1[0], r2[0]), apply(r1, r2[1])


def apply(r, pts):
    return matvec3(r[0], pts) + r[1]


def invert(r):
    inv = r[0].transpose(-1, -2)
    return inv, -matvec3(inv, r[1])


def invert_apply(r, pts):
    return matvec3(r[0].transpose(-1, -2), pts - r[1])


def unsqueeze(r, axis):
    ra = axis if axis >= 0 else axis - 2
    ta = axis if axis >= 0 else axis - 1
    return r[0].unsqueeze(ra), r[1].unsqueeze(ta)


def from_3_points(p_neg_x, origin, p_xy, eps=1e-8):
    e0 = origin - p_neg_x
    e1 = p_xy - origin
    e0 = e0 / torch.sqrt((e0 ** 2).sum(-1, keepdim=True) + eps)
    e1 = e1 - e0 * (e0 * e1).sum(-1, keepdim=True)
    e1 = e1 / torch.sqrt((e1 ** 2).sum(-1, keepdim=True) + eps)
    e2 = torch.linalg.cross(e0, e1, dim=-1)
    return torch.stack([e0, e1, e2], dim=-1), origin


def rot_to_quat(m):
    """Shepperd's method: of the four candidates the one with the largest
    trace term, its dominant component positive; unit length."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    ts = torch.stack([1 + m00 + m11 + m22, 1 + m00 - m11 - m22,
                      1 - m00 + m11 - m22, 1 - m00 - m11 + m22], dim=-1)
    cands = torch.stack([
        torch.stack([ts[..., 0], m21 - m12, m02 - m20, m10 - m01], -1),
        torch.stack([m21 - m12, ts[..., 1], m01 + m10, m02 + m20], -1),
        torch.stack([m02 - m20, m01 + m10, ts[..., 2], m12 + m21], -1),
        torch.stack([m10 - m01, m02 + m20, m12 + m21, ts[..., 3]], -1),
    ], dim=-2)
    best = torch.argmax(ts, dim=-1, keepdim=True)
    t_best = torch.gather(ts, -1, best)
    q = torch.gather(cands, -2, best[..., None].expand(*best.shape, 4))[..., 0, :]
    q = q * (0.5 / torch.sqrt(torch.clamp(t_best, min=1e-12)))
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def to_tensor_7(r):
    return torch.cat([rot_to_quat(r[0]), r[1]], dim=-1)


# -- atoms -> tokens -----------------------------------------------------------


def _gather_atoms(pos, idx):
    return torch.gather(pos, -2, idx[..., None].expand(*idx.shape, 3))


def atom14_to_atom37(atom14, aatype):
    dev = atom14.device
    a37 = _gather_atoms(atom14, table("a37_to_a14", dev)[aatype])
    return a37 * table("a37_mask", dev)[aatype][..., None]


def backbone_frames(atom14):
    """Frames [..., L] from N, CA, C, composed with the axis flip."""
    rots, trans = from_3_points(atom14[..., 2, :], atom14[..., 1, :], atom14[..., 0, :])
    flip = torch.tensor([-1.0, 1.0, -1.0], device=atom14.device)
    return rots * flip, trans


def _shift_prev(x, dim):
    pad = torch.zeros_like(x.narrow(dim, 0, 1))
    return torch.cat([pad, x.narrow(dim, 0, x.shape[dim] - 1)], dim=dim)


def torsions(pos, aatype, mask):
    """pos [..., L, 37, 3], aatype [..., L], atom mask [..., L, 37] ->
    ((sin, cos) [..., L, 7, 2], torsion mask [..., L, 7])."""
    dev = pos.device
    prev_pos = _shift_prev(pos, pos.ndim - 3)
    prev_mask = _shift_prev(mask, mask.ndim - 2)
    omega = torch.cat([prev_pos[..., 1:3, :], pos[..., :2, :]], dim=-2)
    phi = torch.cat([prev_pos[..., 2:3, :], pos[..., :3, :]], dim=-2)
    psi = torch.cat([pos[..., :3, :], pos[..., 4:5, :]], dim=-2)
    omega_m = prev_mask[..., 1] * prev_mask[..., 2] * mask[..., 0] * mask[..., 1]
    phi_m = prev_mask[..., 2] * mask[..., 0] * mask[..., 1] * mask[..., 2]
    psi_m = mask[..., 0] * mask[..., 1] * mask[..., 2] * mask[..., 4]
    chi_idx = table("chi_idx37", dev)[aatype]  # [..., L, 4, 4]
    flat = chi_idx.reshape(*chi_idx.shape[:-2], 16)
    chi = _gather_atoms(pos, flat).reshape(*chi_idx.shape, 3)
    chi_m = torch.prod(torch.gather(mask, -1, flat).reshape(chi_idx.shape), dim=-1)
    chi_m = table("chi_mask", dev)[aatype] * chi_m
    atoms = torch.cat([omega[..., None, :, :], phi[..., None, :, :], psi[..., None, :, :], chi],
                      dim=-3)
    tmask = torch.cat([omega_m[..., None], phi_m[..., None], psi_m[..., None], chi_m], dim=-1)
    frame = from_3_points(atoms[..., 1, :], atoms[..., 2, :], atoms[..., 0, :])
    fourth = invert_apply(frame, atoms[..., 3, :])
    sc = torch.stack([fourth[..., 2], fourth[..., 1]], dim=-1)
    sc = sc / torch.sqrt((sc ** 2).sum(-1, keepdim=True) + 1e-8)
    sign = torch.tensor([1.0, 1.0, -1.0, 1.0, 1.0, 1.0, 1.0], device=dev)  # psi mirrored
    return sc * sign[:, None], tmask
