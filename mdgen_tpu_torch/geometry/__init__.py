"""Geometry: SE(3) rigid transforms, residue constants, tokenization."""
from .rigid import (  # noqa: F401
    Rigid,
    canonicalize_quat_sign,
    get_offsets,
    normalize_quat,
    quat_to_rotmat,
    rotmat_to_quat,
)
from .frames import (  # noqa: F401
    atom14_to_atom37,
    atom37_mask_table,
    atom14_to_frames,
    atom37_to_atom14,
    atom37_to_torsions,
    frames_to_atom14,
    frames_torsions_to_atom14,
    torsion_angles_to_frames,
)
