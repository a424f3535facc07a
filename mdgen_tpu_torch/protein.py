"""PDB and trajectory I/O (port of the pure-Python side of
``mdgen_tpu/protein.py``): the multi-MODEL PDB writer and reader, and the
frame-0 PDB + XTC pair that ``save_trajectory`` writes and
``load_trajectory`` reads. The files are the JAX package's, byte for byte,
so either package's analysis reads the other's output."""
from __future__ import annotations

import dataclasses
import io
import os
from typing import Optional

import numpy as np
import torch

from .geometry import atom14_to_atom37, atom37_to_atom14
from .geometry import constants as rc

PDB_CHAIN_IDS = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789"


@dataclasses.dataclass
class Protein:
    atom_positions: np.ndarray  # [L, 37, 3]
    atom_mask: np.ndarray  # [L, 37]
    aatype: np.ndarray  # [L]
    residue_index: np.ndarray  # [L]
    b_factors: np.ndarray  # [L, 37]
    chain_index: Optional[np.ndarray] = None  # [L]


def _atom_element(atom_name: str) -> str:
    return atom_name[0]


def to_pdb(prot: Protein) -> str:
    """One MODEL: ATOM records + TER + ENDMDL + END."""
    out = io.StringIO()
    out.write("MODEL     1\n")
    atom_idx = 1
    chain_index = (
        prot.chain_index if prot.chain_index is not None else np.zeros(len(prot.aatype), int)
    )
    last_chain = None
    for i in range(len(prot.aatype)):
        aa = int(prot.aatype[i])
        resname = rc.restype_1to3[rc.restypes[aa]] if aa < 20 else "UNK"
        chain = PDB_CHAIN_IDS[int(chain_index[i]) % len(PDB_CHAIN_IDS)]
        if last_chain is not None and chain != last_chain:
            out.write("TER\n")
        last_chain = chain
        for a in range(37):
            if prot.atom_mask[i, a] < 0.5:
                continue
            name = rc.atom_types[a]
            x, y, z = prot.atom_positions[i, a]
            b = prot.b_factors[i, a]
            pad_name = f" {name:<3}" if len(name) < 4 else name
            out.write(
                f"ATOM  {atom_idx:>5} {pad_name}{'':1}{resname:>3} {chain}"
                f"{int(prot.residue_index[i]):>4}{'':1}   "
                f"{x:>8.3f}{y:>8.3f}{z:>8.3f}{1.0:>6.2f}{b:>6.2f}"
                f"          {_atom_element(name):>2}\n"
            )
            atom_idx += 1
    out.write("TER\n")
    out.write("ENDMDL\n")
    out.write("END\n")
    return out.getvalue()


def from_pdb_string(pdb_str: str, chain_id: Optional[str] = None) -> Protein:
    """Minimal ATOM-record parser (first MODEL only)."""
    positions, masks, aatypes, res_idx, bfs, chains = [], [], [], [], [], []
    res_key = None
    cur_pos = cur_mask = cur_b = None
    chain_ids: dict[str, int] = {}

    for line in pdb_str.splitlines():
        if line.startswith("ENDMDL"):
            break
        if not line.startswith("ATOM"):
            continue
        atom_name = line[12:16].strip()
        resname = line[17:20].strip()
        chain = line[21]
        if chain_id is not None and chain != chain_id:
            continue
        resseq = int(line[22:26])
        if atom_name not in rc.atom_order:
            continue
        key = (chain, resseq)
        if key != res_key:
            if res_key is not None:
                positions.append(cur_pos)
                masks.append(cur_mask)
                bfs.append(cur_b)
            res_key = key
            cur_pos = np.zeros((37, 3))
            cur_mask = np.zeros(37)
            cur_b = np.zeros(37)
            one = rc.restype_3to1.get(resname, "X")
            aatypes.append(rc.restype_order.get(one, rc.unk_restype_index))
            res_idx.append(resseq)
            chains.append(chain_ids.setdefault(chain, len(chain_ids)))
        a = rc.atom_order[atom_name]
        cur_pos[a] = [float(line[30:38]), float(line[38:46]), float(line[46:54])]
        cur_mask[a] = 1.0
        cur_b[a] = float(line[60:66]) if line[60:66].strip() else 0.0
    if res_key is not None:
        positions.append(cur_pos)
        masks.append(cur_mask)
        bfs.append(cur_b)

    return Protein(
        atom_positions=np.array(positions),
        atom_mask=np.array(masks),
        aatype=np.array(aatypes, dtype=int),
        residue_index=np.array(res_idx, dtype=int),
        b_factors=np.array(bfs),
        chain_index=np.array(chains, dtype=int),
    )


def create_full_prot(atom37: np.ndarray, aatype=None, b_factors=None) -> Protein:
    assert atom37.ndim == 3 and atom37.shape[-2:] == (37, 3)
    n = atom37.shape[0]
    return Protein(
        atom_positions=atom37,
        atom_mask=(np.sum(np.abs(atom37), axis=-1) > 1e-7).astype(np.float32),
        aatype=np.zeros(n, int) if aatype is None else np.asarray(aatype),
        residue_index=np.arange(n),
        b_factors=np.zeros((n, 37)) if b_factors is None else b_factors,
        chain_index=np.zeros(n, int),
    )


def prots_to_pdb(prots) -> str:
    """Multi-MODEL trajectory PDB."""
    out = []
    for i, prot in enumerate(prots):
        out.append(f"MODEL {i}")
        out.extend(l for l in to_pdb(prot).splitlines() if l.startswith(("ATOM", "TER")))
        out.append("ENDMDL")
    return "\n".join(out) + "\n"


def _to37(atom14, aatype) -> np.ndarray:
    """[..., L, 14, 3] -> [..., L, 37, 3] float32 numpy, on the CPU."""
    atom14 = torch.as_tensor(np.asarray(atom14, np.float32))
    return atom14_to_atom37(atom14, torch.as_tensor(np.asarray(aatype))).numpy()


def _to14(atom37, aatype) -> np.ndarray:
    """[..., L, 37, 3] -> [..., L, 14, 3] float32 numpy, on the CPU."""
    atom37 = torch.as_tensor(np.asarray(atom37, np.float32))
    return atom37_to_atom14(atom37, torch.as_tensor(np.asarray(aatype))).numpy()


def load_pdb_trajectory(path: str):
    """Multi-MODEL PDB -> (atom14 [T, L, 14, 3] float32, aatype [L]).

    Inverse of :func:`atom14_to_pdb`."""
    with open(path) as fh:
        text = fh.read()
    models = []
    current: list[str] = []
    for line in text.splitlines():
        if line.startswith("MODEL"):
            current = []
        elif line.startswith("ENDMDL"):
            models.append("\n".join(current))
        elif line.startswith(("ATOM", "TER")):
            current.append(line)
    if not models and current:
        models = ["\n".join(current)]

    aatype = None
    frames = []
    for m in models:
        prot = from_pdb_string(m + "\nENDMDL")
        if aatype is None:
            aatype = prot.aatype
        frames.append(_to14(prot.atom_positions, aatype))
    return np.stack(frames).astype(np.float32), aatype


def atom14_to_pdb(atom14, aatype, path: str):
    """[T, L, 14, 3] trajectory (numpy or tensor) -> multi-MODEL PDB file."""
    aatype = np.asarray(aatype)
    atom37 = _to37(atom14, aatype)
    prots = [create_full_prot(pos37, aatype=aatype) for pos37 in atom37]
    with open(path, "w") as fh:
        fh.write(prots_to_pdb(prots))


def save_trajectory(atom14, aatype, pdb_path: str, xtc_path: Optional[str] = None):
    """Write a sampled trajectory. Without ``xtc_path``: a multi-MODEL PDB of
    all frames. With it: every frame superposed onto frame 0 (Kabsch over
    the atoms present at frame 0), written as an XTC (nm), and the PDB holds
    frame 0 alone, the topology the XTC is read with."""
    from .xtc import superpose, write_xtc_angstrom

    atom14 = np.asarray(atom14, np.float32)
    aatype = np.asarray(aatype)
    if xtc_path is None:
        atom14_to_pdb(atom14, aatype, pdb_path)
        return

    T, L = atom14.shape[:2]
    # the atom selection comes from frame 0 alone, so that the reader, which
    # has only the frame-0 topology, rebuilds the same one
    mask14 = rc.RESTYPE_ATOM14_MASK[aatype].astype(bool)
    mask14 &= np.abs(atom14[0]).sum(-1) > 1e-7  # drop padding residues
    flat = atom14.reshape(T, L * 14, 3)
    aligned = superpose(flat, mask14.reshape(-1)).reshape(T, L, 14, 3)

    atom14_to_pdb(aligned[:1], aatype, pdb_path)
    atom37 = _to37(aligned, aatype)
    mask37 = rc.RESTYPE_ATOM37_MASK[aatype].astype(bool)
    mask37 &= np.abs(atom37[0]).sum(-1) > 1e-7
    write_xtc_angstrom(xtc_path, atom37[:, mask37])


def load_trajectory(pdb_path: str):
    """Read what :func:`save_trajectory` wrote: with a sibling ``.xtc`` the
    PDB is the topology (frame 0) and the coordinates come from the XTC;
    otherwise the PDB is the whole multi-MODEL trajectory. Returns (atom14
    [T, L, 14, 3] float32 Angstrom, aatype [L])."""
    from .xtc import read_xtc

    atom14, aatype = load_pdb_trajectory(pdb_path)
    xtc_path = os.path.splitext(pdb_path)[0] + ".xtc"
    if not os.path.exists(xtc_path):
        return atom14, aatype

    coords_nm, _, _ = read_xtc(xtc_path)
    # the writer's atom selection (restype atom37 mask minus all-zero
    # padding atoms), rebuilt from the topology frame
    atom37_0 = _to37(atom14[:1], aatype)
    mask37 = rc.RESTYPE_ATOM37_MASK[aatype].astype(bool)
    mask37 &= (np.abs(atom37_0).sum(-1) > 1e-7).any(0)
    n_sel = int(mask37.sum())
    if coords_nm.shape[1] != n_sel:
        raise ValueError(f"{xtc_path}: {coords_nm.shape[1]} atoms vs {n_sel} in topology")
    T, L = coords_nm.shape[0], aatype.shape[0]
    out37 = np.zeros((T, L, 37, 3), np.float32)
    out37[:, mask37] = coords_nm.astype(np.float32) * 10.0
    return _to14(out37, aatype), aatype
