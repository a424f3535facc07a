"""Synthetic peptide trajectories (port of ``mdgen_tpu/data/synthetic.py``).

:func:`synthetic_trajectory` (rigid literature sidechains, numpy only) makes
the start structure for the forward-simulation smoke run and benchmark;
:func:`synthetic_rotamer_trajectory` (multi-basin psi and chi dynamics,
atoms rebuilt from frames and torsions with the port's geometry) makes the
reference MD of the quality run, through :func:`write_synthetic_dataset`.
Both draw the same numbers, in the same order, as the JAX package's copies.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..geometry import constants as rc


def _smooth_noise(rng, T, shape, smooth=20):
    """Temporally smooth gaussian noise via a moving average."""
    x = rng.normal(size=(T + smooth, *shape))
    kernel = np.ones(smooth) / smooth
    x = np.apply_along_axis(lambda v: np.convolve(v, kernel, mode="valid"), 0, x)
    return x[:T]


def synthetic_trajectory(seqres: str, num_frames: int, seed: int = 0) -> np.ndarray:
    """[T, L, 14, 3] float16 atom14 trajectory: idealized literature residues
    along x with slowly varying random rotations and offsets."""
    rng = np.random.default_rng(seed)
    aatype = rc.str_sequence_to_aatype(seqres)
    L = len(aatype)
    T = num_frames

    lit = rc.restype_atom14_rigid_group_positions[aatype]  # L, 14, 3
    mask = rc.restype_atom14_mask[aatype][..., None]  # L, 14, 1

    angles = _smooth_noise(rng, T, (L, 3), smooth=16) * 0.8
    offsets = _smooth_noise(rng, T, (L, 3), smooth=16) * 1.5

    out = np.zeros((T, L, 14, 3), dtype=np.float32)
    base = np.stack([np.arange(L) * 3.8, np.zeros(L), np.zeros(L)], axis=-1)
    for t in range(T):
        cx, sx = np.cos(angles[t, :, 0]), np.sin(angles[t, :, 0])
        cy, sy = np.cos(angles[t, :, 1]), np.sin(angles[t, :, 1])
        cz, sz = np.cos(angles[t, :, 2]), np.sin(angles[t, :, 2])
        Rx = np.zeros((L, 3, 3))
        Rx[:, 0, 0] = 1
        Rx[:, 1, 1], Rx[:, 1, 2] = cx, -sx
        Rx[:, 2, 1], Rx[:, 2, 2] = sx, cx
        Ry = np.zeros((L, 3, 3))
        Ry[:, 1, 1] = 1
        Ry[:, 0, 0], Ry[:, 0, 2] = cy, sy
        Ry[:, 2, 0], Ry[:, 2, 2] = -sy, cy
        Rz = np.zeros((L, 3, 3))
        Rz[:, 2, 2] = 1
        Rz[:, 0, 0], Rz[:, 0, 1] = cz, -sz
        Rz[:, 1, 0], Rz[:, 1, 1] = sz, cz
        R = Rx @ Ry @ Rz
        pos = np.einsum("lij,laj->lai", R, lit) + (base + offsets[t])[:, None]
        out[t] = pos * mask
    return out.astype(np.float16)


def _ou_noise(rng, T, shape, tau: float, sigma: float):
    """Stationary Ornstein-Uhlenbeck process: correlation time ``tau``
    frames, stationary std ``sigma``. Vectorized exact discretization."""
    a = np.exp(-1.0 / tau)
    b = sigma * np.sqrt(1.0 - a * a)
    eps = rng.normal(size=(T, *shape))
    x = np.empty((T, *shape))
    x[0] = rng.normal(size=shape) * sigma
    for t in range(1, T):
        x[t] = a * x[t - 1] + b * eps[t]
    return x


def _replay_rotamer_dist_params(seed: int, T: int, L: int, chi_mask):
    """Replays :func:`synthetic_rotamer_trajectory`'s DEFAULT-mode draw
    sequence at trajectory length ``T`` and returns the distribution
    parameters {(li, ti): (probs, dwell)} that a default-mode call with
    (seed, T) uses. Consumes the rng exactly as the generator does (the
    number of in-loop jump draws is data-dependent), so the extracted
    params are exact — this is what lets a noise floor / eval set be drawn
    from the SAME physical system as an existing default-mode dataset."""
    rng = np.random.default_rng(seed)
    rng.normal(size=(T + 16, L, 3))  # angles (_smooth_noise, smooth=16)
    rng.normal(size=(T + 16, L, 3))  # offsets
    params = {}
    for li in range(L):
        for ti in range(2, 7):
            if ti >= 3 and not chi_mask[li, ti - 3]:
                continue
            basins = _PSI_BASINS if ti == 2 else _CHI_BASINS
            nb = len(basins)
            probs = rng.dirichlet(np.full(nb, 2.0))
            dwell = float(np.exp(rng.uniform(np.log(50.0), np.log(500.0))))
            params[(li, ti)] = (probs, dwell)
            rng.choice(nb, p=probs)  # state[0]
            u = rng.random(T)
            for _ in range(int((u[1:] < 1.0 / dwell).sum())):
                rng.choice(nb, p=probs)  # in-loop jump draws
            rng.normal(size=(T,))  # _ou_noise eps
            rng.normal(size=())  # _ou_noise x[0]
    return params


# rotamer basin centers (radians): the standard gauche-/gauche+/trans wells
_CHI_BASINS = np.deg2rad([-60.0, 60.0, 180.0])
# psi-like backbone wells (helix / sheet), used for the psi torsion which IS
# reconstructed into atoms (it places the backbone O)
_PSI_BASINS = np.deg2rad([-45.0, 135.0])


def synthetic_rotamer_trajectory(
    seqres: str,
    num_frames: int,
    seed: int = 0,
    path_seed: int | None = None,
    replay_frames: int | None = None,
    _dist_out: dict | None = None,
) -> np.ndarray:
    """Build a [T, L, 14, 3] float16 atom14 trajectory with REAL torsional
    dynamics: psi and chi1-4 evolve as multi-basin Markov jump processes with
    thermal (OU) within-basin fluctuation, and atoms are reconstructed from
    (frames, torsions) via the model's own geometry. Compared to
    :func:`synthetic_trajectory` (rigid literature sidechains -> delta-
    function chi marginals), this gives the analysis JSDs thermally-broadened
    multi-modal rotamer marginals and slow basin-hopping kinetics (TICA
    signal) — the same statistics real tetrapeptide MD exhibits (reference
    data contract: `scripts/prep_sims.py:54-62`).

    ``seed`` defines the physical SYSTEM (per-torsion basin occupancies and
    jump kinetics are drawn from it), not just the noise realization. With
    ``path_seed=None`` (default) one stream drives both — byte-identical to
    the original generator. Passing ``path_seed`` splits the streams: the
    distribution parameters still come from ``seed`` (fixed order, so two
    calls with the same seed describe the same system) while ALL trajectory
    randomness comes from ``path_seed`` — an independent sample of the SAME
    dynamics, which is what a sampling-noise floor needs
    (scripts/noise_floor.py). NOTE: default mode interleaves distribution
    and path draws on one stream, so plain ``path_seed=K`` at the same seed
    is a *different* system than a default-mode dataset. To resample the
    system of an EXISTING default-mode dataset, additionally pass
    ``replay_frames`` = that dataset's num_frames: the distribution
    parameters are then recovered by exact replay of the default draw
    sequence (:func:`_replay_rotamer_dist_params`).

    ``_dist_out``: debug/test hook — filled with the (probs, dwell) actually
    used per torsion.

    The atoms are rebuilt with the port's geometry on the CPU in f32, in
    1000-frame chunks, from the same numpy draws as the JAX package's copy.
    """
    from ..geometry import Rigid, frames_torsions_to_atom14

    rng = np.random.default_rng(seed)
    split = path_seed is not None
    rng_path = np.random.default_rng(path_seed) if split else rng
    aatype = rc.str_sequence_to_aatype(seqres)
    L = len(aatype)
    T = num_frames
    chi_mask = np.asarray(rc.chi_angles_mask)[np.asarray(aatype)]  # [L, 4]
    if replay_frames is not None:
        if not split:
            raise ValueError("replay_frames requires path_seed")
        replayed = _replay_rotamer_dist_params(seed, replay_frames, L, chi_mask)
    else:
        replayed = None

    # ---- backbone frames: slow smooth rigid motion (as v1) ---------------
    angles = _smooth_noise(rng_path, T, (L, 3), smooth=16) * 0.8
    offsets = _smooth_noise(rng_path, T, (L, 3), smooth=16) * 1.5
    base = np.stack([np.arange(L) * 3.8, np.zeros(L), np.zeros(L)], axis=-1)
    cx, sx = np.cos(angles[..., 0]), np.sin(angles[..., 0])
    cy, sy = np.cos(angles[..., 1]), np.sin(angles[..., 1])
    cz, sz = np.cos(angles[..., 2]), np.sin(angles[..., 2])
    Rx = np.zeros((T, L, 3, 3))
    Rx[..., 0, 0] = 1
    Rx[..., 1, 1], Rx[..., 1, 2] = cx, -sx
    Rx[..., 2, 1], Rx[..., 2, 2] = sx, cx
    Ry = np.zeros((T, L, 3, 3))
    Ry[..., 1, 1] = 1
    Ry[..., 0, 0], Ry[..., 0, 2] = cy, sy
    Ry[..., 2, 0], Ry[..., 2, 2] = -sy, cy
    Rz = np.zeros((T, L, 3, 3))
    Rz[..., 2, 2] = 1
    Rz[..., 0, 0], Rz[..., 0, 1] = cz, -sz
    Rz[..., 1, 0], Rz[..., 1, 1] = sz, cz
    rots = (Rx @ Ry @ Rz).astype(np.float32)
    trans = (base[None] + offsets).astype(np.float32)

    # ---- torsions: multi-basin Markov + OU thermal jitter ----------------
    # torsion order (omega, phi, psi, chi1-4); omega/phi place no atoms in
    # the atom14 reconstruction, so only psi + chi1-4 carry signal
    tors = np.zeros((T, L, 7))
    for li in range(L):
        for ti in range(2, 7):  # psi, chi1..chi4
            if ti >= 3 and not chi_mask[li, ti - 3]:
                continue
            basins = _PSI_BASINS if ti == 2 else _CHI_BASINS
            nb = len(basins)
            # per-torsion equilibrium occupancy + slow jump kinetics
            if replayed is not None:
                probs, dwell = replayed[(li, ti)]
            else:
                probs = rng.dirichlet(np.full(nb, 2.0))
                dwell = float(
                    np.exp(rng.uniform(np.log(50.0), np.log(500.0)))
                )
            if _dist_out is not None:
                _dist_out[(li, ti)] = (probs, dwell)
            state = np.empty(T, np.int64)
            state[0] = rng_path.choice(nb, p=probs)
            u = rng_path.random(T)
            jumps = u < 1.0 / dwell
            for t in range(1, T):
                state[t] = (
                    rng_path.choice(nb, p=probs) if jumps[t] else state[t - 1]
                )
            jitter = _ou_noise(rng_path, T, (), tau=10.0, sigma=0.2)
            tors[:, li, ti] = basins[state] + jitter
    # omega near trans, phi unconstrained smooth (neither is reconstructed)
    tors[:, :, 0] = np.pi
    tors[:, :, 1] = 0.0

    torsions_sc = np.stack([np.sin(tors), np.cos(tors)], axis=-1).astype(
        np.float32
    )

    # ---- reconstruct atoms with the framework's own geometry -------------
    out = np.empty((T, L, 14, 3), np.float32)
    aat = np.broadcast_to(np.asarray(aatype)[None], (T, L))
    chunk = 1000
    with torch.no_grad():
        for s in range(0, T, chunk):
            e = min(s + chunk, T)
            frames = Rigid(torch.from_numpy(rots[s:e]), torch.from_numpy(trans[s:e]))
            out[s:e] = frames_torsions_to_atom14(
                frames, torch.from_numpy(torsions_sc[s:e]), torch.from_numpy(aat[s:e].copy())
            ).numpy()
    mask = rc.restype_atom14_mask[aatype][..., None]
    return (out * mask).astype(np.float16)


def write_synthetic_dataset(
    out_dir: str,
    names_seqs: list[tuple[str, str]],
    num_frames: int,
    suffix: str = "",
    seed: int = 0,
    rotamers: bool = False,
    path_seed: int | None = None,
    replay_frames: int | None = None,
) -> str:
    """Write ``.npy`` memmaps + a split CSV; returns the CSV path.

    ``rotamers=True`` uses :func:`synthetic_rotamer_trajectory` (thermal
    multi-basin sidechain dynamics) instead of the rigid-sidechain v1
    generator. ``path_seed`` (rotamers only) resamples an independent
    trajectory of the same per-peptide system; add ``replay_frames`` (the
    original dataset's num_frames) to match a default-mode dataset's
    systems exactly — see :func:`synthetic_rotamer_trajectory`."""
    os.makedirs(out_dir, exist_ok=True)
    gen = synthetic_rotamer_trajectory if rotamers else synthetic_trajectory
    rows = []
    for i, (name, seq) in enumerate(names_seqs):
        kw = {"path_seed": path_seed + i, "replay_frames": replay_frames} if (
            rotamers and path_seed is not None
        ) else {}
        traj = gen(seq, num_frames, seed=seed + i, **kw)
        np.save(os.path.join(out_dir, f"{name}{suffix}.npy"), traj)
        rows.append(f"{name},{seq}")
    csv_path = os.path.join(out_dir, "split.csv")
    with open(csv_path, "w") as fh:
        fh.write("name,seqres\n" + "\n".join(rows) + "\n")
    return csv_path
