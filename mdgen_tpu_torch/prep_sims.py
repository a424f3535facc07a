"""MD preprocessing: raw trajectories -> atom14 float16 ``.npy`` inputs.

    python -m mdgen_tpu_torch.prep_sims --split splits/4AA.csv --sim_dir SIMS \\
        --outdir data/4AA_sims --pdb_traj [--atlas] [--stride N] [--suffix S] \\
        [--num_workers N]

The port's counterpart of ``scripts/prep_sims.py``, with no jax and no
pandas (the split is read with ``csv``). Writes ``{outdir}/{name}{suffix}.npy``
of shape [T, L, 14, 3], float16, Angstroms, every ``--stride``-th frame; an
output that exists already is skipped. Two inputs:
  * ``--pdb_traj``: ``{sim_dir}/{name}.pdb`` multi-MODEL trajectories, read by
    ``protein.load_pdb_trajectory`` (no dependencies);
  * otherwise ``{sim_dir}/{name}/{name}.xtc`` with its ``.pdb`` topology,
    through mdtraj (imported when used; it fails the same way where mdtraj
    is missing), superposed onto frame 0, nm -> Angstrom.
``--atlas`` reads the three replicas ``{name}_prod_R{1,2,3}_fit`` of each
entry and writes them as ``{name}_R{1,2,3}``. ``--num_workers N > 1`` runs
the jobs in a pool of spawned processes.
"""
from __future__ import annotations

import argparse
import functools
import multiprocessing
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--split", type=str, required=True)
    p.add_argument("--sim_dir", type=str, required=True)
    p.add_argument("--outdir", type=str, required=True)
    p.add_argument("--suffix", type=str, default="")
    p.add_argument("--stride", type=int, default=1)
    p.add_argument("--atlas", action="store_true")
    p.add_argument("--pdb_traj", action="store_true",
                   help="read {sim_dir}/{name}.pdb multi-MODEL trajectories instead of XTC "
                        "via mdtraj")
    p.add_argument("--num_workers", type=int, default=1)
    return p.parse_args(argv)


def xtc_to_atom14(xtc_path: str, top_path: str) -> np.ndarray:
    import mdtraj

    from .geometry import constants as rc

    traj = mdtraj.load(xtc_path, top=top_path)
    traj.superpose(traj)
    top = traj.topology
    out = np.zeros((traj.n_frames, top.n_residues, 14, 3), dtype=np.float16)
    for res in top.residues:
        names14 = rc.restype_name_to_atom14_names.get(res.name, [""] * 14)
        for atom in res.atoms:
            if atom.name in names14:
                slot = names14.index(atom.name)
                out[:, res.index, slot] = traj.xyz[:, atom.index] * 10.0  # nm -> A
    return out


def pdb_traj_to_atom14(path: str) -> np.ndarray:
    from .protein import load_pdb_trajectory

    atom14, _ = load_pdb_trajectory(path)
    return atom14.astype(np.float16)


def do_job(job, args) -> str:
    name, out_name = job
    out_path = os.path.join(args.outdir, f"{out_name}{args.suffix}.npy")
    if os.path.exists(out_path):
        return out_name
    if args.pdb_traj:
        arr = pdb_traj_to_atom14(os.path.join(args.sim_dir, f"{name}.pdb"))
    else:
        arr = xtc_to_atom14(os.path.join(args.sim_dir, name, f"{name}.xtc"),
                            os.path.join(args.sim_dir, name, f"{name}.pdb"))
    np.save(out_path, arr[:: args.stride])
    return out_name


def jobs_of(args) -> list[tuple[str, str]]:
    """(input name, output name) of every trajectory the split names."""
    from .data import read_split

    jobs = []
    for name in read_split(args.split):
        if args.atlas:
            jobs += [(f"{name}_prod_R{rep}_fit", f"{name}_R{rep}") for rep in (1, 2, 3)]
        else:
            jobs.append((name, name))
    return jobs


def main(argv=None) -> list[str]:
    """Returns the output names, in the split's order."""
    args = parse_args(argv)
    os.makedirs(args.outdir, exist_ok=True)
    job = functools.partial(do_job, args=args)
    done = []
    if args.num_workers > 1:
        with multiprocessing.get_context("spawn").Pool(args.num_workers) as pool:
            for name in pool.imap(job, jobs_of(args)):
                print("done", name)
                done.append(name)
    else:
        for j in jobs_of(args):
            done.append(job(j))
            print("done", done[-1])
    return done


if __name__ == "__main__":
    main()
