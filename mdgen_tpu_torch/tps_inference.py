"""Transition-path sampling: endpoint-conditioned paths between the two
lowest-flux metastable states of the reference MD.

Port of the repository's ``tps_inference.py`` on PyTorch:

  python -m mdgen_tpu_torch.tps_inference --sim_ckpt CKPT --data_dir DATA \\
      --split splits/4AA_test.csv --num_batches 100 --batch_size 10 --out_dir OUT --xtc

For each peptide the reference MD (``{data_dir}/{name}{suffix}.npy``) gets an
MSM (TICA -> k-means -> PCCA+ -> coarse MSM, ``analysis.reference_msm``),
cached in ``OUT/{name}_metadata.pkl``; a cache written by the JAX CLI is
refused (it pickles the JAX package's classes), never loaded. Start and end
frames are drawn with ``np.random.default_rng(--seed)`` in the JAX CLI's
order (per batch the start indices, then the end indices), so with the same
MSM ``OUT/{name}_metadata.json`` names the same frames. Each batch holds the
start frame repeated and the end frame last; the checkpoint's
``sampling_method`` integrates it (Euler, Heun or dopri5) and each path is
written to ``OUT/{name}_{idx}.pdb`` (with ``--xtc``: a frame-0 PDB and the
superposed ``.xtc``). The run needs a CUDA device unless ``--device cpu``.
``--dp_size N`` shares each batch of paths over N data-parallel ranks, as
``sim_inference``'s flag does (rank 0 builds the MSM cache first, the other
ranks read it; rank 0 writes the paths and the metadata).
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from .sim_inference import add_dp_args, run_ranks, solve_line


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--sim_ckpt", type=str, required=True,
                   help="port checkpoint directory (config.json + model.pt) of a "
                        "--tps_condition run")
    p.add_argument("--data_dir", type=str, required=True,
                   help="directory of atom14 .npy trajectories")
    p.add_argument("--suffix", type=str, default="")
    p.add_argument("--pdb_id", nargs="*", default=[])
    p.add_argument("--num_batches", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=10)
    p.add_argument("--out_dir", type=str, default=".")
    p.add_argument("--split", type=str, default="splits/4AA_test.csv")
    p.add_argument("--chunk_idx", type=int, default=0)
    p.add_argument("--n_chunks", type=int, default=1)
    p.add_argument("--seed", type=int, default=137)
    p.add_argument("--tica_lag", type=int, default=1000)
    p.add_argument("--msm_lag", type=int, default=1000)
    p.add_argument("--xtc", action="store_true",
                   help="superpose each path to its frame 0 and write XTC + frame-0 PDB")
    p.add_argument("--fused_block", action="store_true",
                   help="run each trunk layer as three fused CUDA sublayer kernels")
    add_dp_args(p)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv=None, keep_trajectories: bool = False):
    """Returns one record per sampled batch: {name, batch, paths (the PDBs),
    start_idx, end_idx, seconds, solves (the solver's counts), write_seconds
    (the PDB and XTC writers')}, and with
    ``keep_trajectories`` the sampled atom14 [B, T, L, 14, 3] as "traj"."""
    return run_ranks(parse_args(argv), _sample, keep_trajectories)


def _sample(rank, device, grid, args, keep_trajectories):
    from .analysis.reference_msm import load_or_build_msm, lowest_flux_states
    from .data import read_split
    from .geometry import constants as rc
    from .parallel.mesh import pad_batch_to_dp, shard_batch
    from .protein import save_trajectory
    from .runtime import MDGenRuntime, checkpoint

    cfg = checkpoint.load_config(args.sim_ckpt)
    if args.fused_block:
        cfg = cfg.replace(fused_block=True)
    if not cfg.tps_condition:
        raise ValueError(f"{args.sim_ckpt} was not trained with --tps_condition")
    model, step = checkpoint.load_model(args.sim_ckpt, cfg, device)
    say = print if rank == 0 else (lambda *a: None)
    say(f"restored {args.sim_ckpt} at step {step}")
    dp = grid.dp
    rt = MDGenRuntime(cfg, model, dp)
    rng = np.random.default_rng(args.seed)
    generator = torch.Generator(device=device).manual_seed(args.seed)

    split = read_split(args.split)
    names = np.array_split(np.array(list(split)), args.n_chunks)[args.chunk_idx]
    records = []
    for name in names:
        name = str(name)
        if args.pdb_id and name not in args.pdb_id:
            continue
        if os.path.exists(f"{args.out_dir}/{name}_metadata.json"):
            continue
        aatype = rc.str_sequence_to_aatype(split[name])
        arr = np.lib.format.open_memmap(
            os.path.join(args.data_dir, f"{name}{args.suffix}.npy"), "r")
        meta = dp.in_turn(lambda: load_or_build_msm(
            f"{args.out_dir}/{name}_metadata.pkl", arr, aatype, tica_lag=args.tica_lag,
            msm_lag=args.msm_lag, seed=args.seed))
        start_state, end_state = lowest_flux_states(meta["cmsm"])
        ref_discrete = meta["ref_discrete"]
        start_idxs = np.where(ref_discrete == start_state)[0]
        end_idxs = np.where(ref_discrete == end_state)[0]
        if len(start_idxs) == 0 or len(end_idxs) == 0:
            say(f"no start/end state frames for {name}, skipping")
            continue

        L, T, B = len(aatype), cfg.num_frames, args.batch_size
        metadata = []
        for i in range(args.num_batches):
            si = rng.choice(start_idxs, B)
            ei = rng.choice(end_idxs, B)
            atom14 = np.empty((B, T, L, 14, 3), np.float32)
            for j in range(B):
                atom14[j, :] = arr[si[j]]
                atom14[j, -1] = arr[ei[j]]
            padded, _ = pad_batch_to_dp({"atom14": atom14}, grid)
            batch = {"atom14": torch.from_numpy(shard_batch(grid, padded)["atom14"]).to(device)}
            Bl = len(batch["atom14"])
            batch["seqres"] = torch.from_numpy(np.broadcast_to(aatype, (Bl, L)).copy()).long() \
                .to(device)
            batch["mask"] = torch.ones((Bl, L), dtype=torch.float32, device=device)
            if device.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            solve = {}
            paths_atom14, _ = rt.inference(batch, generator, stats=solve,
                                           rows=(dp.index * Bl, B) if dp.size > 1 else None)
            paths_atom14 = dp.gather(paths_atom14)[:B].cpu().numpy()  # synchronizes
            dur = time.perf_counter() - t0
            say(f"{name} batch {i}: {B} paths x {T} frames in {dur:.2f}s "
                f"({B / dur:.2f} paths/s); {solve_line(cfg.sampling_method, [solve])}")
            paths = []
            t0 = time.perf_counter()
            for j in range(B):
                idx = i * B + j
                path = os.path.join(args.out_dir, f"{name}_{idx}.pdb")
                if rank == 0:
                    save_trajectory(paths_atom14[j], aatype, path,
                                    xtc_path=os.path.join(args.out_dir, f"{name}_{idx}.xtc")
                                    if args.xtc else None)
                paths.append(path)
                metadata.append({"name": name, "start_idx": int(si[j]), "end_idx": int(ei[j]),
                                 "start_state": int(start_state), "end_state": int(end_state),
                                 "path": path})
            records.append({"name": name, "batch": i, "paths": paths, "start_idx": si,
                            "end_idx": ei, "seconds": dur, "solves": [solve],
                            "write_seconds": time.perf_counter() - t0})
            if keep_trajectories:
                records[-1]["traj"] = paths_atom14
        if rank == 0:
            with open(f"{args.out_dir}/{name}_metadata.json", "w") as fh:
                json.dump(metadata, fh)
    return records


if __name__ == "__main__":
    main()
