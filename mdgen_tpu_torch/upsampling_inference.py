"""Trajectory upsampling: fill in the frames between the kept frames of a
low-framerate trajectory.

Port of the repository's ``upsampling_inference.py`` on PyTorch:

  python -m mdgen_tpu_torch.upsampling_inference --ckpt CKPT --data_dir DATA \\
      --suffix _i100 --split splits/4AA_implicit_test.csv --out_dir OUT --xtc

``CKPT`` is a port checkpoint of a ``--sim_condition --cond_interval N`` run.
The kept frames (``{data_dir}/{name}{suffix}.npy``) are tokenized once on
the device and packed into windows of ``num_frames`` frames, a kept frame at
every ``cond_interval``-th slot and identity frames with zero torsions in
between (``tasks.build_upsampling_windows``); ``--batch_size`` windows are
sampled at a time (the last group padded, its padding dropped:
``tasks.pad_window_groups``) with the checkpoint's ``sampling_method``, and
the windows are concatenated into ``OUT/{name}.pdb`` (with ``--xtc``: a
frame-0 PDB and the superposed ``.xtc``). Each peptide's line gives frames/s,
the solver's drift evaluations, and how far the sampled frames at the kept
slots lie from the kept frames (backbone N, CA, C; the sampler does not clamp
them, so this measures the model). The run needs a CUDA device unless
``--device cpu``. ``--dp_size N`` shares each group of windows over N
data-parallel ranks, as ``sim_inference``'s flag does (rank 0 writes).
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from .sim_inference import add_dp_args, run_ranks, solve_line


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", type=str, required=True,
                   help="port checkpoint directory of a --cond_interval run")
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--suffix", type=str, default="_i100")
    p.add_argument("--pdb_id", nargs="*", default=[])
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--out_dir", type=str, default=".")
    p.add_argument("--split", type=str, default="splits/4AA_implicit_test.csv")
    p.add_argument("--seed", type=int, default=137)
    p.add_argument("--xtc", action="store_true",
                   help="superpose to frame 0 and write XTC + frame-0 PDB")
    p.add_argument("--fused_block", action="store_true",
                   help="run each trunk layer as three fused CUDA sublayer kernels")
    add_dp_args(p)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv=None, keep_trajectories: bool = False):
    """Returns one record per peptide: {name, frames, windows, seconds, path,
    solves (the solver's counts, one dict per window group), kept_err (max
    and mean |sampled - kept| over the kept frames' backbone atoms, A),
    write_seconds (the PDB and XTC writers')}, and with ``keep_trajectories``
    the sampled atom14 [frames, L, 14, 3] as "traj"."""
    return run_ranks(parse_args(argv), _sample, keep_trajectories)


def _sample(rank, device, grid, args, keep_trajectories):
    from .data import read_split
    from .geometry import constants as rc
    from .parallel.mesh import pad_batch_to_dp, shard_batch
    from .protein import save_trajectory
    from .runtime import MDGenRuntime, checkpoint, tokenize_atom14
    from .tasks import build_upsampling_windows, pad_window_groups

    cfg = checkpoint.load_config(args.ckpt)
    if args.fused_block:
        cfg = cfg.replace(fused_block=True)
    if not cfg.cond_interval:
        raise ValueError(f"{args.ckpt} was not trained with --cond_interval")
    model, step = checkpoint.load_model(args.ckpt, cfg, device)
    say = print if rank == 0 else (lambda *a: None)
    say(f"restored {args.ckpt} at step {step}")
    dp = grid.dp
    rt = MDGenRuntime(cfg, model, dp)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    T, ci = cfg.num_frames, cfg.cond_interval

    records = []
    for name, seq in read_split(args.split).items():
        if args.pdb_id and name not in args.pdb_id:
            continue
        aatype = rc.str_sequence_to_aatype(seq)
        L = len(aatype)
        arr = np.asarray(np.lib.format.open_memmap(
            os.path.join(args.data_dir, f"{name}{args.suffix}.npy"), "r"), dtype=np.float32)
        # tokenize the kept (low-framerate) frames once, on the device
        with torch.inference_mode():
            tok = tokenize_atom14({
                "atom14": torch.from_numpy(arr[None]).to(device),
                "seqres": torch.from_numpy(aatype[None]).long().to(device),
                "mask": torch.ones((1, L), dtype=torch.float32, device=device)})
        tok = {k: v[0].cpu().numpy() for k, v in tok.items()}
        windows = build_upsampling_windows(tok, T, ci)

        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        parts, solves = [], []
        for group, n_real in pad_window_groups(windows, args.batch_size):
            padded, n = pad_batch_to_dp({k: np.stack([g[k] for g in group]) for k in group[0]},
                                        grid)
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in shard_batch(grid, padded).items()}
            batch["seqres"] = batch["seqres"].long()
            solve = {}
            rows = (dp.index * len(batch["seqres"]), n) if dp.size > 1 else None
            atom14, _ = rt.inference(batch, generator, stats=solve, rows=rows)
            solves.append(solve)
            parts.append(dp.gather(atom14)[:n_real].reshape(-1, L, 14, 3))
        traj = torch.cat(parts).cpu().numpy()  # synchronizes
        dur = time.perf_counter() - t0
        kept = np.abs(traj[::ci, :, :3] - arr[: len(traj) // ci, :, :3])
        kept_err = (float(kept.max()), float(kept.mean()))
        path = os.path.join(args.out_dir, f"{name}.pdb")
        t0 = time.perf_counter()
        if rank == 0:
            save_trajectory(traj, aatype, path,
                            xtc_path=os.path.join(args.out_dir, f"{name}.xtc") if args.xtc
                            else None)
        write_s = time.perf_counter() - t0
        say(f"{name}: wrote {len(traj)} frames ({len(windows)} windows) to {path} in "
              f"{dur:.2f}s ({len(traj) / dur:.1f} frames/s); "
              f"{solve_line(cfg.sampling_method, solves)}; kept frames: backbone max "
              f"{kept_err[0]:.3f} A, mean {kept_err[1]:.3f} A from their inputs")
        records.append({"name": name, "frames": len(traj), "windows": len(windows),
                        "seconds": dur, "path": path, "solves": solves, "kept_err": kept_err,
                        "write_seconds": write_s})
        if keep_trajectories:
            records[-1]["traj"] = traj
    return records


if __name__ == "__main__":
    main()
