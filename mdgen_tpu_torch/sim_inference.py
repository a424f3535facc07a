"""Forward-simulation inference: autoregressive rollouts from a start frame.

Port of the repository's ``sim_inference.py`` on PyTorch:

  python -m mdgen_tpu_torch.sim_inference --sim_ckpt CKPT --data_dir DATA \\
      --split splits/4AA_test.csv --num_rollouts 10 --out_dir OUT --fused_block

``CKPT`` is a port checkpoint directory (``runtime/checkpoint.py``; convert a
JAX one with ``tools/jax_to_torch_ckpt.py``). The ODE solver is the
checkpoint's ``sampling_method`` (euler, heun or dopri5); each batch prints
its drift evaluations per solve (and dopri5's attempts and rejections).
``--xtc`` superposes every frame onto frame 0 and writes ``{name}.xtc``
beside a frame-0 ``{name}.pdb``; without it ``{name}.pdb`` holds every
frame. The split CSV is read with the ``csv`` module. The run needs a CUDA
device unless ``--device cpu`` is given explicitly.

``--dp_size N`` samples each batch on N data-parallel ranks, started by this
command (``parallel.plan_ranks``: ``cuda:i`` a rank with NCCL; ``--device
cuda:K --dist_backend gloo`` puts them all on card K; ``--device cpu`` runs
gloo ranks on the CPU; -1 takes every visible card). Each rank pads the
batch to a multiple of N with copies of peptide 0, keeps its rows, draws
the noise of the unpadded batch and keeps its rows of it (a pad takes row
0's), so its samples are the ones one rank draws for the same
``--batch_size`` and ``--seed``; dopri5 takes the steps one rank takes
(``integrators.ode_dopri5``). Rank 0 gathers the samples, drops the pads,
writes the files and prints.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--sim_ckpt", type=str, required=True,
                   help="port checkpoint directory (config.json + model.pt)")
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--suffix", type=str, default="")
    p.add_argument("--pdb_id", nargs="*", default=[])
    p.add_argument("--num_rollouts", type=int, default=100)
    p.add_argument("--out_dir", type=str, default=".")
    p.add_argument("--split", type=str, default="splits/4AA_test.csv")
    p.add_argument("--seed", type=int, default=137)
    p.add_argument("--batch_size", type=int, default=1,
                   help="peptides sampled per device batch")
    p.add_argument("--xtc", action="store_true",
                   help="superpose to frame 0 and write XTC + frame-0 PDB")
    p.add_argument("--fused_block", action="store_true",
                   help="run each trunk layer as three fused CUDA sublayer "
                        "kernels (ops/, csrc/)")
    add_dp_args(p)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def add_dp_args(p) -> None:
    """The inference CLIs' data-parallel flags."""
    p.add_argument("--dp_size", type=int, default=0,
                   help="data-parallel ranks sharing each batch (0: one process; -1: every "
                        "visible card)")
    p.add_argument("--dist_backend", type=str, default=None, choices=["nccl", "gloo"],
                   help="default: nccl on CUDA, gloo on the CPU; gloo lets ranks share a card")
    p.add_argument("--record", type=str, default=None,
                   help="write each rank's records and kernel launches as JSON ({rank} in the "
                        "path becomes the rank)")


def run_ranks(args, fn, *extra):
    """``fn(rank, device, grid, args, *extra)`` on each of ``--dp_size``
    ranks (``parallel.launch``); returns rank 0's result."""
    from .parallel import launch, plan_ranks

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to run on the CPU")
    os.makedirs(args.out_dir, exist_ok=True)
    plan = plan_ranks(args.dp_size or 1, args.device, backend=args.dist_backend)
    return launch(plan, _on_grid, plan.world, fn, args, *extra)


def _on_grid(rank, device, world, fn, args, *extra):
    from .parallel import make_grid

    records = fn(rank, device, make_grid(world), args, *extra)
    if args.record:
        from .ops import launch_counts

        with open(args.record.replace("{rank}", str(rank)), "w") as fh:
            json.dump({"records": records, "launches": launch_counts()}, fh,
                      default=lambda a: a.tolist())  # numpy arrays
    return records


def main(argv=None, keep_trajectories: bool = False):
    """Returns one record per sampled batch: {names, frames, seconds, paths
    (the PDBs), solves (the solver's counts, one dict per rollout),
    write_seconds (the PDB and XTC writers')}, and with
    ``keep_trajectories`` the sampled atom14 [B, R*T, L, 14, 3] as "traj"."""
    return run_ranks(parse_args(argv), _sample, keep_trajectories)


def _sample(rank, device, grid, args, keep_trajectories):
    from .data import read_split
    from .geometry import constants as rc
    from .parallel import pad_batch_to_dp, shard_batch
    from .protein import save_trajectory
    from .runtime import MDGenRuntime, checkpoint

    cfg = checkpoint.load_config(args.sim_ckpt)
    if args.fused_block:
        cfg = cfg.replace(fused_block=True)
    model, step = checkpoint.load_model(args.sim_ckpt, cfg, device)
    say = print if rank == 0 else (lambda *a: None)
    say(f"restored {args.sim_ckpt} at step {step}"
        + (f"; sampling on {grid.dp.size} data-parallel ranks" if grid.dp.size > 1 else ""))
    dp = grid.dp
    rt = MDGenRuntime(cfg, model, dp)

    split = read_split(args.split)
    names = [n for n in split if not args.pdb_id or n in args.pdb_id]
    generator = torch.Generator(device=device).manual_seed(args.seed)

    by_len: dict[int, list[str]] = {}
    for name in names:
        by_len.setdefault(len(split[name]), []).append(name)

    records = []
    for _, group in sorted(by_len.items()):
        for i in range(0, len(group), args.batch_size):
            chunk = group[i : i + args.batch_size]
            starts = [
                np.asarray(np.load(os.path.join(args.data_dir, f"{n}{args.suffix}.npy"),
                                   mmap_mode="r")[0], dtype=np.float32)
                for n in chunk
            ]
            seqres = np.stack([rc.str_sequence_to_aatype(split[n]) for n in chunk])
            padded, n = pad_batch_to_dp({"start": np.stack(starts), "seqres": seqres}, grid)
            mine = shard_batch(grid, padded)
            start = torch.from_numpy(mine["start"]).to(device)
            seqres_t = torch.from_numpy(mine["seqres"]).long().to(device)
            mask = torch.ones(seqres_t.shape, dtype=torch.float32, device=device)
            rows = (dp.index * len(seqres_t), n) if dp.size > 1 else None

            if device.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            solves = []
            traj = rt.rollout(start, seqres_t, mask, args.num_rollouts, generator=generator,
                              stats=solves, rows=rows)
            traj = dp.gather(traj)[:n].cpu().numpy()  # synchronizes
            dur = time.perf_counter() - t0
            frames = len(chunk) * traj.shape[1]
            say(f"{','.join(chunk)}: {frames} frames in {dur:.2f}s "
                f"({frames / dur:.1f} frames/s); {solve_line(cfg.sampling_method, solves)}")
            paths = [os.path.join(args.out_dir, f"{name}.pdb") for name in chunk]
            t0 = time.perf_counter()
            for j, path in enumerate(paths if rank == 0 else []):
                save_trajectory(traj[j], seqres[j], path,
                                xtc_path=os.path.splitext(path)[0] + ".xtc" if args.xtc else None)
            records.append({"names": chunk, "frames": frames, "seconds": dur, "paths": paths,
                            "solves": solves, "write_seconds": time.perf_counter() - t0})
            if keep_trajectories:
                records[-1]["traj"] = traj
    return records


def solve_line(method: str, solves) -> str:
    """Drift evaluations per solve and, for dopri5, its attempts and
    rejections; a solve that stopped short of t1 is named."""
    evals = [s["evals"] for s in solves]
    line = (f"{method}, {sum(evals) / len(evals):.1f} drift evaluations per solve "
            f"(min {min(evals)}, max {max(evals)})")
    if method == "dopri5":
        line += (f", {sum(s['attempts'] for s in solves)} attempts, "
                 f"{sum(s['rejected'] for s in solves)} rejected")
    short = [i for i, s in enumerate(solves) if not s["reached_t1"]]
    if short:
        line += f"; solves {short} spent max_steps before t1"
    return line


if __name__ == "__main__":
    main()
