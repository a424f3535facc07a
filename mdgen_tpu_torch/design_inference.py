"""Inpainting and sequence design along high-flux transitions of the
reference MD.

Port of the repository's ``design_inference.py`` on PyTorch:

  python -m mdgen_tpu_torch.design_inference --sim_ckpt CKPT --data_dir DATA \\
      --split splits/4AA_test.csv --num_batches 10 --batch_size 32 --out_dir OUT --fused_block

For each peptide the reference MD (``{data_dir}/{name}{suffix}.npy``) gets an
MSM (``analysis.reference_msm``), cached in ``OUT/{name}_metadata.pkl``; a
cache written by the JAX CLI is refused, never loaded. The windows start in
the start state of the highest-flux transition and are in its end state
``--num_frames`` frames later; with ``--random_start_idx`` they start
anywhere (and an MSM that cannot be built only leaves the states at -1).
The checkpoint's ``frame_interval`` strides the MD and its labels. Start
indices are drawn with ``np.random.default_rng(--seed)`` in the JAX CLI's
order, so with the same MSM the metadata names the same windows. The
checkpoint's ``sampling_method`` integrates each batch; the designed
positions' sequence comes from the Dirichlet flow (the mpnn modes: one
forward at t = 1). Each sample goes to ``OUT/{name}_{idx}.pdb`` with its
designed sequence, and ``OUT/{name}_metadata.json`` lists them with the JAX
CLI's fields. The split CSV is read with ``csv``. The run needs a CUDA
device unless ``--device cpu`` is given. ``--dp_size N`` shares each batch
over N data-parallel ranks, as ``sim_inference``'s flag does (rank 0 builds
the MSM cache first; rank 0 writes the samples and the metadata).
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
                   help="port checkpoint directory (config.json + model.pt) of a --design run")
    p.add_argument("--data_dir", type=str, required=True,
                   help="directory of atom14 .npy trajectories")
    p.add_argument("--suffix", type=str, default="")
    p.add_argument("--pdb_id", nargs="*", default=[])
    p.add_argument("--num_frames", type=int, default=100)
    p.add_argument("--num_batches", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--random_start_idx", action="store_true")
    p.add_argument("--out_dir", type=str, default=".")
    p.add_argument("--split", type=str, default="splits/4AA_test.csv")
    p.add_argument("--chunk_idx", type=int, default=0)
    p.add_argument("--n_chunks", type=int, default=1)
    p.add_argument("--seed", type=int, default=137)
    p.add_argument("--tica_lag", type=int, default=1000)
    p.add_argument("--msm_lag", type=int, default=1000)
    p.add_argument("--fused_block", action="store_true",
                   help="run each trunk layer as three fused CUDA sublayer kernels")
    p.add_argument("--dirichlet_flow_temp", type=float, default=None,
                   help="override the checkpoint's Dirichlet-flow sampling temperature")
    add_dp_args(p)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv=None, keep_trajectories: bool = False):
    """Returns one record per sampled batch: {name, batch, paths (the PDBs),
    start_idx, aa_out (the designed sequences), seconds, solves (the
    solver's counts), write_seconds (the PDB writer's)}, and with
    ``keep_trajectories`` the sampled atom14 [B, T, L, 14, 3] as "traj" and
    the designed aatypes [B, L] as "aatype"."""
    return run_ranks(parse_args(argv), _sample, keep_trajectories)


def _sample(rank, device, grid, args, keep_trajectories):
    from .analysis.reference_msm import JaxCacheError, highest_flux_states, load_or_build_msm
    from .data import read_split
    from .geometry import constants as rc
    from .parallel import pad_batch_to_dp, shard_batch
    from .protein import atom14_to_pdb
    from .runtime import MDGenRuntime, checkpoint

    cfg = checkpoint.load_config(args.sim_ckpt)
    if args.fused_block:
        cfg = cfg.replace(fused_block=True)
    if args.dirichlet_flow_temp is not None:
        cfg = cfg.replace(dirichlet_flow_temp=args.dirichlet_flow_temp)
    if not cfg.design:
        raise ValueError(f"{args.sim_ckpt} was not trained with --design")
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
        seq = split[name]
        aatype = rc.str_sequence_to_aatype(seq)
        L = len(aatype)
        arr = np.lib.format.open_memmap(
            os.path.join(args.data_dir, f"{name}{args.suffix}.npy"), "r")
        try:
            meta = dp.in_turn(lambda: load_or_build_msm(
                f"{args.out_dir}/{name}_metadata.pkl", arr, aatype, tica_lag=args.tica_lag,
                msm_lag=args.msm_lag, seed=args.seed))
            start_state, end_state = highest_flux_states(meta["cmsm"])
            ref_discrete = meta["ref_discrete"]
        except JaxCacheError:
            raise
        except Exception as e:
            if not args.random_start_idx:
                raise
            # with --random_start_idx the MSM only labels the metadata
            say(f"MSM unavailable for {name} ({e}); using random windows")
            start_state = end_state = -1
            ref_discrete = np.zeros(len(arr), dtype=int)
        if cfg.frame_interval:
            arr = arr[:: cfg.frame_interval]
            ref_discrete = ref_discrete[:: cfg.frame_interval]

        T, B = args.num_frames, args.batch_size
        # windows in the start state whose frame T later is in the end state
        trans_idx = np.where((ref_discrete == start_state)[:-T]
                             * (ref_discrete == end_state)[T:])[0]
        if len(trans_idx) == 0 and not args.random_start_idx:
            say(f"no transition window for {name}, skipping")
            continue

        metadata = []
        for i in range(args.num_batches):
            if args.random_start_idx:
                si = rng.integers(0, len(arr) - T, B)
            else:
                si = rng.choice(trans_idx, B)
            atom14 = np.stack([np.asarray(arr[s: s + T], np.float32) for s in si])
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
            atom14s, aa_out = rt.inference(batch, generator, stats=solve,
                                           rows=(dp.index * Bl, B) if dp.size > 1 else None)
            atom14s, aa_out = (dp.gather(x)[:B].cpu().numpy()  # synchronizes
                               for x in (atom14s, aa_out))
            dur = time.perf_counter() - t0
            say(f"{name} batch {i}: {B} designs x {atom14s.shape[1]} frames in {dur:.2f}s "
                f"({B / dur:.2f} samples/s); "
                + (solve_line(cfg.sampling_method, [solve]) if solve else
                   "one forward at t = 1 (mpnn)"))
            paths, designed = [], []
            t0 = time.perf_counter()
            for j in range(B):
                path = os.path.join(args.out_dir, f"{name}_{i * B + j}.pdb")
                if rank == 0:
                    atom14_to_pdb(atom14s[j], aa_out[j, 0], path)
                paths.append(path)
                designed.append(rc.aatype_to_str_sequence(aa_out[j, 0]))
                metadata.append({"name": name, "start_idx": int(si[j]),
                                 "end_idx": int(si[j] + T), "start_state": int(start_state),
                                 "end_state": int(end_state), "aa_out": designed[-1],
                                 "seqres": seq, "path": path})
            records.append({"name": name, "batch": i, "paths": paths, "start_idx": si,
                            "aa_out": designed, "seconds": dur,
                            "solves": [solve] if solve else [],
                            "write_seconds": time.perf_counter() - t0})
            if keep_trajectories:
                records[-1]["traj"], records[-1]["aatype"] = atom14s, aa_out[:, 0]
        if rank == 0:
            with open(f"{args.out_dir}/{name}_metadata.json", "w") as fh:
                json.dump(metadata, fh)
    return records


if __name__ == "__main__":
    main()
