"""Forward-simulation inference: autoregressive rollouts from a start frame.

Port of the repository's ``sim_inference.py`` on PyTorch:

  python -m mdgen_tpu_torch.sim_inference --sim_ckpt CKPT --data_dir DATA \\
      --split splits/4AA_test.csv --num_rollouts 10 --out_dir OUT --fused_block

``CKPT`` is a port checkpoint directory (``runtime/checkpoint.py``; convert a
JAX one with ``tools/jax_to_torch_ckpt.py``). The split CSV is read with the
``csv`` module. The run needs a CUDA device unless ``--device cpu`` is
given explicitly.
"""
from __future__ import annotations

import argparse
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
                   help="superpose and write XTC (not ported yet)")
    p.add_argument("--fused_block", action="store_true",
                   help="run each trunk layer as three fused CUDA sublayer "
                        "kernels (ops/, csrc/)")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    """Returns one record per sampled batch: {names, frames, seconds, paths}."""
    args = parse_args(argv)
    if args.xtc:
        raise NotImplementedError("--xtc waits for the port of xtc.py (ROADMAP)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to run on the CPU")
    os.makedirs(args.out_dir, exist_ok=True)

    from .data import read_split
    from .geometry import constants as rc
    from .protein import atom14_to_pdb
    from .runtime import MDGenRuntime, checkpoint

    cfg = checkpoint.load_config(args.sim_ckpt)
    if args.fused_block:
        cfg = cfg.replace(fused_block=True)
    model, step = checkpoint.load_model(args.sim_ckpt, cfg, device)
    print(f"restored {args.sim_ckpt} at step {step}")
    rt = MDGenRuntime(cfg, model)

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
            start = torch.from_numpy(np.stack(starts)).to(device)
            seqres_t = torch.from_numpy(seqres).long().to(device)
            mask = torch.ones(seqres.shape, dtype=torch.float32, device=device)

            if device.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            traj = rt.rollout(start, seqres_t, mask, args.num_rollouts, generator=generator)
            traj = traj.cpu().numpy()  # synchronizes
            dur = time.perf_counter() - t0
            frames = len(chunk) * traj.shape[1]
            print(f"{','.join(chunk)}: {frames} frames in {dur:.2f}s "
                  f"({frames / dur:.1f} frames/s)")
            paths = []
            for j, name in enumerate(chunk):
                path = os.path.join(args.out_dir, f"{name}.pdb")
                atom14_to_pdb(traj[j], seqres[j], path)
                paths.append(path)
            records.append({"names": chunk, "frames": frames, "seconds": dur, "paths": paths})
    return records


if __name__ == "__main__":
    main()
