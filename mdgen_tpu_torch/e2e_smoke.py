"""End-to-end smoke: synthetic data -> train -> checkpoint -> rollout -> PDB
-> analysis.

The port of ``scripts/e2e_smoke.py``: every layer of the port in one run,
with a compact summary. Writes a synthetic dataset of three tetrapeptides,
trains a small 4AA forward-simulation model (``--steps`` steps of batch
``--batch_size``, EMA) and checks that a fixed-draw loss fell, saves a
checkpoint and loads it back, rolls the EMA model out 3 times from the
first frame of ACDE, writes the PDB, reads it back and prints the torsion
JSDs of the rollout against the training trajectory.

    python -m mdgen_tpu_torch.e2e_smoke --steps 200 --out workdir/e2e_smoke
    python -m mdgen_tpu_torch.e2e_smoke --cpu --steps 20 --num_frames 8 \\
        --num_layers 2 --embed_dim 32 --mha_heads 4
"""
from __future__ import annotations

import argparse
import os
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--out", type=str, default="workdir/e2e_smoke")
    p.add_argument("--num_frames", type=int, default=32)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--num_layers", type=int, default=3)
    p.add_argument("--embed_dim", type=int, default=128)
    p.add_argument("--mha_heads", type=int, default=8)
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Returns {"loss0", "loss1", "steps_per_s", "frames_per_s", "jsds",
    "pdb"}."""
    args = parse_args(argv)
    import numpy as np
    import torch

    from .analysis import featurize_torsions, hist_jsd
    from .config import MDGenConfig
    from .data import Loader, MDGenDataset, write_synthetic_dataset
    from .geometry import constants as rc
    from .protein import atom14_to_pdb, load_pdb_trajectory
    from .runtime import MDGenRuntime, TrainRuntime, batch_to_device, checkpoint

    device = torch.device("cpu" if args.cpu else args.device)
    os.makedirs(args.out, exist_ok=True)
    print("device:", device, torch.cuda.get_device_name(device) if device.type == "cuda" else "")

    # 1. synthetic dataset
    seqs = [("AAAA", "AAAA"), ("ACDE", "ACDE"), ("WYNK", "WYNK")]
    data_dir = os.path.join(args.out, "data")
    split = write_synthetic_dataset(data_dir, seqs, num_frames=600, seed=0)
    print("wrote synthetic dataset:", split)

    cfg = MDGenConfig(
        sim_condition=True, prepend_ipa=True, abs_pos_emb=True, abs_time_emb=True, crop=4,
        num_frames=args.num_frames, num_layers=args.num_layers, embed_dim=args.embed_dim,
        mha_heads=args.mha_heads, ipa_heads=2, ipa_head_dim=16, ipa_qk=4, ipa_v=4,
        batch_size=args.batch_size, lr=3e-4, ema=True, sampling_method="euler",
        inference_steps=50, overfit=True,
    )

    rt = TrainRuntime(cfg, device)
    ds = MDGenDataset(cfg, split, data_dir, repeat=64, seed=0)
    loader = Loader(ds, cfg.batch_size, shuffle=True, seed=0)

    batch0 = next(iter(loader))
    batch0.pop("name")
    batch0 = batch_to_device(batch0, device)
    state = rt.init(torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in state.model.parameters())
    print(f"params: {n_params:,}")

    # 2. train
    def fixed_loss():  # the same t and noise draws every time
        g = torch.Generator(device).manual_seed(999)
        return float(rt.val_step(state.model, batch0, g)["loss"])

    loss0 = fixed_loss()
    gen = torch.Generator(device).manual_seed(1)
    t0 = time.time()
    step = 0
    while step < args.steps:
        for batch in loader:
            batch.pop("name")
            state, metrics = rt.train_step(state, batch_to_device(batch, device), gen)
            step += 1
            if step >= args.steps:
                break
    float(metrics["loss"])  # synchronizes
    train_s = time.time() - t0
    loss1 = fixed_loss()
    print(f"trained {args.steps} steps in {train_s:.1f}s ({args.steps / train_s:.2f} steps/s); "
          f"fixed-draw loss {loss0:.4f} -> {loss1:.4f}")
    assert loss1 < loss0, "training did not reduce the loss"

    # 3. checkpoint round trip
    ck = checkpoint.save_checkpoint(
        os.path.join(args.out, "ckpt"), cfg,
        {k: v.cpu() for k, v in state.model.state_dict().items()}, state.step,
        {k: v.cpu() for k, v in rt.eval_params(state).state_dict().items()})
    print("checkpoint:", ck)
    model, _ = checkpoint.load_model(os.path.dirname(ck), device=device)  # the EMA weights

    # 4. rollout + PDB
    name, seq = seqs[1]
    arr = np.load(os.path.join(data_dir, f"{name}.npy"))
    start = torch.from_numpy(np.asarray(arr[:1], np.float32)).to(device)
    seqres = rc.str_sequence_to_aatype(seq)[None]
    mask = torch.ones(seqres.shape, dtype=torch.float32, device=device)
    sampler = MDGenRuntime(cfg, model)
    t0 = time.time()
    traj = sampler.rollout(start, torch.from_numpy(seqres).long().to(device), mask, 3,
                           generator=torch.Generator(device).manual_seed(7))
    traj = traj.cpu().numpy()  # synchronizes
    dur = time.time() - t0
    fps = traj.shape[1] / dur
    print(f"rollout: {traj.shape[1]} frames in {dur:.1f}s ({fps:.1f} frames/s)")
    assert np.isfinite(traj).all()

    pdb_path = os.path.join(args.out, f"{name}.pdb")
    atom14_to_pdb(traj[0], seqres[0], pdb_path)

    # 5. analysis: JSD of torsion marginals generated vs training data
    gen_atom14, aatype = load_pdb_trajectory(pdb_path)
    gen_feats = featurize_torsions(gen_atom14, aatype, sidechains=True, cossin=False)
    ref_feats = featurize_torsions(np.asarray(arr, np.float32), seqres[0], sidechains=True,
                                   cossin=False)
    jsds = [hist_jsd(ref_feats[:, i], gen_feats[:, i], bins=30)
            for i in range(ref_feats.shape[1])]
    print(f"torsion JSDs: mean {np.mean(jsds):.4f} max {np.max(jsds):.4f}")
    print("E2E SMOKE OK")
    return {"loss0": loss0, "loss1": loss1, "steps_per_s": args.steps / train_s,
            "frames_per_s": fps, "jsds": jsds, "pdb": pdb_path}


if __name__ == "__main__":
    main()
