#!/usr/bin/env python3
"""Why `chip_smoke.py` holds each fused rollout to the dense one from the
same start, and not the two chains each from its own start.

    python3 tools/rollout_conditioning.py

Runs the short rollout of `chip_smoke.py`'s model parity phase (its seeded
weights, T=100, 4 Euler steps, 2 rollouts, f32, the same noise) dense and
fused, each chained as `MDGenRuntime.rollout` chains them (rollout 2 starts
from rollout 1's last frame), and prints one JSON line with:

  * the largest error of the fused chain per rollout, and where the largest
    sit (rollout, frame, residue, atom14 index);
  * the start of rollout 2 re-encoded (`tokenize_atom14`) from each chain:
    the largest difference of its atoms and of each residue's seven torsions
    (sin, cos). Residue 0's pre-omega torsion comes from a frame whose two
    padding atoms (the absent previous residue, at the origin) coincide, so
    it is rounding noise; it enters the model as conditioning (x_cond);
  * the chained error with the frame sublayer (kernel 2) replaced by its
    plain twin, bare and with relative noise of 1e-7 and 1e-6 on its output.

Needs a CUDA device and the CUDA toolkit.
"""
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    import chip_smoke as cs
    from mdgen_tpu_torch import ops
    from mdgen_tpu_torch.data import synthetic_trajectory
    from mdgen_tpu_torch.geometry import constants as rc
    from mdgen_tpu_torch.models import LatentMDGenModel
    from mdgen_tpu_torch.ops import _build
    from mdgen_tpu_torch.runtime import MDGenRuntime, tokenize_atom14

    _, _, smi = cs.phase_device(torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    state_dict = cs.seeded_model(torch, cs.bench_config()).state_dict()
    B, T, L = cs.B, cs.T, cs.L
    frame0 = synthetic_trajectory(cs.SEQ, 1, seed=0)[0].astype(np.float32)
    start = torch.from_numpy(frame0)[None].cuda()
    seqres = torch.from_numpy(rc.str_sequence_to_aatype(cs.SEQ)[None]).long().cuda()
    mask = torch.ones(B, L, device="cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(1)  # as phase_model_parity, which draws x with seed 1 first
    noise = torch.randn(2, B, T, L, 21, device="cuda", generator=g.manual_seed(2))
    kernel = ops.fused_t_sublayer

    def chain(fused, frame_sublayer=kernel):
        cfg = cs.bench_config(precision="32-true", fused_block=fused, inference_steps=4)
        model = LatentMDGenModel(cfg, cfg.latent_dim)
        model.load_state_dict(state_dict)
        ops.fused_t_sublayer = frame_sublayer  # the model looks it up at each call
        try:
            return MDGenRuntime(cfg, model.cuda()).rollout(start, seqres, mask, 2, noise=noise)
        finally:
            ops.fused_t_sublayer = kernel

    dense, fused = chain(False), chain(True)
    err = (fused - dense).abs().amax(-1).reshape(B, 2, T, L, 14)
    vals, idx = err.flatten().topk(5)
    res = {"card": smi, "err_per_rollout": err.amax((0, 2, 3, 4)).tolist(),
           "largest": [{"err": v, "at_rollout_frame_residue_atom":
                        [int(i) for i in np.unravel_index(i, tuple(err.shape))[1:]]}
                       for v, i in zip(vals.tolist(), idx.tolist())]}
    enc = [tokenize_atom14({"atom14": traj[:, T - 1][:, None], "seqres": seqres, "mask": mask})
           for traj in (dense, fused)]
    res["rollout2_start_atoms_diff"] = (dense[:, T - 1] - fused[:, T - 1]).abs().max().item()
    res["rollout2_start_torsion_diff_by_residue"] = (
        (enc[0]["torsions"] - enc[1]["torsions"]).abs().amax((0, 1, 4)).tolist())  # [L][7]
    twin = ops.fused_t_sublayer_plain
    res["twin_chained_err"] = {}
    for scale in (0.0, 1e-7, 1e-6):
        gen = torch.Generator(device="cuda").manual_seed(5)

        def noisy(*a, **k):
            y = twin(*a, **k)
            return y * (1 + scale * torch.randn(y.shape, device=y.device, generator=gen))

        res["twin_chained_err"][f"{scale:g}"] = (chain(True, noisy) - dense).abs().max().item()
    print("[rollout_conditioning]", json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
