"""Probe: is the val categorical design recovery a DATA ceiling or a MODEL
limitation?

The port of ``scripts/design_ceiling_probe.py``: it establishes the
information ceiling of the synthetic design protocol directly, without any
trained model.

What the design-recipe model sees (``--inpainting --design --no_aa_emb
--no_torsion``):

- the torsion latent channels are zeroed (``no_torsion``);
- ``no_aa_emb`` removes the aatype embedding, so the conditioning residues'
  identities reach the model only through the Dirichlet simplex channels
  being transported, which start at noise at inference for every residue;
- the synthetic generator draws per-torsion basin occupancies and dwell
  times independent of residue identity, so frame dynamics carry no
  generalizing aa signal.

The only aa signal left is memorization: the quality protocol scores val ==
train (8 fixed tetrapeptides), and the conditioning residues' offset
trajectories (x_cond: residues 0 and 3 of every frame, offsets relative to
the window's frame 0) are continuous values unique to each peptide's
trajectory. An oracle that identifies the source peptide from exactly that
information and reads the designed positions off the training sequence
realizes the ceiling.

This measures that oracle: 1-NN matching of a window's conditioning-residue
offset trajectory against all training windows. If it scores about 1.0,
the data ceiling is 1.0 and a lower model recovery is a model/sampling
limitation. Printed for scale: chance (1/20) and the sequence-marginal-only
recovery (per-position argmax over the 8 peptides' designed positions).

    python -m mdgen_tpu_torch.design_ceiling_probe [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np

# the quality-loop protocol's fixed peptides (quality_run.py)
PEPTIDES = ["ACDE", "WYNK", "GSVL", "FHMT", "RQIP", "DKYA", "NEWS", "LCTV"]
COND_IDX = [0, 3]
DESIGN_IDX = [1, 2]


def window_features(trans, rots, starts, T_win, stride):
    """Conditioning-residue offset trajectories for windows at ``starts``.

    Exactly the x_cond information: per-frame rigid offsets relative to the
    window's first frame, restricted to residues COND_IDX, subsampled every
    ``stride`` frames. ``trans`` [T, L, 3] and ``rots`` [T, L, 3, 3] are
    tensors. Returns [N, F] float32 numpy.
    """
    from .geometry import Rigid, get_offsets

    feats = []
    sel = list(COND_IDX)
    for s in starts:
        s = int(s)
        r = Rigid(rots[s: s + T_win, sel], trans[s: s + T_win, sel])
        off = get_offsets(r[0:1], r).cpu().numpy()  # [T, 2, 7]
        feats.append(off[::stride].reshape(-1))
    return np.stack(feats).astype(np.float32)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--md_frames", type=int, default=5000)
    p.add_argument("--num_frames", type=int, default=100,
                   help="window length (the design recipe trains at T=100)")
    p.add_argument("--stride", type=int, default=10,
                   help="frame subsample inside the feature")
    p.add_argument("--n_queries", type=int, default=64,
                   help="random val windows per peptide")
    p.add_argument("--library_stride", type=int, default=7,
                   help="training-window start stride for the 1-NN library "
                        "(deliberately NOT aligned with query starts)")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    import torch

    from .data import write_synthetic_dataset
    from .geometry.constants import str_sequence_to_aatype
    from .runtime import tokenize_atom14

    device = torch.device(args.device)
    rng = np.random.default_rng(args.seed)

    with tempfile.TemporaryDirectory() as d:
        write_synthetic_dataset(d, [(s, s) for s in PEPTIDES], num_frames=args.md_frames,
                                seed=0, rotamers=True)
        toks = {}
        for name in PEPTIDES:
            arr = np.load(os.path.join(d, f"{name}.npy")).astype(np.float32)
            L = arr.shape[1]
            tok = tokenize_atom14({
                "atom14": torch.from_numpy(arr[None]).to(device),
                "seqres": torch.from_numpy(np.asarray(str_sequence_to_aatype(name))[None])
                .long().to(device),
                "mask": torch.ones((1, L), dtype=torch.float32, device=device),
            })
            toks[name] = {"trans": tok["trans"][0], "rots": tok["rots"][0]}

    T_win = args.num_frames
    T_max = args.md_frames - T_win

    # library: all peptides, strided window starts
    lib_feats, lib_pep = [], []
    for pi, name in enumerate(PEPTIDES):
        starts = np.arange(0, T_max, args.library_stride)
        f = window_features(toks[name]["trans"], toks[name]["rots"], starts, T_win, args.stride)
        lib_feats.append(f)
        lib_pep.extend([pi] * len(starts))
    lib_feats = np.concatenate(lib_feats)
    lib_pep = np.asarray(lib_pep)
    print(f"library: {len(lib_pep)} windows, feature dim {lib_feats.shape[1]}")

    # queries: random (unaligned) val windows, like the Loader samples
    aatypes = np.stack([np.asarray(str_sequence_to_aatype(s)) for s in PEPTIDES])
    n_correct_pep = 0
    n_correct_aa, n_total_aa = 0, 0
    for pi, name in enumerate(PEPTIDES):
        starts = rng.integers(0, T_max, size=args.n_queries)
        q = window_features(toks[name]["trans"], toks[name]["rots"], starts, T_win, args.stride)
        # 1-NN in L2 over the cond-residue offset trajectory
        d2 = ((q[:, None] - lib_feats[None]) ** 2).sum(-1)  # [Nq, Nlib]
        nn = lib_pep[np.argmin(d2, axis=1)]
        n_correct_pep += int((nn == pi).sum())
        pred_aa = aatypes[nn][:, DESIGN_IDX]  # [Nq, 2]
        true_aa = aatypes[pi][DESIGN_IDX][None]
        n_correct_aa += int((pred_aa == true_aa).sum())
        n_total_aa += pred_aa.size

    oracle_recovery = n_correct_aa / n_total_aa
    pep_id_acc = n_correct_pep / (len(PEPTIDES) * args.n_queries)

    # analytic: sequence-marginal-only baseline
    marg = 0.0
    for j in DESIGN_IDX:
        vals, counts = np.unique(aatypes[:, j], return_counts=True)
        marg += counts.max() / len(PEPTIDES)
    marg /= len(DESIGN_IDX)

    result = {
        "oracle_designed_recovery": round(oracle_recovery, 4),
        "oracle_peptide_id_accuracy": round(pep_id_acc, 4),
        "marginal_only_recovery": round(marg, 4),
        "chance": 0.05,
        "model_val_categorical (BENCH.md)": 0.70,
        "verdict": (
            "data ceiling ~= oracle; 0.70 is a model/sampling limitation"
            if oracle_recovery > 0.95 else
            "0.70 is near the data ceiling"
        ),
    }
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
