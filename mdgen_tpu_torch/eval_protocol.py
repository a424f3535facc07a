"""The tight sim-quality evaluation protocol: a checkpoint's torsion JSDs
beside the same-system sampling-noise floor.

    python -m mdgen_tpu_torch.eval_protocol --ckpt workdir/quality_s0/workdir/quality_r2 \\
        --train_data workdir/quality_s0/data --out workdir/eval_s0 [--fused_block]

The port's counterpart of ``scripts/eval_protocol.py``: the same four
stages, each through the port's ``main(argv)`` in this process:
  1. an independent ``--eval_frames`` trajectory per peptide, resampled from
     the SAME physical systems the default-mode training set was drawn from
     (``path_seed`` + ``replay_frames``, ``data/synthetic.py``), in OUT/data;
  2. ``--num_rollouts`` chained rollouts per peptide from the checkpoint
     with ``sim_inference --xtc`` on ``--device`` (starts from the training
     data, the distribution the model conditions on); prints the frames,
     seconds, drift evaluations per solve and kernel launches;
  3. ``analyze_peptide_sim`` JSDs of the samples against the eval trajectory
     (``OUT/samples/out_eval.pkl``);
  4. the matched single-path noise floor (``noise_floor``, n_gen =
     num_rollouts x 100 frames, in OUT/floor),
then prints the model-vs-floor JSON table per torsion type and ``EVAL
PROTOCOL OK``.
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import statistics

import numpy as np

PEPTIDES = ["ACDE", "WYNK", "GSVL", "FHMT", "RQIP", "DKYA", "NEWS", "LCTV"]


def summarize(pkl_path):
    with open(pkl_path, "rb") as fh:
        out = pickle.load(fh)
    per_type, tors = {}, []
    for d in out.values():
        for k, v in d["JSD"].items():
            typ = k.split()[0] if "|" not in k else "RAMA"
            per_type.setdefault(typ, []).append(v)
            if "|" not in k and not k.startswith("TICA"):
                tors.append(v)
    return (
        {t: float(np.mean(v)) for t, v in per_type.items()},
        float(np.mean(tors)),
    )


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", type=str, required=True)
    p.add_argument("--train_data", type=str, required=True,
                   help="the default-mode dataset dir the model trained on")
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--train_frames", type=int, default=5000,
                   help="num_frames of the training dataset (replay key)")
    p.add_argument("--eval_frames", type=int, default=20000)
    p.add_argument("--num_rollouts", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--skip_sample", action="store_true",
                   help="reuse existing samples in {out}/samples")
    p.add_argument("--fused_block", action="store_true",
                   help="sample with the fused CUDA sublayer kernels")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Returns {"table": the printed JSON, "samples": sim_inference's records
    (empty with ``--skip_sample``), "launches": the kernel launches of the
    sampling stage}."""
    args = parse_args(argv)
    from . import analyze_peptide_sim, noise_floor, sim_inference
    from .data import write_synthetic_dataset
    from .ops import launch_counts

    data_dir = os.path.join(args.out, "data")
    samp_dir = os.path.join(args.out, "samples")
    if not os.path.exists(os.path.join(data_dir, "split.csv")):
        write_synthetic_dataset(data_dir, [(s, s) for s in PEPTIDES],
                                num_frames=args.eval_frames, seed=args.seed, rotamers=True,
                                path_seed=500, replay_frames=args.train_frames)
    split = os.path.join(data_dir, "split.csv")

    samples, launches = [], {}
    if not args.skip_sample:
        argv_s = ["--sim_ckpt", args.ckpt, "--data_dir", args.train_data,
                  "--split", os.path.join(args.train_data, "split.csv"),
                  "--num_rollouts", str(args.num_rollouts), "--out_dir", samp_dir, "--xtc",
                  "--device", args.device, *(["--fused_block"] if args.fused_block else [])]
        print("+ sim_inference", " ".join(argv_s), flush=True)
        before = launch_counts()
        samples = sim_inference.main(argv_s)
        launches = {k: v - before[k] for k, v in launch_counts().items()}
        solves = [s for r in samples for s in r["solves"]]
        print(f"[eval-protocol] sampled {sum(r['frames'] for r in samples)} frames in "
              f"{sum(r['seconds'] for r in samples):.2f} s, "
              f"{statistics.mean(s['evals'] for s in solves):.1f} drift evaluations per solve "
              f"({len(solves)} solves, {sum(s['evals'] for s in solves)} in all); kernel "
              f"launches {json.dumps(launches)}", flush=True)

    argv_a = ["--mddir", data_dir, "--pdbdir", samp_dir, "--save", "--no_msm", "--no_decorr",
              "--tica_lag", "100", "--save_name", "out_eval.pkl", "--split", split]
    print("+ analyze_peptide_sim", " ".join(argv_a), flush=True)
    analyze_peptide_sim.main(argv_a)

    floor_dir = os.path.join(args.out, "floor")
    if not os.path.exists(os.path.join(floor_dir, "samples", "floor.pkl")):
        argv_f = ["--mddir", data_dir, "--out", floor_dir, "--n_gen",
                  str(args.num_rollouts * 100), "--n_paths", "1", "--replay_frames",
                  str(args.train_frames), "--seed", str(args.seed)]
        print("+ noise_floor", " ".join(argv_f), flush=True)
        noise_floor.main(argv_f)

    model_types, model_tors = summarize(os.path.join(samp_dir, "out_eval.pkl"))
    floor_types, floor_tors = summarize(os.path.join(floor_dir, "samples", "floor.pkl"))
    table = {
        t: {
            "model": round(model_types[t], 4),
            "floor": round(floor_types.get(t, float("nan")), 4),
            "ratio": round(model_types[t] / floor_types[t], 2)
            if floor_types.get(t) else None,
        }
        for t in sorted(model_types)
    }
    table = {
        "mean_torsion_jsd": round(model_tors, 4),
        "floor_torsion_jsd": round(floor_tors, 4),
        "ratio": round(model_tors / floor_tors, 3),
        "per_type": table,
    }
    print(json.dumps(table, indent=2))
    print("EVAL PROTOCOL OK", flush=True)
    return {"table": table, "samples": samples, "launches": launches}


if __name__ == "__main__":
    main()
