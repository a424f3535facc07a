"""Quality loop of the port: dataset -> train -> sim_inference -> analysis.

The ``--task sim`` path of the repository's ``scripts/quality_run.py`` on the
port: writes the synthetic rotamer MD of 8 tetrapeptides (seed 0: the
dataset's seed defines the physical system), trains a 4AA model on it with
``mdgen_tpu_torch.train``, samples ``--num_rollouts`` rollouts per peptide
with ``mdgen_tpu_torch.sim_inference --xtc`` (the run's ``sampling_method``,
dopri5 by default) and scores the torsion JSDs with
``mdgen_tpu_torch.analyze_peptide_sim``. Each stage is called through its
``main(argv)``, in this process, on ``--device`` (default ``cuda``).

    python -m mdgen_tpu_torch.quality_run --epochs 15000 --chi_loss_weight 3 \\
        --train_extra=--ema --seed 0 --out workdir/quality_s0

Prints a ``[quality]`` line (ms per train step, drift evaluations per
solve), then the JSON of the original script: ``per_peptide_mean_torsion_jsd``,
``mean_torsion_jsd``, ``mean_all_jsd``. The other tasks are not ported.
"""
from __future__ import annotations

import argparse
import json
import os
import shlex
import statistics

# 8 tetrapeptides with diverse sidechain chemistry (the synthetic generator
# draws each peptide's torsion basins from its own seed)
PEPTIDES = ["ACDE", "WYNK", "GSVL", "FHMT", "RQIP", "DKYA", "NEWS", "LCTV"]


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--task", type=str, default="sim",
                   choices=["sim", "design", "tps", "upsampling"])
    p.add_argument("--run_name", type=str, default=None,
                   help="run name under OUT/workdir (default: quality_r2)")
    p.add_argument("--out", type=str, default="workdir/quality_torch")
    p.add_argument("--epochs", type=int, default=6000)
    p.add_argument("--num_frames", type=int, default=100)
    p.add_argument("--md_frames", type=int, default=5000)
    p.add_argument("--num_rollouts", type=int, default=10)
    p.add_argument("--embed_dim", type=int, default=128)
    p.add_argument("--num_layers", type=int, default=3)
    p.add_argument("--mha_heads", type=int, default=8)
    p.add_argument("--ipa_heads", type=int, default=2)
    p.add_argument("--ipa_head_dim", type=int, default=16)
    p.add_argument("--ipa_qk", type=int, default=4)
    p.add_argument("--ipa_v", type=int, default=4)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--lr", type=float, default=4e-4)
    p.add_argument("--chi_loss_weight", type=float, default=1.0,
                   help="upweight sidechain chi sin/cos loss channels")
    p.add_argument("--chi_loss_weights", type=str, default=None,
                   help="per-chi weights 'w1,w2,w3,w4' (composes with --chi_loss_weight)")
    p.add_argument("--rigid_data", action="store_true",
                   help="rigid-sidechain synthetic data instead of rotamer dynamics")
    p.add_argument("--train_extra", type=str, default="",
                   help="extra flags of the train invocation, e.g. --train_extra=--ema")
    p.add_argument("--analyze_extra", type=str, default="",
                   help="extra flags of the analysis invocation")
    p.add_argument("--skip_train", action="store_true",
                   help="reuse an existing run in OUT/workdir")
    p.add_argument("--resume", action="store_true",
                   help="resume the run's newest step_* checkpoint")
    p.add_argument("--skip_data", action="store_true",
                   help="reuse a dataset already in OUT/data")
    p.add_argument("--seed", type=int, default=137,
                   help="seed of training and sampling (the dataset keeps seed 0)")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def summarize(out: dict) -> dict:
    """The original script's JSON from the analysis' {name: metrics}."""
    tors, alls = {}, {}
    for name, d in out.items():
        jsd = d.get("JSD", {})
        t = [v for k, v in jsd.items() if "|" not in k and not k.startswith("TICA")]
        if t:
            tors[name] = sum(t) / len(t)
        if jsd:
            alls[name] = sum(jsd.values()) / len(jsd)
    return {
        "per_peptide_mean_torsion_jsd": {k: round(v, 4) for k, v in tors.items()},
        "mean_torsion_jsd": round(sum(tors.values()) / max(len(tors), 1), 4),
        "mean_all_jsd": round(sum(alls.values()) / max(len(alls), 1), 4),
    }


def main(argv=None, keep_trajectories: bool = False) -> dict:
    """Returns {"summary" (the printed JSON), "train" (train.main's record or
    None), "ms_per_step", "samples" (sim_inference.main's records, with the
    trajectories if ``keep_trajectories``), "analysis" ({name: metrics}),
    "samp_dir", "data_dir", "run_dir"}."""
    args = parse_args(argv)
    if args.task != "sim":
        raise NotImplementedError(f"--task {args.task} is not ported (ROADMAP queue 1, "
                                  "items 8-10)")
    from . import analyze_peptide_sim, sim_inference, train
    from .data import write_synthetic_dataset
    from .runtime.checkpoint import latest_step

    data_dir = os.path.join(args.out, "data")
    samp_dir = os.path.join(args.out, "samples")
    workdir = os.path.join(args.out, "workdir")
    os.makedirs(samp_dir, exist_ok=True)
    run_name = args.run_name or "quality_r2"
    run_dir = os.path.join(workdir, run_name)

    # 1. synthetic MD dataset (the reference side of the JSD)
    split = os.path.join(data_dir, "split.csv")
    if args.skip_data and os.path.exists(split):
        print("reusing the dataset in", data_dir, flush=True)
    else:
        split = write_synthetic_dataset(data_dir, [(s, s) for s in PEPTIDES],
                                        num_frames=args.md_frames, seed=0,
                                        rotamers=not args.rigid_data)

    # 2. train
    rec, ms_per_step = None, None
    if not args.skip_train:
        resume = []
        if args.resume and latest_step(run_dir) is not None:
            resume = ["--ckpt", run_dir]
            print("resuming from", run_dir, flush=True)
        argv_train = [
            "--sim_condition", "--prepend_ipa", "--abs_pos_emb", "--abs_time_emb",
            "--crop", "4", "--num_frames", str(args.num_frames),
            "--num_layers", str(args.num_layers), "--embed_dim", str(args.embed_dim),
            "--mha_heads", str(args.mha_heads), "--ipa_heads", str(args.ipa_heads),
            "--ipa_head_dim", str(args.ipa_head_dim), "--ipa_qk", str(args.ipa_qk),
            "--ipa_v", str(args.ipa_v), "--batch_size", str(args.batch_size),
            "--lr", str(args.lr), "--chi_loss_weight", str(args.chi_loss_weight),
            *(["--chi_loss_weights", args.chi_loss_weights] if args.chi_loss_weights else []),
            "--epochs", str(args.epochs), "--data_dir", data_dir, "--train_split", split,
            "--val_split", split, "--val_epoch_freq", "500", "--val_batches", "1",
            "--ckpt_freq", "1000", "--print_freq", "200", "--workdir", workdir,
            "--run_name", run_name, "--seed", str(args.seed), "--device", args.device,
            *resume, *shlex.split(args.train_extra),
        ]
        print("+ train", " ".join(argv_train), flush=True)
        rec = train.main(argv_train)
        gaps = [b - a for a, b in zip(rec["step_end"], rec["step_end"][1:])]
        ms_per_step = statistics.median(gaps) * 1e3 if gaps else None

    # 3. sample rollouts (T frames x num_rollouts per peptide)
    argv_sample = ["--sim_ckpt", run_dir, "--data_dir", data_dir, "--split", split,
                   "--num_rollouts", str(args.num_rollouts), "--out_dir", samp_dir, "--xtc",
                   "--seed", str(args.seed), "--device", args.device]
    print("+ sim_inference", " ".join(argv_sample), flush=True)
    samples = sim_inference.main(argv_sample, keep_trajectories=keep_trajectories)

    # 4. analyse (scipy-exact JSDs)
    argv_analyze = ["--mddir", data_dir, "--pdbdir", samp_dir, "--save", "--no_msm",
                    "--no_decorr", "--tica_lag", "100", "--save_name", "out.pkl",
                    "--split", split, *shlex.split(args.analyze_extra)]
    print("+ analyze_peptide_sim", " ".join(argv_analyze), flush=True)
    analysis = analyze_peptide_sim.main(argv_analyze)

    solves = [s for r in samples for s in r["solves"]]
    frames = sum(r["frames"] for r in samples)
    seconds = sum(r["seconds"] for r in samples)
    steps = f"{len(rec['losses'])} train steps, median {ms_per_step:.2f} ms per step" \
        if ms_per_step is not None else "training skipped"
    print(f"[quality] {steps}; sampling {frames} frames in {seconds:.1f} s, "
          f"{statistics.mean(s['evals'] for s in solves):.1f} drift evaluations per solve "
          f"({sum(not s['reached_t1'] for s in solves)} of {len(solves)} solves short of t1)",
          flush=True)
    summary = summarize(analysis)
    print(json.dumps(summary))
    print("QUALITY RUN OK", flush=True)
    return {"summary": summary, "train": rec, "ms_per_step": ms_per_step, "samples": samples,
            "analysis": analysis, "samp_dir": samp_dir, "data_dir": data_dir, "run_dir": run_dir}


if __name__ == "__main__":
    main()
