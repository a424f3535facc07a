"""Quality loop of the port: dataset -> train -> inference -> analysis.

The ``sim``, ``tps`` and ``upsampling`` tasks of the repository's
``scripts/quality_run.py`` on the port: writes the synthetic rotamer MD of 8
tetrapeptides (seed 0: the dataset's seed defines the physical system),
trains a 4AA model on it with ``mdgen_tpu_torch.train`` and scores it. Each
stage is called through its ``main(argv)``, in this process, on
``--device`` (default ``cuda``); training runs as one rank
(``--train_extra='--dp_size N'`` for more).

  * ``--task sim``: ``--sim_condition``; ``--num_rollouts`` rollouts per
    peptide with ``sim_inference --xtc`` (the run's ``sampling_method``,
    dopri5 by default), torsion JSDs by ``analyze_peptide_sim``; prints
    ``per_peptide_mean_torsion_jsd``, ``mean_torsion_jsd``, ``mean_all_jsd``.
  * ``--task tps``: ``--tps_condition``; 2 batches of 8 paths per peptide
    with ``tps_inference --tica_lag 100 --msm_lag 10 --xtc``, scored by
    ``analyze_peptide_tps``; prints each peptide's ``gen_valid_rate`` and
    ``gen_JSD``, their mean and median.
  * ``--task upsampling``: writes ``{name}_i10.npy`` (every 10th MD frame),
    trains ``--sim_condition --cond_interval 10``, fills in the frames with
    ``upsampling_inference --suffix _i10 --xtc``, scores the torsion
    autocorrelations with ``analyze_upsampling --cond_interval 10 --nlag
    100`` and prints ``summarize_upsampling``'s JSON (``live_mean_acf_err``).
  * ``--task design``: the reference design recipe (``--inpainting --design
    --no_aa_emb --no_torsion``); 2 batches of 16 designs per peptide with
    ``design_inference --tica_lag 100 --msm_lag 10 --random_start_idx``,
    scored by ``analyze_peptide_design``; prints the designed, conditioning,
    consensus and mode-pair recoveries (each peptide's and their means) and
    the last validation's argmax recoveries.

    python -m mdgen_tpu_torch.quality_run --epochs 15000 --chi_loss_weight 3 \\
        --train_extra=--ema --seed 0 --out workdir/quality_s0
    python -m mdgen_tpu_torch.quality_run --task upsampling --epochs 8000 \\
        --train_extra=--ema --seed 0 --out workdir/quality_ups_s0

Prints a ``[quality]`` line (ms per train step, drift evaluations per
solve), then the JSON summary.
"""
from __future__ import annotations

import argparse
import importlib
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
                   help="run name under OUT/workdir (default: quality_r2[_TASK])")
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


TASK_FLAGS = {
    "sim": ["--sim_condition"],
    # the reference TPS recipe: endpoint conditioning
    "tps": ["--tps_condition"],
    # the reference upsampling recipe scaled to the synthetic data: every
    # 10th frame given instead of every 100th
    "upsampling": ["--sim_condition", "--cond_interval", "10"],
    # the reference design recipe: inpainting + design, no aatype embedding,
    # no torsions
    "design": ["--inpainting", "--design", "--no_aa_emb", "--no_torsion"],
}


def summarize_tps(out: dict) -> dict:
    """Each peptide's valid-path rate and visited-state JSD, their mean and
    median (the TPS figures of the repository's benchmark notes)."""
    per = {name: {"gen_valid_rate": d["gen_valid_rate"], "gen_JSD": d["gen_JSD"]}
           for name, d in out.items()}
    rates = [v["gen_valid_rate"] for v in per.values()]
    jsds = [v["gen_JSD"] for v in per.values()]
    return {"per_peptide": per,
            "mean_gen_valid_rate": statistics.mean(rates) if rates else None,
            "median_gen_JSD": statistics.median(jsds) if jsds else None}


def main(argv=None, keep_trajectories: bool = False) -> dict:
    """Returns {"summary" (the printed JSON), "train" (train.main's record or
    None), "ms_per_step", "samples" (the inference CLI's records, with the
    trajectories if ``keep_trajectories``), "analysis" ({name:
    metrics}), "samp_dir", "data_dir", "run_dir"}."""
    args = parse_args(argv)
    from . import train
    from .runtime.checkpoint import latest_step

    data_dir = os.path.join(args.out, "data")
    samp_dir = os.path.join(args.out, "samples")
    workdir = os.path.join(args.out, "workdir")
    os.makedirs(samp_dir, exist_ok=True)
    run_name = args.run_name or f"quality_r2_{args.task}".replace("_sim", "")
    run_dir = os.path.join(workdir, run_name)

    # 1. synthetic MD dataset (the reference side of every metric)
    split = os.path.join(data_dir, "split.csv")
    if args.skip_data and os.path.exists(split):
        print("reusing the dataset in", data_dir, flush=True)
    else:
        split = write_dataset(args, data_dir)
    if args.task == "upsampling":
        import numpy as np

        # the kept (low-framerate) trajectories the upsampler fills in
        for s in PEPTIDES:
            arr = np.load(os.path.join(data_dir, f"{s}.npy"))
            np.save(os.path.join(data_dir, f"{s}_i10.npy"), arr[::10])

    # 2. train
    rec, ms_per_step = None, None
    if not args.skip_train:
        resume = []
        if args.resume and latest_step(run_dir) is not None:
            resume = ["--ckpt", run_dir]
            print("resuming from", run_dir, flush=True)
        argv_train = [
            *TASK_FLAGS[args.task], "--prepend_ipa", "--abs_pos_emb", "--abs_time_emb",
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
            "--dp_size", "1", *resume, *shlex.split(args.train_extra),
        ]
        print("+ train", " ".join(argv_train), flush=True)
        rec = train.main(argv_train)
        gaps = [b - a for a, b in zip(rec["step_end"], rec["step_end"][1:])]
        ms_per_step = statistics.median(gaps) * 1e3 if gaps else None

    # 3. sample and 4. analyse
    sample = importlib.import_module(f".{SAMPLE_CLI[args.task]}", __package__)
    argv = sample_argv(args, run_dir, data_dir, samp_dir, split)
    print("+", SAMPLE_CLI[args.task], " ".join(argv), flush=True)
    samples = sample.main(argv, keep_trajectories=keep_trajectories)
    analyze = importlib.import_module(f".{ANALYSIS_CLI[args.task]}", __package__)
    argv = analyze_argv(args, data_dir, samp_dir, split)
    print("+", ANALYSIS_CLI[args.task], " ".join(argv), flush=True)
    analysis = analyze.main(argv)
    summary = summarize_task(args.task, analysis, samp_dir)
    if args.task == "design" and rec and rec["val"]:
        summary["val_recovery"] = {k[4:]: v for k, v in rec["val"][-1].items()
                                   if k.endswith("aa_recovery")}

    solves = [s for r in samples for s in r["solves"]]
    seconds = sum(r["seconds"] for r in samples)
    steps = f"{len(rec['losses'])} train steps, median {ms_per_step:.2f} ms per train step" \
        if ms_per_step is not None else "training skipped"
    print(f"[quality] {args.task}: {steps}; sampling {_sampled(args.task, samples)} in "
          f"{seconds:.1f} s, {statistics.mean(s['evals'] for s in solves):.1f} drift "
          f"evaluations per solve ({sum(not s['reached_t1'] for s in solves)} of {len(solves)} "
          "solves short of t1)", flush=True)
    print(json.dumps(summary))
    print("QUALITY RUN OK", flush=True)
    return {"summary": summary, "train": rec, "ms_per_step": ms_per_step, "samples": samples,
            "analysis": analysis, "samp_dir": samp_dir, "data_dir": data_dir, "run_dir": run_dir}


def _sampled(task, samples) -> str:
    if task in ("tps", "design"):
        what = "paths" if task == "tps" else "designs"
        return f"{sum(len(r['paths']) for r in samples)} {what}"
    return f"{sum(r['frames'] for r in samples)} frames"


def write_dataset(args, data_dir) -> str:
    """The synthetic MD of PEPTIDES (seed 0) in ``data_dir``; returns the
    split CSV."""
    from .data import write_synthetic_dataset

    return write_synthetic_dataset(data_dir, [(s, s) for s in PEPTIDES],
                                   num_frames=args.md_frames, seed=0,
                                   rotamers=not args.rigid_data)


# each task's inference and analysis CLIs (modules of this package)
SAMPLE_CLI = {"sim": "sim_inference", "tps": "tps_inference",
              "upsampling": "upsampling_inference", "design": "design_inference"}
ANALYSIS_CLI = {"sim": "analyze_peptide_sim", "tps": "analyze_peptide_tps",
                "upsampling": "analyze_upsampling", "design": "analyze_peptide_design"}


def sample_argv(args, run_dir, data_dir, samp_dir, split) -> list:
    """The flags of the task's inference CLI (SAMPLE_CLI): ``args.seed`` and
    ``args.device`` sample the run in ``run_dir`` into ``samp_dir``."""
    task = {
        "sim": ["--sim_ckpt", run_dir, "--num_rollouts", str(args.num_rollouts)],
        "tps": ["--sim_ckpt", run_dir, "--num_batches", "2", "--batch_size", "8", "--tica_lag",
                "100", "--msm_lag", "10"],
        "upsampling": ["--ckpt", run_dir, "--suffix", "_i10"],
        "design": ["--sim_ckpt", run_dir, "--num_frames", str(args.num_frames), "--num_batches",
                   "2", "--batch_size", "16", "--tica_lag", "100", "--msm_lag", "10",
                   "--random_start_idx"],
    }[args.task]
    return [*task, "--data_dir", data_dir, "--split", split, "--out_dir", samp_dir,
            *(["--xtc"] if args.task != "design" else []), "--seed", str(args.seed),
            "--device", args.device]


def analyze_argv(args, data_dir, samp_dir, split) -> list:
    """The flags of the task's analysis CLI (ANALYSIS_CLI) on ``samp_dir``."""
    task = {
        "sim": ["--mddir", data_dir, "--pdbdir", samp_dir, "--save", "--no_msm", "--no_decorr",
                "--tica_lag", "100", "--save_name", "out.pkl", "--split", split],
        "tps": ["--mddir", data_dir, "--pdbdir", samp_dir, "--save"],
        "upsampling": ["--mddir", data_dir, "--pdbdir", samp_dir, "--cond_interval", "10",
                       "--nlag", "100", "--save"],
        "design": ["--pdbdir", samp_dir],
    }[args.task]
    return [*task, *shlex.split(args.analyze_extra)]


def summarize_task(task, analysis, samp_dir) -> dict:
    """The printed summary of the analysis CLI's result."""
    if task == "sim":
        return summarize(analysis)
    if task == "tps":
        return summarize_tps(analysis)
    if task == "upsampling":
        from . import summarize_upsampling

        return summarize_upsampling.summarize(os.path.join(samp_dir, "upsampling_out.pkl"))
    summary = {k: round(v, 4) for k, v in analysis.items() if k != "per_peptide"}
    summary["per_peptide"] = {name: {k: round(v, 4) for k, v in r.items()}
                              for name, r in analysis["per_peptide"].items()}
    return summary


if __name__ == "__main__":
    main()
