"""The 34M quality acceptances of the TPS and design tasks, on the card.

Runs ``python -m mdgen_tpu_torch.quality_run --task tps|design`` at the
34M recipe (5 x 384 x 16 heads, IPA 4 heads of 32, qk 8, v 8: 34.2M
parameters for TPS, 34.6M for design; ``--ema``; TPS: ``--chi_loss_weight
3``; design: lr 2e-4) for seeds 0 and 1, side by side as
processes on the one card, each for ``--epochs`` train steps (the recipe's
30000 by default; the learning rate is constant, so fewer steps are the
recipe cut short, the same for both seeds); then samples the first seed's
checkpoint again
through the fused kernels (``tps_inference --fused_block`` /
``design_inference --fused_block``, the quality run's own flags, seed and
MSMs; its kernel launches recorded) and scores it the same way; for
design, also runs
``design_temp_sweep`` on that checkpoint at SWEEP_TEMPS. Writes
``OUT/acceptance_{task}.json`` (each seed's summary and train steps,
the seeds' mean and spread, the fused resample's summary, the sweep's
table) and copies the small artifacts (``persist_results.KEEP_EXT``, at
most ``MAX_BYTES`` a file) into ``--keep``.

    python -m mdgen_tpu_torch.acceptance --task tps --epochs 8500 \\
        --out build/acc_tps --keep workdir/acc_tps_small
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import shlex
import shutil
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH = ["--num_layers", "5", "--embed_dim", "384", "--mha_heads", "16", "--ipa_heads", "4",
         "--ipa_head_dim", "32", "--ipa_qk", "8", "--ipa_v", "8"]
TASK_FLAGS = {"tps": ["--chi_loss_weight", "3"], "design": ["--lr", "2e-4"]}
SEEDS = (0, 1)
# the Dirichlet-flow temperatures of the design sweep
SWEEP_TEMPS = "1.0,0.5,0.2,0.1"
# the figures averaged over the seeds
HEADLINE = {"tps": ("mean_gen_valid_rate", "median_gen_JSD"),
            "design": ("designed", "cond", "consensus", "mode_pair")}


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--task", choices=["tps", "design"], required=True)
    p.add_argument("--epochs", type=int, default=30000)
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--keep", type=str, default=None,
                   help="copy the small artifacts here")
    p.add_argument("--quality_extra", type=str, default="",
                   help="extra flags of each quality_run (e.g. a smaller width on the CPU)")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def _run(cmd, log_path):
    print("+", " ".join(cmd), ">", log_path, flush=True)
    with open(log_path, "w") as fh:
        return subprocess.Popen(cmd, cwd=REPO, stdout=fh, stderr=subprocess.STDOUT)


def _wait(procs):
    for name, proc in procs:
        if proc.wait() != 0:
            raise RuntimeError(f"{name} failed ({proc.returncode}); see its log")


def _summary(log_path):
    """The JSON line quality_run prints before QUALITY RUN OK, and its
    [quality] line."""
    lines = open(log_path).read().splitlines()
    end = lines.index("QUALITY RUN OK")
    quality = next(line for line in lines if line.startswith("[quality]"))
    return json.loads(lines[end - 1]), quality


def main(argv=None) -> dict:
    args = parse_args(argv)
    from .quality_run import summarize_tps

    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    seeds = list(SEEDS)
    py = sys.executable
    t0 = time.perf_counter()

    # 1. the quality runs, side by side
    procs = []
    for s in seeds:
        cmd = [py, "-m", "mdgen_tpu_torch.quality_run", "--task", args.task, "--out",
               os.path.join(out, f"s{s}"), "--epochs", str(args.epochs), *WIDTH,
               *TASK_FLAGS[args.task], "--seed", str(s), "--device", args.device,
               "--train_extra=--ema", *shlex.split(args.quality_extra)]
        procs.append((f"quality_run seed {s}", _run(cmd, os.path.join(out, f"s{s}.log"))))
    _wait(procs)
    runs = {}
    for s in seeds:
        summary, quality = _summary(os.path.join(out, f"s{s}.log"))
        runs[s] = {"summary": summary, "quality_line": quality}
        print(f"seed {s}: {quality}\n{json.dumps(summary)}", flush=True)
    train_s = time.perf_counter() - t0

    # 2. the first seed's checkpoint again, through the fused kernels
    s0 = os.path.join(out, f"s{seeds[0]}")
    run_dir = glob.glob(os.path.join(s0, "workdir", "*"))[0]
    fused = os.path.join(out, f"s{seeds[0]}_fused")
    os.makedirs(fused, exist_ok=True)
    for pkl in glob.glob(os.path.join(s0, "samples", "*_metadata.pkl")):
        shutil.copy(pkl, fused)  # the MSMs the quality run built
    data, split = os.path.join(s0, "data"), os.path.join(s0, "data", "split.csv")
    common = ["--sim_ckpt", run_dir, "--data_dir", data, "--split", split, "--out_dir", fused,
              "--seed", str(seeds[0]), "--device", args.device, "--fused_block",
              "--record", fused + "_record.json"]
    if args.task == "tps":
        cmd = [py, "-m", "mdgen_tpu_torch.tps_inference", *common, "--num_batches", "2",
               "--batch_size", "8", "--tica_lag", "100", "--msm_lag", "10", "--xtc"]
        analyze = [py, "-m", "mdgen_tpu_torch.analyze_peptide_tps", "--mddir", data, "--pdbdir",
                   fused, "--save"]
    else:
        cmd = [py, "-m", "mdgen_tpu_torch.design_inference", *common, "--num_frames", "100",
               "--num_batches", "2", "--batch_size", "16", "--tica_lag", "100", "--msm_lag", "10",
               "--random_start_idx"]
        analyze = [py, "-m", "mdgen_tpu_torch.analyze_peptide_design", "--pdbdir", fused]
    _wait([("fused sampling", _run(cmd, fused + ".log"))])
    _wait([("fused analysis", _run(analyze, fused + "_analysis.log"))])
    if args.task == "tps":
        import pickle

        with open(os.path.join(fused, "tps_out.pkl"), "rb") as fh:
            fused_summary = summarize_tps(pickle.load(fh))
    else:
        from .design_temp_sweep import overall_metrics

        fused_summary = overall_metrics(open(fused + "_analysis.log").read())
    with open(fused + "_record.json") as fh:
        fused_launches = json.load(fh)["launches"]

    # 3. design: the temperature sweep on the same checkpoint and MSMs
    sweep = None
    if args.task == "design":
        sweep_dir = os.path.join(out, "sweep")
        first = os.path.join(sweep_dir, f"temp_{float(SWEEP_TEMPS.split(',')[0]):g}")
        os.makedirs(first, exist_ok=True)
        for pkl in glob.glob(os.path.join(s0, "samples", "*_metadata.pkl")):
            shutil.copy(pkl, first)
        cmd = [py, "-m", "mdgen_tpu_torch.design_temp_sweep", "--ckpt", run_dir, "--out",
               sweep_dir, "--temps", SWEEP_TEMPS, "--data_dir", data, "--device", args.device]
        _wait([("temperature sweep", _run(cmd, sweep_dir + ".log"))])
        with open(os.path.join(sweep_dir, "temp_sweep.json")) as fh:
            sweep = json.load(fh)

    keys = HEADLINE[args.task]
    vals = {k: [runs[s]["summary"][k] for s in seeds] for k in keys}
    result = {
        "task": args.task, "seeds": seeds, "epochs": args.epochs, "runs": runs,
        "mean": {k: statistics.mean(v) for k, v in vals.items()},
        "spread": {k: max(v) - min(v) for k, v in vals.items()},
        "fused_seed": seeds[0], "fused": fused_summary, "fused_launches": fused_launches,
        "sweep": sweep,
        "seconds": {"quality_runs": train_s, "all": time.perf_counter() - t0},
    }
    with open(os.path.join(out, f"acceptance_{args.task}.json"), "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps(result), flush=True)
    if args.keep:
        _keep(out, os.path.abspath(args.keep))
    return result


def _keep(out, keep):
    """The small artifacts: each directory's KEEP_EXT files up to MAX_BYTES,
    and the logs."""
    from .persist_results import KEEP_EXT, MAX_BYTES

    for root, _, files in os.walk(out):
        if os.sep + "workdir" in root[len(out):] or os.sep + "data" in root[len(out):]:
            continue  # checkpoints and the MD
        for f in files:
            path = os.path.join(root, f)
            if (f.endswith(KEEP_EXT) or f.endswith(".log")) and \
                    os.path.getsize(path) <= MAX_BYTES and not os.path.islink(path):
                dst = os.path.join(keep, os.path.relpath(path, out))
                os.makedirs(os.path.dirname(dst), exist_ok=True)
                shutil.copy2(path, dst)


if __name__ == "__main__":
    main()
