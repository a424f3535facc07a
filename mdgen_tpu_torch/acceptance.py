"""The 34M quality acceptances of the TPS and design tasks, on the card.

Runs ``python -m mdgen_tpu_torch.quality_run --task tps|design`` at the
34M recipe (5 x 384 x 16 heads, IPA 4 heads of 32, qk 8, v 8: 34.2M
parameters for TPS, 34.6M for design; ``--ema``; TPS: ``--chi_loss_weight
3``; design: lr 2e-4) for training seeds 0 and 1, one process a device
(``--devices``, one per seed), side by side, each for exactly ``--epochs``
train steps (the recipe's 30000 by default; the learning rate is constant,
so fewer steps are the recipe cut short, the same for both seeds; each
run's last checkpoint step is checked against it). The dataset (seed 0,
the same for every run) is written once and shared.

Then :func:`score` samples and scores each checkpoint at every sampling
seed of ``--sample_seeds`` with the dense model (the quality run's own
sampling serves its own seed), and once through the fused kernels at its
own seed (``--fused_block --record``: the kernel launches), each with the
quality run's flags and MSMs, on the run's device, all side by side.
:func:`decide` applies the acceptance rule to the 2 x K dense scores and
the fused rescorings. Writes ``OUT/acceptance_{task}.json`` (the devices
and ``nvidia-smi -L``, each run's summary, steps and ms a step, every
score, the decision) and copies the small artifacts (``persist_results.
KEEP_EXT``, at most ``MAX_BYTES`` a file) into ``--keep``.

    python -m mdgen_tpu_torch.acceptance --task tps --epochs 8000 \\
        --devices cuda:0,cuda:1 --out build/acc_tps --keep results/port_tps_34m_n8000

Four cards hold both tasks at once: one process with ``--devices
cuda:0,cuda:1``, the other with ``cuda:2,cuda:3``.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import pickle
import re
import shlex
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH = ["--num_layers", "5", "--embed_dim", "384", "--mha_heads", "16", "--ipa_heads", "4",
         "--ipa_head_dim", "32", "--ipa_qk", "8", "--ipa_v", "8"]
TASK_FLAGS = {"tps": ["--chi_loss_weight", "3"], "design": ["--lr", "2e-4"]}
SEEDS = (0, 1)
RECIPE_STEPS = 30000
# each headline figure: the JAX package's one run at 34M and 30k steps, and
# which way is better (TPS: BENCH.md's TPS table; design:
# results/r4_design/summary.json)
REFERENCE = {"tps": {"mean_gen_valid_rate": (0.66, "higher"),
                     "median_gen_JSD": (0.179, "lower")},
             "design": {"designed": (0.1445, "higher")}}
# reported beside the verdict, with no rule
REPORTED = {"tps": (), "design": ("cond", "consensus", "mode_pair")}
# the kernels the fused rescoring must launch
FUSED_KERNELS = ("fused_l_sublayer", "fused_t_sublayer", "fused_ffn_sublayer")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--task", choices=["tps", "design"], required=True)
    p.add_argument("--epochs", type=int, default=RECIPE_STEPS)
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--keep", type=str, default=None,
                   help="copy the small artifacts here")
    p.add_argument("--quality_extra", type=str, default="",
                   help="extra flags of each quality_run (e.g. a smaller width on the CPU)")
    p.add_argument("--devices", type=str, default="cuda:0,cuda:1",
                   help="one device per training seed, comma-separated")
    p.add_argument("--sample_seeds", type=str, default="0,1,2,3",
                   help="the sampling seeds every checkpoint is scored at (each training "
                        "seed among them)")
    return p.parse_args(argv)


def _run(cmd, log_path):
    print("+", " ".join(cmd), ">", log_path, flush=True)
    with open(log_path, "w") as fh:
        return subprocess.Popen(cmd, cwd=REPO, stdout=fh, stderr=subprocess.STDOUT)


def _wait(procs):
    """``procs``: (name, Popen, log path); raises with the log's tail."""
    for name, proc, log_path in procs:
        if proc.wait() != 0:
            tail = open(log_path).read()[-3000:]
            raise RuntimeError(f"{name} failed ({proc.returncode}); {log_path} ends:\n{tail}")


def _call(cmd, log_path):
    _wait([(cmd[2], _run(cmd, log_path), log_path)])


def _summary(log_path):
    """The JSON line quality_run prints before QUALITY RUN OK, and its
    [quality] line."""
    lines = open(log_path).read().splitlines()
    end = lines.index("QUALITY RUN OK")
    quality = next(line for line in lines if line.startswith("[quality]"))
    return json.loads(lines[end - 1]), quality


def _nvidia_smi(*flags):
    try:
        return subprocess.run(["nvidia-smi", *flags], capture_output=True, text=True,
                              check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return None


def check_steps(steps: dict, epochs: int) -> None:
    """Raises unless every run's last checkpoint is at step ``epochs``."""
    if any(n != epochs for n in steps.values()):
        raise RuntimeError(f"the runs' last checkpoints are at steps {steps}, not all at "
                           f"--epochs {epochs}")


def score(task, quality, run_dir, seed, device, out_dir, fused=False) -> dict:
    """Scores one checkpoint at one sampling seed: ``run_dir`` is a quality
    run's (``Q/workdir/NAME``, ``quality`` its argv); the task's inference
    CLI samples it with the quality run's flags and MSMs
    (``Q/samples/*_metadata.pkl``) at ``seed`` on ``device``, dense or
    through the fused kernels, into ``out_dir``, and the task's analysis
    scores it. Returns {"seed", "summary" (the quality run's figures),
    "launches" (the sampling process's kernel launches)}."""
    from . import quality_run as q

    qargs = q.parse_args([*quality, "--task", task, "--seed", str(seed), "--device", device])
    qout = os.path.dirname(os.path.dirname(run_dir))
    data = os.path.join(qout, "data")
    split = os.path.join(data, "split.csv")
    shutil.rmtree(out_dir, ignore_errors=True)  # the CLI skips peptides already sampled
    os.makedirs(out_dir)
    for pkl in glob.glob(os.path.join(qout, "samples", "*_metadata.pkl")):
        shutil.copy(pkl, out_dir)
    record = out_dir + "_record.json"
    py = sys.executable
    _call([py, "-m", f"mdgen_tpu_torch.{q.SAMPLE_CLI[task]}",
           *q.sample_argv(qargs, run_dir, data, out_dir, split), "--record", record,
           *(["--fused_block"] if fused else [])], out_dir + ".log")
    analysis_log = out_dir + "_analysis.log"
    _call([py, "-m", f"mdgen_tpu_torch.{q.ANALYSIS_CLI[task]}",
           *q.analyze_argv(qargs, data, out_dir, split)], analysis_log)
    if task == "tps":
        with open(os.path.join(out_dir, "tps_out.pkl"), "rb") as fh:
            summary = q.summarize_tps(pickle.load(fh))
    else:
        from .design_temp_sweep import overall_metrics

        summary = {k.replace("-", "_"): v
                   for k, v in overall_metrics(open(analysis_log).read()).items()}
    with open(record) as fh:
        launches = json.load(fh)["launches"]
    return {"seed": seed, "summary": summary, "launches": launches}


def decide(task, dense, fused, epochs, val=None) -> dict:
    """The acceptance rule.

    ``dense``: {training seed: {sampling seed: summary}}; ``fused``:
    {training seed: {"seed", "summary", "launches"} (:func:`score`) or
    {"seed", "error"}}; ``val``: reported as is. For each headline figure of REFERENCE, m and
    sigma are the mean and the sample standard deviation (ddof 1) of the
    dense scores. The figure is "held" when m is worse than JAX's by at most
    2 sigma; otherwise "not decided at N" below the recipe's RECIPE_STEPS
    steps (a cut can only handicap the port) and "fault" at them. A fused
    rescoring passes when it launched each of FUSED_KERNELS and each
    headline figure is within sigma of the dense score at its sampling seed.
    """
    def scores(key):
        return [dense[s][j][key] for s in sorted(dense) for j in sorted(dense[s])]

    figures = {}
    for fig, (ref, better) in REFERENCE[task].items():
        xs = scores(fig)
        m, sigma = statistics.mean(xs), statistics.stdev(xs)
        worse_by = ref - m if better == "higher" else m - ref
        if worse_by <= 2 * sigma:
            verdict = "held"
        elif epochs < RECIPE_STEPS:
            verdict = f"not decided at {epochs}"
        else:
            verdict = "fault"
        figures[fig] = {"jax": ref, "better": better, "scores": xs, "m": m, "sigma": sigma,
                        "worse_by": worse_by, "limit": 2 * sigma, "verdict": verdict}
    reported = {k: {"m": statistics.mean(scores(k)), "sigma": statistics.stdev(scores(k))}
                for k in REPORTED[task]}
    if val is not None:
        reported["val_recovery"] = val
    checks = {}
    for s, f in sorted(fused.items()):
        if "error" in f:  # the rescoring failed
            checks[s] = {"seed": f["seed"], "error": f["error"], "launched": False, "ok": False}
            continue
        launches = {k: f["launches"].get(k, 0) for k in FUSED_KERNELS}
        diff = {fig: f["summary"][fig] - dense[s][f["seed"]][fig] for fig in figures}
        within = {fig: abs(d) <= figures[fig]["sigma"] for fig, d in diff.items()}
        launched = all(n > 0 for n in launches.values())
        checks[s] = {"seed": f["seed"], "launches": launches, "launched": launched,
                     "diff": diff, "within_sigma": within,
                     "ok": launched and all(within.values())}
    verdicts = [f["verdict"] for f in figures.values()]
    verdict = ("fault" if "fault" in verdicts else
               "held" if all(v == "held" for v in verdicts) else f"not decided at {epochs}")
    return {"epochs": epochs, "recipe_steps": RECIPE_STEPS, "figures": figures,
            "reported": reported, "fused": checks, "verdict": verdict,
            "fused_ok": all(c["ok"] for c in checks.values())}


def main(argv=None) -> dict:
    args = parse_args(argv)
    devices = args.devices.split(",")
    sample_seeds = [int(j) for j in args.sample_seeds.split(",")]
    if len(devices) != len(SEEDS):
        raise ValueError(f"--devices names {len(devices)} devices for {len(SEEDS)} seeds")
    if not set(SEEDS) <= set(sample_seeds) or len(set(sample_seeds)) < 2:
        raise ValueError(f"--sample_seeds must hold each training seed {SEEDS} and another")
    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    try:
        return _accept(args, devices, sample_seeds, out)
    finally:  # the logs too when a step failed
        if args.keep:
            _keep(out, os.path.abspath(args.keep))


def _accept(args, devices, sample_seeds, out) -> dict:
    from .quality_run import parse_args as quality_args, write_dataset
    from .runtime.checkpoint import latest_step

    py = sys.executable
    quality = [*WIDTH, *TASK_FLAGS[args.task], "--epochs", str(args.epochs),
               "--train_extra=--ema", *shlex.split(args.quality_extra)]
    t0 = time.perf_counter()

    # 0. the dataset, written once (seed 0: every run's is the same)
    data = os.path.join(out, "data")
    write_dataset(quality_args([*quality, "--task", args.task]), data)
    data_s = time.perf_counter() - t0

    # 1. the quality runs, one a device, side by side
    procs = []
    for s, dev in zip(SEEDS, devices):
        qout = os.path.join(out, f"s{s}")
        os.makedirs(qout, exist_ok=True)
        if not os.path.lexists(os.path.join(qout, "data")):
            os.symlink(data, os.path.join(qout, "data"))
        cmd = [py, "-m", "mdgen_tpu_torch.quality_run", "--task", args.task, "--out", qout,
               "--skip_data", *quality, "--seed", str(s), "--device", dev]
        procs.append((f"quality_run seed {s}", _run(cmd, qout + ".log"), qout + ".log"))
    _wait(procs)
    runs = {}
    for s, dev in zip(SEEDS, devices):
        summary, line = _summary(os.path.join(out, f"s{s}.log"))
        (run_dir,) = glob.glob(os.path.join(out, f"s{s}", "workdir", "*"))
        ms = re.search(r"median ([0-9.]+) ms per train step", line)
        runs[s] = {"device": dev, "run_dir": run_dir, "steps": latest_step(run_dir),
                   "ms_per_step": float(ms.group(1)) if ms else None,
                   "summary": summary, "quality_line": line}
        print(f"seed {s} on {dev}: {line}\n{json.dumps(summary)}", flush=True)
    check_steps({s: r["steps"] for s, r in runs.items()}, args.epochs)
    train_s = time.perf_counter() - t0 - data_s

    # 2. every checkpoint at every other sampling seed, dense, and at its own
    #    seed through the fused kernels, side by side on the runs' devices
    jobs = [(s, j, False) for s in SEEDS for j in sample_seeds if j != s]
    jobs += [(s, s, True) for s in SEEDS]
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {(s, j, f): pool.submit(
            score, args.task, quality, runs[s]["run_dir"], j, runs[s]["device"],
            os.path.join(out, f"s{s}_fused" if f else f"s{s}_seed{j}"), f)
            for s, j, f in jobs}
        # a fused rescoring that fails fails the fused check; a dense one, the run
        scores = {job: fut.result() for job, fut in futures.items() if not job[2]}
        fused = {}
        for s in SEEDS:
            try:
                fused[s] = futures[(s, s, True)].result()
            except RuntimeError as e:
                print(f"fused rescoring of seed {s} failed: {e}", flush=True)
                fused[s] = {"seed": s, "error": str(e)}
    dense = {s: {j: (runs[s]["summary"] if j == s else scores[(s, j, False)]["summary"])
                 for j in sample_seeds} for s in SEEDS}
    val = {s: runs[s]["summary"]["val_recovery"] for s in SEEDS
           if "val_recovery" in runs[s]["summary"]}
    decision = decide(args.task, dense, fused, args.epochs, val or None)

    result = {
        "task": args.task, "epochs": args.epochs, "seeds": list(SEEDS),
        "sample_seeds": sample_seeds, "devices": dict(zip(SEEDS, devices)),
        "gpus": _nvidia_smi("-L"),
        "gpu_power": _nvidia_smi("--query-gpu=name,power.limit", "--format=csv,noheader"),
        "steps": {s: r["steps"] for s, r in runs.items()},
        "ms_per_step": {s: r["ms_per_step"] for s, r in runs.items()},
        "runs": runs, "dense": dense, "fused": fused, "decision": decision,
        "seconds": {"data": data_s, "quality_runs": train_s,
                    "scoring": time.perf_counter() - t0 - data_s - train_s,
                    "all": time.perf_counter() - t0},
    }
    with open(os.path.join(out, f"acceptance_{args.task}.json"), "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps({"decision": decision, "seconds": result["seconds"]}), flush=True)
    return result


def _keep(out, keep):
    """The small artifacts: each directory's KEEP_EXT files up to MAX_BYTES
    and the logs; of the MSMs, the quality runs' own."""
    from .persist_results import KEEP_EXT, MAX_BYTES

    for root, _, files in os.walk(out):
        rel = os.path.relpath(root, out)
        if "workdir" in rel.split(os.sep) or rel.split(os.sep)[0] == "data":
            continue  # checkpoints and the MD
        for f in files:
            path = os.path.join(root, f)
            copy_of_msm = f.endswith("_metadata.pkl") and not rel.endswith("samples")
            if (f.endswith(KEEP_EXT) or f.endswith(".log")) and not copy_of_msm and \
                    os.path.getsize(path) <= MAX_BYTES and not os.path.islink(path):
                dst = os.path.join(keep, os.path.relpath(path, out))
                os.makedirs(os.path.dirname(dst), exist_ok=True)
                shutil.copy2(path, dst)


if __name__ == "__main__":
    main()
