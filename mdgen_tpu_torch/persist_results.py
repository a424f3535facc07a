"""Persist quality-run artifacts into results/ (auditable across runs).

Checkpoints and datasets live in scratch directories that do not outlast a
run, so a figure quoted from a quality run is only checkable if its small
analysis outputs are kept. This copies them (pickles, JSONs, PDFs, CSVs,
text: never checkpoints or trajectories) into ``results/r{ROUND}_{TASK}/``,
or ``results/{NAME}/`` with ``--name``, plus a summary.json recording the
command that produced them. A copy of ``scripts/persist_results.py`` (the
standard library only) with ``--name`` added.

    python -m mdgen_tpu_torch.persist_results --name port_tps_34m --task tps \\
        --src OUT/samples --note "34M, 30k steps" \\
        --cmd "python -m mdgen_tpu_torch.quality_run --task tps ..."
"""
import argparse
import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# analysis artifacts worth keeping; everything else (npy trajectories,
# xtc, checkpoints) is bulk data that stays out of git
KEEP_EXT = (".pkl", ".json", ".pdf", ".csv", ".txt")
MAX_BYTES = 5 * 1024 * 1024  # per-file cap


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--round", type=int, default=None,
                   help="names the directory r{ROUND}_{TASK} (unless --name)")
    p.add_argument("--name", type=str, default=None,
                   help="the directory under results/ (default r{ROUND}_{TASK})")
    p.add_argument("--task", type=str, required=True)
    p.add_argument("--src", type=str, required=True,
                   help="dir holding the analysis outputs")
    p.add_argument("--note", type=str, default="")
    p.add_argument("--cmd", type=str, default="",
                   help="the command that produced the artifacts")
    args = p.parse_args(argv)
    if args.name is None and args.round is None:
        p.error("give --round or --name")

    dst = os.path.join(REPO, "results", args.name or f"r{args.round}_{args.task}")
    os.makedirs(dst, exist_ok=True)
    copied, skipped = [], []
    for f in sorted(os.listdir(args.src)):
        path = os.path.join(args.src, f)
        if not os.path.isfile(path) or not f.endswith(KEEP_EXT):
            continue
        if os.path.getsize(path) > MAX_BYTES:
            skipped.append(f)
            continue
        shutil.copy2(path, os.path.join(dst, f))
        copied.append(f)

    summary = {
        "round": args.round,
        "task": args.task,
        "source": args.src,
        "command": args.cmd,
        "note": args.note,
        "files": copied,
        "skipped_oversize": skipped,
    }
    with open(os.path.join(dst, "summary.json"), "w") as fh:
        json.dump(summary, fh, indent=1)
    print(f"persisted {len(copied)} files -> {dst}"
          + (f" (skipped oversize: {skipped})" if skipped else ""))
    return dst


if __name__ == "__main__":
    main()
