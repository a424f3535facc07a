"""Upsampling evaluation: torsion autocorrelation of the upsampled
trajectories against the full-framerate MD and its naive subsample.

Port of the repository's ``scripts/analyze_upsampling.py`` onto the port's
analysis toolkit, writing the same ``upsampling_out.pkl``:

  python -m mdgen_tpu_torch.analyze_upsampling --mddir data/4AA_sims \\
      --pdbdir OUT --cond_interval 100 --save

For every ``{pdbdir}/{name}.pdb`` (with its ``.xtc`` when sampled with
``--xtc``) and each torsion present, ``{section: {res{l}_tor{k}: {truth,
gen, naive}}}``: the decorrelation curves of the MD
(``{mddir}/{name}{suffix}.npy``), of the upsampled trajectory and of the MD
subsampled every ``--cond_interval`` frames, as float16. As in the
original, an error in one peptide is printed and the others go on.
``--plot`` writes ``{pdbdir}/{name}_decorr.pdf``: sidechain and backbone
autocorrelation panels, MD solid, the naive subsample as points, the
upsampled trajectory dashed (matplotlib, imported only then). Summarize the
pickle with
``python -m mdgen_tpu_torch.summarize_upsampling --pkl OUT/upsampling_out.pkl``.
"""
from __future__ import annotations

import argparse
import os
import pickle
import traceback

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--mddir", type=str, required=True,
                   help="full-framerate reference MD atom14 .npy dir")
    p.add_argument("--pdbdir", type=str, required=True,
                   help="upsampling_inference output dir")
    p.add_argument("--suffix", type=str, default="")
    p.add_argument("--cond_interval", type=int, default=100)
    p.add_argument("--nlag", type=int, default=1000)
    p.add_argument("--pdb_id", nargs="*", default=[])
    p.add_argument("--save", action="store_true")
    p.add_argument("--save_name", type=str, default="upsampling_out.pkl")
    p.add_argument("--plot", action="store_true",
                   help="write {pdbdir}/{name}_decorr.pdf (needs matplotlib)")
    return p.parse_args(argv)


def analyze(name, args) -> dict:
    """The curves of one peptide (the original script's ``main``)."""
    from .analysis.featurize import torsion_angles
    from .analysis.metrics import torsion_decorrelation_curve
    from .protein import load_trajectory

    gen_atom14, aatype = load_trajectory(f"{args.pdbdir}/{name}.pdb")
    ref_atom14 = np.asarray(
        np.lib.format.open_memmap(f"{args.mddir}/{name}{args.suffix}.npy", "r"),
        dtype=np.float32)

    gen_ang, mask = torsion_angles(gen_atom14, aatype)
    ref_ang, _ = torsion_angles(ref_atom14, aatype)
    sub_ang = ref_ang[:: args.cond_interval]

    out = {"backbone": {}, "sidechain": {}}
    for l in range(gen_ang.shape[1]):  # noqa: E741
        for k in range(7):
            if mask[l, k] < 0.5:
                continue
            section = "backbone" if k < 3 else "sidechain"
            out[section][f"res{l}_tor{k}"] = {
                "truth": torsion_decorrelation_curve(ref_ang[:, l, k], args.nlag
                                                     ).astype(np.float16),
                "gen": torsion_decorrelation_curve(
                    gen_ang[:, l, k], min(args.nlag, len(gen_ang) - 2)).astype(np.float16),
                "naive": torsion_decorrelation_curve(
                    sub_ang[:, l, k], min(args.nlag // args.cond_interval, len(sub_ang) - 2)
                ).astype(np.float16),
            }
    if args.plot:
        make_plot(name, out, args.cond_interval, args.pdbdir)
    return out


def make_plot(name, out, cond_interval, pdbdir):
    """``{pdbdir}/{name}_decorr.pdf``, the script's two panels."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    colors = plt.rcParams["axes.prop_cycle"].by_key()["color"]
    fig, axs = plt.subplots(1, 2, figsize=(10, 5))
    for ax, section, title in ((axs[0], "sidechain", "sidechains"),
                               (axs[1], "backbone", "backbone")):
        for i, (key, d) in enumerate(sorted(out[section].items())):
            c = colors[i % len(colors)]
            truth = np.asarray(d["truth"], np.float32)[1:]
            ax.plot(1 + np.arange(len(truth)), truth, color=c)
            naive = np.asarray(d["naive"], np.float32)[1:]
            ax.scatter(cond_interval * (1 + np.arange(len(naive))), naive, color=c, label=key,
                       s=12)
            gen = np.asarray(d["gen"], np.float32)[1:]
            ax.plot(1 + np.arange(len(gen)), gen, color=c, linestyle="--")
        ax.set_title(f"{name} {title}")
        ax.set_xscale("log")
        ax.set_xlabel("frames")
        ax.set_ylabel("autocorrelation")
        ax.legend(loc="upper center", bbox_to_anchor=(0.5, -0.12), ncol=3, fontsize=6)
    fig.tight_layout()
    path = os.path.join(pdbdir, f"{name}_decorr.pdf")
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)
    print("plot ->", path)


def main(argv=None) -> dict:
    """Returns {name: curves}; with ``--save`` also pickles it."""
    args = parse_args(argv)
    if args.pdb_id:
        names = list(args.pdb_id)
    else:
        names = [f.split(".")[0] for f in os.listdir(args.pdbdir) if f.endswith(".pdb")]
    results = {}
    for name in names:
        try:
            results[name] = analyze(name, args)
            print("done", name)
        except Exception as e:  # noqa: BLE001 (as the original script: go on)
            traceback.print_exc()
            print("ERROR", name, e)
    if args.save:
        with open(os.path.join(args.pdbdir, args.save_name), "wb") as fh:
            pickle.dump(results, fh)
    return results


if __name__ == "__main__":
    main()
