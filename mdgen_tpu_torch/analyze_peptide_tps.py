"""TPS evaluation: generated paths against bridges of the reference MSM.

Port of the repository's ``scripts/analyze_peptide_tps.py`` onto the port's
analysis toolkit, with the same metrics and ``tps_out.pkl`` keys:

  python -m mdgen_tpu_torch.analyze_peptide_tps --mddir data/4AA_sims \\
      --pdbdir OUT --save

Reads what ``mdgen_tpu_torch.tps_inference`` wrote to ``--pdbdir``: each
peptide's ``{name}_metadata.json`` (the paths and their endpoint states)
and ``{name}_metadata.pkl`` (the reference MSM; one written by the JAX CLI
is refused). Each path is discretized through the cached TICA, k-means and
PCCA+ assignment, then scored by ``analysis.reference_tps_metrics``
(``gen_prob``, ``gen_valid_prob``, ``gen_valid_rate``, ``gen_JSD`` against
``--n_bridge_samples`` exact bridges) plus the ``endpoint_match_rate``
diagnostic; ``--repdir`` adds the replica-MD baselines. As in the original,
an error in one peptide is printed and the others go on. ``--plot`` writes
``{pdbdir}/{name}_tps.pdf``, the script's figure (free-energy surfaces with
the endpoint states, the cMSM's zeros and graph, the visited-state
distributions, the discretized paths and up to 8 paths over the reference
surface; matplotlib, imported only then). Runs on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import traceback

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--mddir", type=str, required=True,
                   help="reference MD atom14 .npy directory")
    p.add_argument("--pdbdir", type=str, required=True, help="tps_inference output dir")
    p.add_argument("--repdir", type=str, default=None,
                   help="replica MD .npy directory for the 2-100ns baselines")
    p.add_argument("--suffix", type=str, default="")
    p.add_argument("--pdb_id", nargs="*", default=[])
    p.add_argument("--n_bridge_samples", type=int, default=1000)
    p.add_argument("--rep_lens", type=str,
                   default="999999,500000,300000,200000,100000,50000,20000",
                   help="replica truncation lengths in frames")
    p.add_argument("--rep_names", type=str, default="100ns,50ns,30ns,20ns,10ns,5ns,2ns")
    p.add_argument("--rep_msm_lag", type=int, default=1000)
    p.add_argument("--save", action="store_true")
    p.add_argument("--save_name", type=str, default="tps_out.pkl")
    p.add_argument("--plot", action="store_true",
                   help="write {pdbdir}/{name}_tps.pdf (needs matplotlib)")
    return p.parse_args(argv)


def discretize_traj(atom14, aatype, meta):
    from .analysis import featurize_torsions

    feats = featurize_torsions(atom14, aatype, sidechains=True, cossin=True)
    y = meta["tica"].transform(feats)
    return meta["msm"].metastable_assignments[meta["kmeans"].transform(y)], y


def analyze(name, args) -> dict:
    """The metric dict of one peptide (the original script's ``main``)."""
    from .analysis import load_msm_cache, reference_replica_metrics, reference_tps_metrics
    from .protein import load_trajectory

    rng = np.random.default_rng(137)
    meta = load_msm_cache(f"{args.pdbdir}/{name}_metadata.pkl")
    with open(f"{args.pdbdir}/{name}_metadata.json") as fh:
        samples_meta = json.load(fh)

    cmsm = meta["cmsm"]
    paths, gen_ys, aatype = [], [], None
    for m in samples_meta:
        atom14, aatype = load_trajectory(m["path"])
        labels, y = discretize_traj(atom14, aatype, meta)
        paths.append(labels)
        gen_ys.append(y)
    paths = np.stack(paths)  # [S, T] metastable labels
    start_state = samples_meta[0]["start_state"]
    end_state = samples_meta[0]["end_state"]

    out, ref_stateprobs, gen_tp = reference_tps_metrics(
        paths, cmsm, start_state, end_state, n_bridge_samples=args.n_bridge_samples, rng=rng)
    # diagnostic only, not a reference metric
    out["endpoint_match_rate"] = float(
        ((paths[:, 0] == start_state) & (paths[:, -1] == end_state)).mean())

    if args.repdir is not None:
        rep14 = np.asarray(np.lib.format.open_memmap(
            os.path.join(args.repdir, f"{name}{args.suffix}.npy"), mode="r"), np.float32)
        rep_discrete, _ = discretize_traj(rep14, aatype, meta)
        rep_out, _ = reference_replica_metrics(
            rep_discrete, cmsm, start_state, end_state, ref_stateprobs,
            rep_lens=[int(x) for x in args.rep_lens.split(",")],
            rep_names=args.rep_names.split(","), msm_lag=args.rep_msm_lag,
            traj_len=gen_tp.shape[1], n_samples=args.n_bridge_samples, rng=rng)
        out.update(rep_out)
    if args.plot:
        from .analysis import get_state_probs

        make_plot(name, meta, gen_ys, gen_tp, start_state, end_state, ref_stateprobs,
                  get_state_probs(gen_tp), aatype, args.mddir, args.pdbdir)
    return out


def _plot_fe(ax, Y, extent, bins=60):
    """A free-energy surface: -log of the 2D histogram, 0 at its minimum."""
    H, xe, ye = np.histogram2d(Y[:, 0], Y[:, 1], bins=bins,
                               range=[[extent[0], extent[1]], [extent[2], extent[3]]])
    with np.errstate(divide="ignore"):
        F = -np.log(H.T / max(H.sum(), 1))
    F -= np.nanmin(F[np.isfinite(F)])
    F[~np.isfinite(F)] = np.nan
    ax.imshow(F, origin="lower", extent=extent, aspect="auto", cmap="nipy_spectral")


def _state_centroids(meta, Y_ref):
    """Mean TICA-2D position of each metastable state in the reference MD."""
    n = min(len(meta["ref_discrete"]), len(Y_ref))
    disc, Y = meta["ref_discrete"][:n], Y_ref[:n]
    return {int(s): Y[disc == s, :2].mean(0) for s in np.unique(disc)}


def make_plot(name, meta, gen_ys, gen_tp, start_state, end_state, ref_stateprobs,
              gen_stateprobs, aatype, mddir, pdbdir):
    """``{pdbdir}/{name}_tps.pdf``, the script's figure, over the reference
    MD ``{mddir}/{name}.npy`` in TICA space."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from .analysis import featurize_torsions

    cmsm = meta["cmsm"]
    # reference MD TICA coordinates (the cache holds only the models)
    arr = np.asarray(np.lib.format.open_memmap(os.path.join(mddir, f"{name}.npy"), mode="r"),
                     np.float32)
    Y_ref = meta["tica"].transform(featurize_torsions(arr, aatype, sidechains=True, cossin=True))
    allY = np.concatenate([Y_ref[:, :2]] + [y[:, :2] for y in gen_ys])
    extent = (allY[:, 0].min(), allY[:, 0].max(), allY[:, 1].min(), allY[:, 1].max())
    cents = _state_centroids(meta, Y_ref)

    n_overlay = min(len(gen_ys), 8)
    rows = 2 + (n_overlay + 3) // 4
    fig, axs = plt.subplots(rows, 4, figsize=(20, 4.5 * rows))

    def mark_endpoints(ax):
        for s, c in ((start_state, "black"), (end_state, "white")):
            if s in cents:
                ax.scatter(*cents[s], s=200, c=c, edgecolors="red", zorder=5)

    _plot_fe(axs[0, 0], Y_ref[::10, :2], extent)
    mark_endpoints(axs[0, 0])
    axs[0, 0].set_title("Reference MD in TICA space (start/end states)")

    _plot_fe(axs[0, 1], np.concatenate([y[:, :2] for y in gen_ys]), extent)
    mark_endpoints(axs[0, 1])
    axs[0, 1].set_title("Transition Path Ensemble")

    axs[0, 2].imshow(cmsm.transition_matrix == 0)
    axs[0, 2].set_title("Reference cMSM transition-matrix zeros")

    axs[0, 3].imshow(np.stack([ref_stateprobs, gen_stateprobs]), cmap="viridis", aspect="auto")
    axs[0, 3].set_yticks([0, 1])
    axs[0, 3].set_yticklabels(["Reference bridges", "Generated"])
    axs[0, 3].set_title("Visited-state distribution")

    # the MSM graph: nodes at the state centroids sized by pi, edges by T
    ax = axs[1, 0]
    _plot_fe(ax, Y_ref[::10, :2], extent)
    active = np.asarray(cmsm.active_set)
    pi = np.asarray(cmsm.pi)
    T = np.asarray(cmsm.transition_matrix)
    for i, si in enumerate(active):
        if int(si) not in cents:
            continue
        for j, sj in enumerate(active):
            if i == j or T[i, j] < 4e-4 or int(sj) not in cents:
                continue
            ax.annotate("", xy=cents[int(sj)], xytext=cents[int(si)],
                        arrowprops=dict(width=60 * T[i, j], headwidth=6, color="white",
                                        alpha=0.6))
    for i, si in enumerate(active):
        if int(si) in cents:
            ax.scatter(*cents[int(si)], s=3000 * pi[i], c="orange", edgecolors="black",
                       zorder=6)
            ax.annotate(str(int(si)), cents[int(si)], zorder=7)
    ax.set_title(f"Reference cMSM graph. Start {start_state}. End {end_state}.")

    # the discretized paths (11 states)
    axs[1, 1].imshow(gen_tp, aspect="auto", cmap="tab10", interpolation="nearest")
    axs[1, 1].set_title("Generated paths (discretized, 11 states)")
    axs[1, 1].set_xlabel("path position")
    axs[1, 1].set_ylabel("sample")
    axs[1, 2].axis("off")
    axs[1, 3].axis("off")

    for idx in range(n_overlay):
        ax = axs[2 + idx // 4, idx % 4]
        _plot_fe(ax, Y_ref[::10, :2], extent)
        pt = gen_ys[idx][:, :2]
        ax.plot(pt[:, 0], pt[:, 1], c="black", marker="o", ms=2, lw=0.8)
        mark_endpoints(ax)
        ax.set_title(f"Trajectory {idx}")
    for idx in range(n_overlay, 4 * (rows - 2)):
        axs[2 + idx // 4, idx % 4].axis("off")

    fig.tight_layout()
    path = os.path.join(pdbdir, f"{name}_tps.pdf")
    fig.savefig(path)
    plt.close(fig)
    print("plot ->", path)


def main(argv=None) -> dict:
    """Returns {name: metric dict}; with ``--save`` also pickles it."""
    args = parse_args(argv)
    if args.pdb_id:
        names = list(args.pdb_id)
    else:
        names = [f.replace("_metadata.json", "") for f in os.listdir(args.pdbdir)
                 if f.endswith("_metadata.json")]
    results = {}
    for name in names:
        try:
            results[name] = analyze(name, args)
            print(name, results[name])
        except Exception as e:  # noqa: BLE001 (as the original script: go on)
            traceback.print_exc()
            print("ERROR", name, e)
    if args.save:
        with open(os.path.join(args.pdbdir, args.save_name), "wb") as fh:
            pickle.dump(results, fh)
    return results


if __name__ == "__main__":
    main()
