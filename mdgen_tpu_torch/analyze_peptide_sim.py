"""Forward-simulation evaluation: torsion JSDs, TICA, decorrelation, MSM.

Port of the repository's ``scripts/analyze_peptide_sim.py`` onto the port's
analysis toolkit: compares sampled trajectories (``{pdbdir}/{name}.pdb``,
with a sibling ``.xtc`` when sampled with ``--xtc``) against reference MD
(``{mddir}/{name}{suffix}.npy``, atom14) and writes the same per-peptide
metric dict to ``{pdbdir}/{save_name}``:

  python -m mdgen_tpu_torch.analyze_peptide_sim --mddir data/4AA_sims \\
      --pdbdir out/ --save --no_msm --no_decorr --tica_lag 100

``--split`` (read with ``csv``) names the peptides and is held to each
PDB's sequence; without it, every ``.pdb`` in ``--pdbdir`` is analysed.
``--plot`` writes ``{pdbdir}/{name}.pdf``, the script's 4 x 4 figure (it
needs matplotlib, imported only then). Runs on the CPU; needs numpy, scipy
and torch.
"""
from __future__ import annotations

import argparse
import os
import pickle

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--mddir", type=str, required=True,
                   help="reference MD atom14 .npy directory")
    p.add_argument("--pdbdir", type=str, required=True)
    p.add_argument("--suffix", type=str, default="", help="reference npy suffix")
    p.add_argument("--save", action="store_true")
    p.add_argument("--plot", action="store_true",
                   help="write {pdbdir}/{name}.pdf (needs matplotlib)")
    p.add_argument("--save_name", type=str, default="out.pkl")
    p.add_argument("--pdb_id", nargs="*", default=[])
    p.add_argument("--no_msm", action="store_true")
    p.add_argument("--no_decorr", action="store_true")
    p.add_argument("--no_traj_msm", action="store_true")
    p.add_argument("--truncate", type=int, default=None)
    p.add_argument("--msm_lag", type=int, default=10)
    p.add_argument("--tica_lag", type=int, default=1000)
    p.add_argument("--ito", action="store_true")
    p.add_argument("--split", type=str, default=None,
                   help="split csv (name,seqres): the peptides to analyse")
    return p.parse_args(argv)


def analyze(name, args, seqres=None):
    """The metric dict of one peptide (``scripts/analyze_peptide_sim.py``'s
    ``main``)."""
    from .analysis import KMeans, estimate_markov_model, featurize_torsions, jensen_shannon
    from .analysis.featurize import describe_features
    from .analysis.metrics import acovf, torsion_decorrelation_curve
    from .analysis.msm import TICA
    from .geometry import constants as rc
    from .protein import load_trajectory

    out = {}
    np.random.seed(137)

    traj_atom14, aatype = load_trajectory(f"{args.pdbdir}/{name}.pdb")
    if seqres is not None and rc.aatype_to_str_sequence(aatype) != seqres:
        raise ValueError(f"{name}.pdb holds {rc.aatype_to_str_sequence(aatype)}, the split "
                         f"says {seqres}")
    if args.truncate:
        traj_atom14 = traj_atom14[: args.truncate]
    ref_atom14 = np.asarray(
        np.lib.format.open_memmap(f"{args.mddir}/{name}{args.suffix}.npy", "r"),
        dtype=np.float32,
    )

    def torsion_features(atom14, cossin):
        return featurize_torsions(atom14, aatype, sidechains=True, cossin=cossin)

    traj_ang = torsion_features(traj_atom14, cossin=False)
    ref_ang = torsion_features(ref_atom14, cossin=False)
    n_feats = traj_ang.shape[1]
    feat_names = describe_features(aatype, sidechains=True)
    out["features"] = feat_names

    out["JSD"] = {}
    for i, feat in enumerate(feat_names):
        rp = np.histogram(ref_ang[:, i], range=(-np.pi, np.pi), bins=100)[0]
        tp = np.histogram(traj_ang[:, i], range=(-np.pi, np.pi), bins=100)[0]
        out["JSD"][feat] = jensen_shannon(rp, tp)

    # 2D Ramachandran JSDs: the featurizer emits pyemma's interleaved order
    # (psi_0, phi_1, psi_1, phi_2, ...), so features i, i+1 for i in {1, 3}
    # are the (phi, psi) pairs of residues 1 and 2
    for i in [1, 3]:
        if i + 1 >= n_feats:
            continue
        rp = np.histogram2d(ref_ang[:, i], ref_ang[:, i + 1],
                            range=((-np.pi, np.pi), (-np.pi, np.pi)), bins=50)[0]
        tp = np.histogram2d(traj_ang[:, i], traj_ang[:, i + 1],
                            range=((-np.pi, np.pi), (-np.pi, np.pi)), bins=50)[0]
        out["JSD"][f"{feat_names[i]}|{feat_names[i + 1]}"] = jensen_shannon(rp.ravel(), tp.ravel())

    if not args.no_decorr:
        out["md_decorrelation"] = {}
        out["our_decorrelation"] = {}
        for i, feat in enumerate(feat_names):
            out["md_decorrelation"][feat] = torsion_decorrelation_curve(
                ref_ang[:, i], 100000).astype(np.float16)
            out["our_decorrelation"][feat] = torsion_decorrelation_curve(
                traj_ang[:, i], 1 if args.ito else 1000).astype(np.float16)

    # TICA on cos/sin features, fitted on the reference MD
    traj_cs = torsion_features(traj_atom14, cossin=True)
    ref_cs = torsion_features(ref_atom14, cossin=True)
    tica = TICA(lag=args.tica_lag).fit(ref_cs)
    ref_tica = tica.transform(ref_cs)
    traj_tica = tica.transform(traj_cs)

    lo0 = min(ref_tica[:, 0].min(), traj_tica[:, 0].min())
    hi0 = max(ref_tica[:, 0].max(), traj_tica[:, 0].max())
    lo1 = min(ref_tica[:, 1].min(), traj_tica[:, 1].min())
    hi1 = max(ref_tica[:, 1].max(), traj_tica[:, 1].max())

    rp = np.histogram(ref_tica[:, 0], range=(lo0, hi0), bins=100)[0]
    tp = np.histogram(traj_tica[:, 0], range=(lo0, hi0), bins=100)[0]
    out["JSD"]["TICA-0"] = jensen_shannon(rp, tp)

    rp = np.histogram2d(*ref_tica[:, :2].T, range=((lo0, hi0), (lo1, hi1)), bins=50)[0]
    tp = np.histogram2d(*traj_tica[:, :2].T, range=((lo0, hi0), (lo1, hi1)), bins=50)[0]
    out["JSD"]["TICA-0,1"] = jensen_shannon(rp.ravel(), tp.ravel())

    if not args.no_decorr:
        out["md_decorrelation"]["tica"] = acovf(
            ref_tica[:, 0], 100000, adjusted=True, demean=False).astype(np.float16)
        out["our_decorrelation"]["tica"] = acovf(
            traj_tica[:, 0], 1 if args.ito else 1000, adjusted=True, demean=False
        ).astype(np.float16)

    if not args.no_msm:
        try:
            kmeans = KMeans(k=100).fit(ref_tica)
            ref_kmeans = kmeans.transform(ref_tica)
            msm = estimate_markov_model(ref_kmeans, lag=args.tica_lag, n_states=100)
            msm.pcca(10)
            traj_discrete = msm.metastable_assignments[kmeans.transform(traj_tica)]
            ref_discrete = msm.metastable_assignments[ref_kmeans]
            out["traj_metastable_probs"] = (traj_discrete == np.arange(10)[:, None]).mean(1)
            out["ref_metastable_probs"] = (ref_discrete == np.arange(10)[:, None]).mean(1)

            cmsm = estimate_markov_model(ref_discrete, lag=args.tica_lag, n_states=10)
            P = np.eye(10)
            P[np.ix_(cmsm.active_set, cmsm.active_set)] = cmsm.transition_matrix
            out["msm_transition_matrix"] = P
            pi = np.zeros(10)
            pi[cmsm.active_set] = cmsm.pi
            out["msm_pi"] = pi

            if not args.no_traj_msm:
                traj_msm = estimate_markov_model(traj_discrete, lag=args.msm_lag, n_states=10)
                P = np.eye(10)
                P[np.ix_(traj_msm.active_set, traj_msm.active_set)] = traj_msm.transition_matrix
                out["traj_transition_matrix"] = P
                pi = np.zeros(10)
                pi[traj_msm.active_set] = traj_msm.pi
                out["traj_pi"] = pi
        except Exception as e:  # noqa: BLE001 (as the original script: the MSM is optional)
            print("ERROR", e, name, flush=True)
    if args.plot:
        make_plot(name, out, feat_names, ref_ang, traj_ang, ref_tica, traj_tica, args.pdbdir)
    return out


def make_plot(name, out, feat_names, ref_ang, traj_ang, ref_tica, traj_tica, pdbdir):
    """``{pdbdir}/{name}.pdf``, the script's 4 x 4 figure: overlaid torsion
    histograms, backbone / sidechain decorrelation curves of MD and samples,
    TICA autocorrelation, TICA free-energy surfaces, metastable occupancies,
    the MSM transition matrices and the JSD bars."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    colors = plt.rcParams["axes.prop_cycle"].by_key()["color"]
    fig, axs = plt.subplots(4, 4, figsize=(20, 20))
    bins = np.linspace(-np.pi, np.pi, 61)

    bb = [i for i, f in enumerate(feat_names) if "CHI" not in f]
    sc = [i for i, f in enumerate(feat_names) if "CHI" in f]
    for ax, idxs, title in ((axs[0, 0], bb, "BB torsions"), (axs[1, 0], sc, "Sidechain torsions")):
        for i in idxs:
            ax.hist(ref_ang[:, i], bins=bins, histtype="step", color=colors[0], density=True)
            ax.hist(traj_ang[:, i], bins=bins, histtype="step", color=colors[1], density=True)
        ax.set_title(f"{title} (MD={colors[0]}, ours={colors[1]})")

    # the stored curves are already baseline-normalized
    if "md_decorrelation" in out:
        for row, key in ((0, "md_decorrelation"), (1, "our_decorrelation")):
            for j, idxs, title in ((1, bb, "Backbone"), (2, sc, "Sidechain")):
                ax = axs[row, j]
                for ci, i in enumerate(idxs):
                    c = np.asarray(out[key][feat_names[i]], np.float64)
                    ax.plot(1 + np.arange(len(c)), c, color=colors[ci % len(colors)], lw=0.8)
                ax.set_xscale("log")
                ax.set_title(f"{title} decorrelation ({'MD' if row == 0 else 'ours'})")
            axs[row, 3].plot(np.asarray(out[key]["tica"], np.float64))
            axs[row, 3].set_title("MD TICA" if row == 0 else "Traj TICA")

    for ax, data, title in ((axs[2, 0], ref_tica[::10], "TICA FES (MD)"),
                            (axs[2, 1], traj_tica, "TICA FES (ours)")):
        h, xe, ye = np.histogram2d(data[:, 0], data[:, 1], bins=50)
        with np.errstate(divide="ignore"):
            F = -np.log(h.T / h.sum())
        ax.imshow(F, origin="lower", aspect="auto", extent=[xe[0], xe[-1], ye[0], ye[-1]],
                  cmap="nipy_spectral")
        ax.set_title(title)

    if "ref_metastable_probs" in out:
        x = np.arange(10)
        axs[2, 2].bar(x - 0.2, out["ref_metastable_probs"], 0.4, label="MD")
        axs[2, 2].bar(x + 0.2, out["traj_metastable_probs"], 0.4, label="ours")
        axs[2, 2].set_title("metastable occupancies")
        axs[2, 2].legend()
    if "msm_transition_matrix" in out:
        axs[3, 0].imshow(out["msm_transition_matrix"], cmap="viridis")
        axs[3, 0].set_title("MSM transition matrix (MD)")
    if "traj_transition_matrix" in out:
        axs[3, 1].imshow(out["traj_transition_matrix"], cmap="viridis")
        axs[3, 1].set_title("MSM transition matrix (ours)")

    jsd = out["JSD"]
    axs[3, 2].bar(range(len(jsd)), list(jsd.values()))
    axs[3, 2].set_title("JSDs")
    axs[2, 3].axis("off")
    axs[3, 3].axis("off")

    fig.tight_layout()
    fig.savefig(f"{pdbdir}/{name}.pdf")
    plt.close(fig)


def main(argv=None) -> dict:
    """Returns {name: metric dict}; with ``--save`` also pickles it."""
    args = parse_args(argv)
    seqs = {}
    if args.split:
        from .data import read_split

        seqs = read_split(args.split)
    if args.pdb_id:
        names = list(args.pdb_id)
    elif args.split:
        names = [n for n in seqs if os.path.exists(os.path.join(args.pdbdir, f"{n}.pdb"))]
    else:
        names = sorted(f.split(".")[0] for f in os.listdir(args.pdbdir)
                       if f.endswith(".pdb") and "_traj" not in f)
    print("number of trajectories", len(names))

    results = {name: analyze(name, args, seqs.get(name)) for name in names}
    if args.save:
        with open(os.path.join(args.pdbdir, args.save_name), "wb") as fh:
            pickle.dump(results, fh)
    for name, out in results.items():
        print(f"{name}: mean JSD {np.mean(list(out['JSD'].values())):.4f}")
    return results


if __name__ == "__main__":
    main()
