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
an error in one peptide is printed and the others go on. ``--plot`` is not
ported (matplotlib). Runs on the CPU.
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
    p.add_argument("--plot", action="store_true", help="not ported (needs matplotlib)")
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
    paths, aatype = [], None
    for m in samples_meta:
        atom14, aatype = load_trajectory(m["path"])
        paths.append(discretize_traj(atom14, aatype, meta)[0])
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
    return out


def main(argv=None) -> dict:
    """Returns {name: metric dict}; with ``--save`` also pickles it."""
    args = parse_args(argv)
    if args.plot:
        raise NotImplementedError("--plot is not ported (matplotlib); ROADMAP queue 1")
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
