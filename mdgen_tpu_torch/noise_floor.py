"""Same-system sampling-noise floor of the sim-quality JSD metric.

    python -m mdgen_tpu_torch.noise_floor --out OUT --n_paths 10

The port's counterpart of ``scripts/noise_floor.py``, on the port's rotamer
generator and analysis, with no jax. The generator's ``seed`` defines the
physical SYSTEM (each torsion's basins and jump kinetics), so two seeds are
two worlds; the floor needs two independent TRAJECTORIES of one system: both
sides are drawn in ``path_seed`` mode (the same ``seed`` per peptide, other
``path_seed``s), the "MD" side at the training-set length (``--md_frames``,
in ``OUT/data``, or ``--mddir``), the "generated" side at the quality loop's
sample count (``--n_gen`` frames in ``--n_paths`` independent paths,
concatenated), written as ``sim_inference --xtc`` writes samples
(``OUT/samples/{name}.pdb`` + ``.xtc``) and scored by
``analyze_peptide_sim`` into ``OUT/samples/floor.pkl``. The JSD it reports is
what a perfect model of the dynamics would score at these sample sizes.
``--replay_frames`` (the ``num_frames`` of a default-mode dataset) makes both
sides replay that dataset's systems. One path has fewer effective samples
than the quality loop's independent rollouts; ``--n_paths`` matches them.
"""
from __future__ import annotations

import argparse
import os

PEPTIDES = ["ACDE", "WYNK", "GSVL", "FHMT", "RQIP", "DKYA", "NEWS", "LCTV"]


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--md_frames", type=int, default=5000)
    p.add_argument("--n_gen", type=int, default=1000,
                   help="total generated-side frames per peptide")
    p.add_argument("--n_paths", type=int, default=1,
                   help="independent generated-side paths (the quality loop's num_rollouts "
                        "analogue); n_gen is split across them")
    p.add_argument("--seed", type=int, default=0,
                   help="system seed (quality_run uses 0, i.e. per-peptide systems seed+i)")
    p.add_argument("--mddir", type=str, default=None,
                   help="reuse an existing MD-side dataset dir (must be the same systems, "
                        "i.e. same --seed) instead of generating one")
    p.add_argument("--replay_frames", type=int, default=None,
                   help="num_frames of an existing DEFAULT-mode dataset whose systems both "
                        "sides should replay (e.g. 5000 for the quality_run training sets); "
                        "without it the systems are the path_seed-mode ones")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Returns ``analyze_peptide_sim``'s {name: metrics}, also in
    ``OUT/samples/floor.pkl``."""
    args = parse_args(argv)
    import numpy as np

    from . import analyze_peptide_sim
    from .data import synthetic_rotamer_trajectory, write_synthetic_dataset
    from .geometry import constants as rc
    from .protein import save_trajectory

    data_dir = args.mddir or os.path.join(args.out, "data")
    samp_dir = os.path.join(args.out, "samples")
    os.makedirs(samp_dir, exist_ok=True)
    if args.mddir is None:
        # "MD" side: an independent long path of each system
        write_synthetic_dataset(data_dir, [(s, s) for s in PEPTIDES],
                                num_frames=args.md_frames, seed=args.seed, rotamers=True,
                                path_seed=500, replay_frames=args.replay_frames)
    # "generated" side: n_paths further independent paths, concatenated
    per = args.n_gen // args.n_paths
    for i, s in enumerate(PEPTIDES):
        parts = [synthetic_rotamer_trajectory(s, per, seed=args.seed + i,
                                              path_seed=900 + 100 * j + i,
                                              replay_frames=args.replay_frames)
                 for j in range(args.n_paths)]
        arr = np.concatenate(parts, 0).astype(np.float32)
        save_trajectory(arr, np.asarray(rc.str_sequence_to_aatype(s)),
                        os.path.join(samp_dir, f"{s}.pdb"),
                        xtc_path=os.path.join(samp_dir, f"{s}.xtc"))

    argv = ["--mddir", data_dir, "--pdbdir", samp_dir, "--save", "--no_msm", "--no_decorr",
            "--tica_lag", "100", "--save_name", "floor.pkl",
            "--split", os.path.join(data_dir, "split.csv")]
    print("+ analyze_peptide_sim", " ".join(argv), flush=True)
    return analyze_peptide_sim.main(argv)


if __name__ == "__main__":
    main()
