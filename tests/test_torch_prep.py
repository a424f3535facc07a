"""MD preprocessing on the port (``python -m mdgen_tpu_torch.prep_sims``)
against ``scripts/prep_sims.py``: the same ``.npy`` bytes from multi-MODEL
PDB trajectories, with and without the ATLAS replica names, ``--stride``,
``--suffix`` and a worker pool; an output on disk is skipped; the XTC path
needs mdtraj (installed nowhere here) and fails the same way on both.

The script runs its jobs in one process: its ``--num_workers`` pool forks a
process that has imported jax, and the forked workers hang here. The worker
count changes no output, so the port's pool (``--num_workers 2``) is held
to the script's serial bytes."""
import os
import subprocess
import sys

import numpy as np
import pytest

from mdgen_tpu_torch import prep_sims
from mdgen_tpu_torch.data import synthetic_trajectory
from mdgen_tpu_torch.geometry import constants as rc
from mdgen_tpu_torch.protein import atom14_to_pdb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQS = {"1abc_A": "ACDE", "2xyz_B": "WYNKG"}
FLAGS = {
    "atlas": ["--atlas", "--stride", "2", "--suffix", "_s", "--num_workers", "2"],
    "plain": [],
}


def _sims(work, atlas):
    sim_dir = work / "sims"
    sim_dir.mkdir()
    for i, (name, seq) in enumerate(SEQS.items()):
        for rep in (1, 2, 3) if atlas else (None,):
            traj = synthetic_trajectory(seq, 5, seed=10 * i + (rep or 0)).astype(np.float32)
            fname = f"{name}_prod_R{rep}_fit" if atlas else name
            atom14_to_pdb(traj, rc.str_sequence_to_aatype(seq), str(sim_dir / f"{fname}.pdb"))
    split = work / "split.csv"
    split.write_text("name,seqres\n" + "".join(f"{n},{s}\n" for n, s in SEQS.items()))
    return sim_dir, split


def _run(argv, cwd, **kw):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    return subprocess.run([sys.executable, *argv], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300, **kw)


@pytest.mark.parametrize("case", list(FLAGS))
def test_prep_sims_writes_the_scripts_bytes(case, tmp_path):
    sim_dir, split = _sims(tmp_path, case == "atlas")
    common = ["--split", str(split), "--sim_dir", str(sim_dir), "--pdb_traj", *FLAGS[case]]
    jax_out, port_out = tmp_path / "jax", tmp_path / "port"
    r = _run([os.path.join(REPO, "scripts", "prep_sims.py"), *common, "--num_workers", "1",
              "--outdir", str(jax_out)], tmp_path)
    assert r.returncode == 0, r.stdout + r.stderr
    r = _run(["-m", "mdgen_tpu_torch.prep_sims", *common, "--outdir", str(port_out)], tmp_path)
    assert r.returncode == 0, r.stdout + r.stderr
    names = sorted(os.listdir(jax_out))
    suffix = "_s" if case == "atlas" else ""
    reps = [f"_R{k}" for k in (1, 2, 3)] if case == "atlas" else [""]
    assert names == sorted(f"{n}{rep}{suffix}.npy" for n in SEQS for rep in reps)
    assert sorted(os.listdir(port_out)) == names
    for n in names:
        assert (port_out / n).read_bytes() == (jax_out / n).read_bytes(), n
    arr = np.load(port_out / names[0])
    assert arr.dtype == np.float16 and arr.shape[0] == (3 if case == "atlas" else 5)


def test_prep_sims_skips_an_existing_output(tmp_path):
    sim_dir, split = _sims(tmp_path, atlas=False)
    out = tmp_path / "out"
    out.mkdir()
    np.save(out / "1abc_A.npy", np.zeros(3, np.float16))
    done = prep_sims.main(["--split", str(split), "--sim_dir", str(sim_dir), "--outdir",
                           str(out), "--pdb_traj"])
    assert done == list(SEQS)
    assert np.array_equal(np.load(out / "1abc_A.npy"), np.zeros(3, np.float16))
    assert np.load(out / "2xyz_B.npy").shape == (5, len(SEQS["2xyz_B"]), 14, 3)


def test_xtc_path_needs_mdtraj_on_both_sides(tmp_path):
    sim_dir, split = _sims(tmp_path, atlas=False)
    argv = ["--split", str(split), "--sim_dir", str(sim_dir), "--outdir", str(tmp_path / "o")]
    r = _run([os.path.join(REPO, "scripts", "prep_sims.py"), *argv], tmp_path)
    assert r.returncode != 0 and "No module named 'mdtraj'" in r.stderr, r.stderr
    with pytest.raises(ModuleNotFoundError, match="mdtraj"):
        prep_sims.main(argv)
