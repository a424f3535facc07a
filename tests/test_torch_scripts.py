"""The port's counterparts of the JAX repository's user-facing scripts, on
the CPU at tiny shapes:

* ``design_ceiling_probe``: the same JSON as ``scripts/design_ceiling_probe.py``
  on the same seeded synthetic data (neither trains: exact);
* ``design_temp_sweep``: two temperatures with a tiny port checkpoint and
  ``--num_batches 1`` write the JAX script's table: its keys (the
  temperatures, each with the analysis' OVERALL metrics), and for each
  temperature the numbers the JAX analysis script prints on that
  temperature's designs;
* ``e2e_smoke --cpu`` and ``micro_fwd --device cpu`` at 2 layers x 32 wide:
  they run and print their summaries, and micro_fwd's fused route (the
  plain twins on the CPU) gives the dense route's output.
"""
import argparse
import importlib.util
import json
import os
import runpy
import sys

import numpy as np
import pytest
import torch

from mdgen_tpu_torch import design_ceiling_probe, design_temp_sweep, e2e_smoke, micro_fwd
from mdgen_tpu_torch.config import MDGenConfig
from mdgen_tpu_torch.data import write_synthetic_dataset
from mdgen_tpu_torch.models import LatentMDGenModel
from mdgen_tpu_torch.runtime import checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--num_layers", "2", "--embed_dim", "32", "--mha_heads", "4"]


def _script(name):
    env = dict(os.environ)
    spec = importlib.util.spec_from_file_location(f"{name}_original",
                                                  os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:  # a script may set JAX_PLATFORMS when it is loaded
        os.environ.clear()
        os.environ.update(env)
    return mod


def _defaults(main, argv, monkeypatch):
    """The argparse defaults of a script's ``main`` (which parses sys.argv)."""
    seen = {}

    def grab(self, args=None, namespace=None):
        seen.update(vars(self.parse_known_args(sys.argv[1:] if args is None else args)[0]))
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    monkeypatch.setattr(sys, "argv", ["x", *argv])
    with pytest.raises(SystemExit):
        main()
    monkeypatch.undo()
    return seen


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One thread a process, here and in the CLIs the sweep starts (they read
    OMP_NUM_THREADS): the shapes are tiny, and the suite's other workers hold
    the cores."""
    threads, omp = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(threads)
    if omp is None:
        os.environ.pop("OMP_NUM_THREADS")
    else:
        os.environ["OMP_NUM_THREADS"] = omp


PROBE = ["--md_frames", "200", "--num_frames", "20", "--n_queries", "3", "--library_stride",
         "30", "--stride", "5"]


def test_design_ceiling_probe_matches_the_jax_script(monkeypatch, capsys):
    original = _script("design_ceiling_probe")
    monkeypatch.setattr(sys, "argv", ["design_ceiling_probe.py", *PROBE])
    original.main()
    want = json.loads(capsys.readouterr().out.split("\n", 1)[1])
    got = design_ceiling_probe.main(PROBE + ["--device", "cpu"])
    printed = capsys.readouterr().out
    assert got == want
    assert json.loads(printed.split("\n", 1)[1]) == want
    assert 0.0 < want["oracle_designed_recovery"] <= 1.0 and want["chance"] == 0.05
    assert printed.splitlines()[0] == "library: 48 windows, feature dim 56"
    assert design_ceiling_probe.PEPTIDES == original.PEPTIDES
    assert (design_ceiling_probe.COND_IDX, design_ceiling_probe.DESIGN_IDX) == \
        (original.COND_IDX, original.DESIGN_IDX)


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    """A tiny design checkpoint and one peptide's rotamer MD; the sweep at two
    temperatures, one batch of 2 designs. ``alpha_max`` 2 (the recipe's 8)
    shortens the Dirichlet flow's table, which each design_inference process
    builds on the host (7001 x 1000 incomplete-beta values at 8)."""
    work = tmp_path_factory.mktemp("sweep")
    cfg = MDGenConfig(num_layers=1, embed_dim=32, mha_heads=4, ipa_heads=2, ipa_head_dim=8,
                      ipa_qk=2, ipa_v=2, num_frames=8, crop=4, prepend_ipa=True,
                      abs_pos_emb=True, abs_time_emb=True, inpainting=True, design=True,
                      no_aa_emb=True, no_torsion=True, sampling_method="euler",
                      inference_steps=3, alpha_max=2.0)
    model = LatentMDGenModel(cfg, cfg.latent_dim).reset_parameters(torch.Generator().manual_seed(0))
    checkpoint.save_checkpoint(str(work / "ckpt"), cfg, model.state_dict())
    data = work / "data"
    write_synthetic_dataset(str(data), [("ACDE", "ACDE")], num_frames=300, seed=0,
                            rotamers=True)
    results = design_temp_sweep.main([
        "--ckpt", str(work / "ckpt"), "--out", str(work / "out"), "--temps", "1.0,0.5",
        "--data_dir", str(data), "--num_frames", "8", "--num_batches", "1", "--batch_size", "2",
        "--tica_lag", "10", "--msm_lag", "2", "--device", "cpu"])
    return work, results


def test_design_temp_sweep_writes_the_jax_script_table(sweep, monkeypatch, capsys):
    work, results = sweep
    out = work / "out"
    table = json.loads((out / "temp_sweep.json").read_text())
    assert list(table) == ["1.0", "0.5"] and list(results) == [1.0, 0.5]
    original = _script("design_temp_sweep")
    for temp in ("1", "0.5"):
        tdir = out / f"temp_{temp}"
        assert len(json.loads((tdir / "ACDE_metadata.json").read_text())) == 2
        # the JAX analysis script on this temperature's designs
        monkeypatch.setattr(sys, "argv", ["analyze_peptide_design.py", "--pdbdir", str(tdir)])
        capsys.readouterr()
        runpy.run_path(os.path.join(REPO, "scripts", "analyze_peptide_design.py"),
                       run_name="__main__")
        want = design_temp_sweep.overall_metrics(capsys.readouterr().out)
        assert list(want) == ["designed", "cond", "consensus", "mode-pair"]
        assert table[str(float(temp))] == want
    assert (out / "temp_0.5" / "ACDE_metadata.pkl").is_symlink()  # the shared MSM
    # the same flags and defaults, less the output directory; the port adds --device
    got = vars(design_temp_sweep.parse_args(["--ckpt", "c"]))
    want = _defaults(original.main, ["--ckpt", "c"], monkeypatch)
    assert {k: v for k, v in got.items() if k not in ("out", "device")} == \
        {k: v for k, v in want.items() if k != "out"}
    assert design_temp_sweep.PEPTIDES == original.PEPTIDES


def test_e2e_smoke_runs_on_the_cpu(tmp_path, capsys):
    res = e2e_smoke.main(["--cpu", "--steps", "12", "--num_frames", "8", "--batch_size", "4",
                          "--out", str(tmp_path), *TINY])
    printed = capsys.readouterr().out
    assert "E2E SMOKE OK" in printed and "torsion JSDs: mean" in printed
    assert res["loss1"] < res["loss0"] and np.isfinite(res["jsds"]).all()
    assert os.path.exists(res["pdb"]) and (tmp_path / "ckpt" / "model.pt").exists()


def test_micro_fwd_runs_on_the_cpu(capsys):
    argv = ["--device", "cpu", "--steps", "3", "--batch", "2", *TINY]
    dense = micro_fwd.main(argv)
    fused = micro_fwd.main(argv + ["--fused_block"])
    printed = capsys.readouterr().out
    assert printed.count("per denoiser step: eager") == 2 and fused["graph_ms"] is None
    assert dense["out"].shape == (2, 100, 4, 21) and torch.isfinite(fused["out"]).all()
    # the forwards' own sum (out - x0), to chip_smoke's MICRO_TOL; bf16-mixed:
    # the dense route rounds q, k, logits and probabilities to bf16 where the
    # fused twins keep f32
    scale = dense["drift"].abs().max()
    assert scale > 0
    assert (fused["drift"] - dense["drift"]).abs().max() <= 2e-3 * scale
    assert not any(fused["launches"].values())  # the CPU runs the plain twins
