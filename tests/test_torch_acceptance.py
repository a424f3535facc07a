"""The 34M acceptance tooling (``mdgen_tpu_torch.acceptance``) on the CPU:

* ``decide`` on fixed score tables: each headline figure held, missed below
  the recipe's 30000 steps ("not decided at N") and missed at them
  ("fault"), for a figure where higher is better (TPS valid-path rate,
  design recovery) and one where lower is better (TPS median JSD); m and
  sigma are the mean and the ddof-1 standard deviation of the 2 x K scores;
  the fused check wants launches of kernels 1-3 and each figure within
  sigma of the dense score at the same sampling seed;
* ``check_steps`` raises on unequal step counts;
* ``acceptance.main`` end to end at a tiny width for TPS (the cheaper task)
  with ``--devices cpu,cpu`` and two sampling seeds: 2 x 2 dense scores,
  both runs at ``--epochs`` steps, a fused rescoring of each checkpoint
  with its launch record (0 launches here: on the CPU the wrappers run
  their plain twins).
"""
import json
import os

import numpy as np
import pytest

from mdgen_tpu_torch import acceptance

TINY = ("--num_layers 2 --embed_dim 32 --mha_heads 4 --ipa_head_dim 8 --num_frames 8 "
        "--md_frames 300 \"--train_extra=--ema --sampling_method euler --inference_steps 3\"")
LAUNCHED = {k: 50 for k in acceptance.FUSED_KERNELS}


def _table(task, values):
    """{training seed: {sampling seed: summary}} from {figure: 8 scores}."""
    dense = {s: {j: {} for j in range(4)} for s in (0, 1)}
    for fig, xs in values.items():
        for i, x in enumerate(xs):
            dense[i // 4][i % 4][fig] = x
    return dense


def _fused(dense, launches=LAUNCHED, shift=None):
    """Each checkpoint's fused rescoring at its own seed: the dense scores
    there, moved by ``shift`` ({figure: delta})."""
    shift = shift or {}
    return {s: {"seed": s, "launches": dict(launches),
                "summary": {k: v + shift.get(k, 0.0) for k, v in dense[s][s].items()}}
            for s in dense}


RATE_HELD = [0.62, 0.58, 0.66, 0.55, 0.60, 0.64, 0.57, 0.61]     # m 0.60375, worse by 0.056
RATE_MISSED = [0.50, 0.51, 0.49, 0.50, 0.52, 0.48, 0.50, 0.51]   # m 0.50125, sigma 0.012
JSD_HELD = [0.20, 0.16, 0.19, 0.22, 0.17, 0.18, 0.21, 0.15]       # m 0.185, worse by 0.006
JSD_MISSED = [0.30, 0.31, 0.29, 0.30, 0.32, 0.30, 0.31, 0.29]     # m 0.3025, sigma 0.0104
DESIGN_HELD = [0.1387, 0.1875, 0.1289, 0.16, 0.1289, 0.14, 0.12, 0.15]
DESIGN_MISSED = [0.10, 0.11, 0.10, 0.09, 0.10, 0.11, 0.10, 0.10]


@pytest.mark.parametrize("task,fig,xs,epochs,verdict", [
    ("tps", "mean_gen_valid_rate", RATE_HELD, 8000, "held"),
    ("tps", "mean_gen_valid_rate", RATE_MISSED, 8000, "not decided at 8000"),
    ("tps", "mean_gen_valid_rate", RATE_MISSED, 30000, "fault"),
    ("tps", "median_gen_JSD", JSD_HELD, 8000, "held"),
    ("tps", "median_gen_JSD", JSD_MISSED, 8000, "not decided at 8000"),
    ("tps", "median_gen_JSD", JSD_MISSED, 30000, "fault"),
    ("design", "designed", DESIGN_HELD, 30000, "held"),
    ("design", "designed", DESIGN_MISSED, 9000, "not decided at 9000"),
    ("design", "designed", DESIGN_MISSED, 30000, "fault"),
], ids=lambda v: v if isinstance(v, (str, int)) else None)
def test_decide_applies_the_rule(task, fig, xs, epochs, verdict):
    values = {"tps": {"mean_gen_valid_rate": RATE_HELD, "median_gen_JSD": JSD_HELD},
              "design": {"designed": DESIGN_HELD, "cond": RATE_MISSED,
                         "consensus": JSD_HELD, "mode_pair": RATE_HELD}}[task]
    values[fig] = xs
    dense = _table(task, values)
    d = acceptance.decide(task, dense, _fused(dense), epochs, val={0: {"x": 1.0}})
    f = d["figures"][fig]
    assert f["scores"] == xs
    np.testing.assert_allclose([f["m"], f["sigma"]], [np.mean(xs), np.std(xs, ddof=1)],
                               rtol=1e-12)
    assert f["verdict"] == verdict
    ref, better = acceptance.REFERENCE[task][fig]
    worse = ref - f["m"] if better == "higher" else f["m"] - ref
    assert (worse <= 2 * f["sigma"]) == (verdict == "held")
    # the task's verdict is its worst figure's; the other figures hold
    assert d["verdict"] == verdict
    assert all(g["verdict"] == "held" for k, g in d["figures"].items() if k != fig)
    assert d["fused_ok"]
    if task == "design":
        assert sorted(d["reported"]) == ["cond", "consensus", "mode_pair", "val_recovery"]
        np.testing.assert_allclose(d["reported"]["cond"]["sigma"], np.std(RATE_MISSED, ddof=1))


@pytest.mark.parametrize("case", ["ok", "no_launches", "one_kernel_idle", "beyond_sigma"])
def test_decide_checks_the_fused_rescoring(case):
    dense = _table("tps", {"mean_gen_valid_rate": RATE_HELD, "median_gen_JSD": JSD_HELD})
    sigma = np.std(JSD_HELD, ddof=1)
    launches = {"ok": LAUNCHED, "no_launches": {},
                "one_kernel_idle": dict(LAUNCHED, fused_t_sublayer=0),
                "beyond_sigma": LAUNCHED}[case]
    shift = 1.5 * sigma if case == "beyond_sigma" else 0.5 * sigma
    fused = _fused(dense, launches, {"median_gen_JSD": shift})
    d = acceptance.decide("tps", dense, fused, 8000)
    checks = d["fused"]
    assert sorted(checks) == [0, 1]
    assert all(c["launched"] == (case in ("ok", "beyond_sigma")) for c in checks.values())
    np.testing.assert_allclose(checks[0]["diff"]["median_gen_JSD"], shift, rtol=1e-9)
    assert all(c["within_sigma"]["mean_gen_valid_rate"] for c in checks.values())
    assert all(c["within_sigma"]["median_gen_JSD"] == (case != "beyond_sigma")
               for c in checks.values())
    assert d["fused_ok"] == (case == "ok")
    assert d["verdict"] == "held"  # the fused check does not move the figures' verdict


@pytest.mark.parametrize("steps,ok", [({0: 8000, 1: 8000}, True), ({0: 8000, 1: 7990}, False),
                                      ({0: 7000, 1: 7000}, False), ({0: 8000, 1: None}, False)])
def test_check_steps_raises_on_unequal_steps(steps, ok):
    if ok:
        acceptance.check_steps(steps, 8000)
    else:
        with pytest.raises(RuntimeError, match="not all at --epochs 8000"):
            acceptance.check_steps(steps, 8000)


def test_acceptance_runs_end_to_end_on_the_cpu(tmp_path, monkeypatch):
    """TPS, 3 steps a seed at 2 x 32, sampling seeds 0 and 1 (~20 s on one
    core)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # tiny shapes; the suite's other workers
    out, keep = tmp_path / "acc", tmp_path / "keep"
    res = acceptance.main(["--task", "tps", "--epochs", "3", "--devices", "cpu,cpu",
                           "--sample_seeds", "0,1", "--out", str(out), "--keep", str(keep),
                           "--quality_extra", TINY])
    assert res["devices"] == {0: "cpu", 1: "cpu"}
    assert res["steps"] == {0: 3, 1: 3}
    # both seeds' runs share the one dataset
    assert all(os.path.realpath(out / f"s{s}" / "data") == str(out / "data") for s in (0, 1))
    d = res["decision"]
    for fig in acceptance.REFERENCE["tps"]:
        xs = d["figures"][fig]["scores"]
        assert len(xs) == 4 and all(np.isfinite(xs)), xs
        assert xs == [res["dense"][s][j][fig] for s in (0, 1) for j in (0, 1)]
    # the run's own seed is its quality run's sampling; the other seed a rescoring
    assert res["dense"][0][0] == res["runs"][0]["summary"]
    assert res["dense"][0][1]["per_peptide"].keys() == res["dense"][0][0]["per_peptide"].keys()
    for s in (0, 1):
        record = json.loads((out / f"s{s}_fused_record.json").read_text())
        assert set(acceptance.FUSED_KERNELS) <= set(record["launches"])
        assert d["fused"][s]["launches"] == {k: 0 for k in acceptance.FUSED_KERNELS}
        assert not d["fused"][s]["launched"]  # the CPU runs the kernels' plain twins
        assert (out / f"s{s}_fused" / "tps_out.pkl").exists()
    assert not d["fused_ok"]
    written = json.loads((out / "acceptance_tps.json").read_text())
    assert written["steps"] == {"0": 3, "1": 3} and written["decision"]["verdict"] == d["verdict"]
    assert (keep / "acceptance_tps.json").exists() and (keep / "s0_fused_record.json").exists()
    assert not list(keep.rglob("*.pt")) and not (keep / "data").exists()
    assert not list((keep / "s0_fused").glob("*_metadata.pkl"))  # copies of s0's MSMs


def test_decide_records_a_failed_fused_rescoring():
    dense = _table("tps", {"mean_gen_valid_rate": RATE_HELD, "median_gen_JSD": JSD_HELD})
    fused = _fused(dense)
    fused[1] = {"seed": 1, "error": "tps_inference failed (1)"}
    d = acceptance.decide("tps", dense, fused, 8000)
    assert d["fused"][0]["ok"] and not d["fused"][1]["ok"] and not d["fused"][1]["launched"]
    assert d["fused"][1]["error"] == "tps_inference failed (1)"
    assert not d["fused_ok"] and d["verdict"] == "held"
