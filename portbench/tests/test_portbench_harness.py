"""The harness on the CPU: every file found by name, the contract's shape of
``BENCHMARK.json`` and of the result line, a cell and a metric added by
files alone, and the counts of operations and bytes against a hand count."""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import pytest

from portbench import counting, harness
from portbench.trace import union

from .conftest import ROOT

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_files(cell):
    c = harness.load_cell(cell)
    assert c.chips in (1, 4)
    assert c.traffic["driver"] == "train"
    assert set(c.traffic["limits"]) and all(v > 0 for v in c.traffic["limits"].values())
    names = {m["name"] for m in c.e2e}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert m["moves"] in names
    for name, m in c.metrics.items():
        assert callable(m.read)
        assert m.meta.get("unit", m.entry["unit"]) == m.entry["unit"], name


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and BENCH["command"][:1] == ["python3"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    seen = set()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in seen and UNIT.match(m["unit"])
        seen.add(m["name"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def _tiny_run(root, cell, trace, seed=2**31 + 11):
    code = (
        "import sys, time; T = time.perf_counter()\n"
        "from portbench import harness, run\n"
        f"cell = harness.load_cell({cell!r})\n"
        f"res = harness.measure(cell, {seed}, 1.0, {trace}, T, device='cpu', log=run.log)\n"
        "print(harness.result_line(res, harness.verdict(res['numbers'])))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_result_line_has_the_contract_keys(tiny_root):
    line = _tiny_run(tiny_root, "t4", False)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert set(line) <= {"correct", "attempted", "failed", "metrics", "device", "breakdown",
                         "counters", "checks"}
    assert list(line)[-1] == "checks"
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(line["metrics"]) == {"setup_s", "train_samples_per_s", "train_step_p90_ms"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    assert set(line["checks"]) == {"loss_gap", "grad_gap", "update_gap", "ema_gap"}


def test_a_cell_and_a_metric_added_by_files_alone(tiny_root):
    pb = os.path.join(tiny_root, "portbench")
    before = {p: os.path.getmtime(os.path.join(dp, p)) for dp, _, fs in os.walk(pb) for p in fs}
    time.sleep(0.01)
    with open(os.path.join(pb, "workloads", "t4-b4.json"), "w") as fh:
        json.dump(dict(json.load(open(os.path.join(pb, "workloads", "t4.json"))), batch_size=4),
                  fh)
    with open(os.path.join(pb, "metrics", "steps_done.train.py"), "w") as fh:
        fh.write("def read(ctx):\n    return float(len(ctx.ends))\n")
    bench = json.load(open(os.path.join(tiny_root, "BENCHMARK.json")))
    bench["workloads"].append({"name": "t4-b4", "config": "tiny4", "traffic": "t4-b4",
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("t4-b4")
    bench["per_layer"].append({"name": "steps_done.train", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "runtime",
                               "moves": "train_samples_per_s", "workloads": ["t4-b4"]})
    with open(os.path.join(tiny_root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    line = _tiny_run(tiny_root, "t4-b4", True)
    assert line["metrics"]["steps_done.train"]["value"] >= 1
    after = {p: os.path.getmtime(os.path.join(dp, p)) for dp, _, fs in os.walk(pb) for p in fs
             if "__pycache__" not in dp}
    assert all(after[p] == t for p, t in before.items() if p in after), "no file was edited"


def test_counts_equal_a_hand_count():
    cfg = {"embed_dim": 4, "num_layers": 1, "latent_dim": 2, "mha_heads": 2, "ipa_heads": 1,
           "ipa_head_dim": 2, "ipa_qk": 1, "ipa_v": 1}
    B, T, L, C, D = 1, 2, 3, 4, 2
    N, n = B * T * L, B * L
    hand = 2 * N * D * C * 2 + 2 * B * (256 * C + C * C) + 2 * B * C * 15 * C
    tower = (2 * n * C * 3 * 2 + 2 * n * C * 3 * 3 + 2 * B * L * L * (2 + 3 + 2 + 3)
             + 2 * n * (2 + 4) * C + 8 * n * C * C + 4 * n * (L + 1) * C + 16 * n * C * C)
    trunk = 16 * N * C * C + 4 * N * (L + 1) * C + 4 * N * (T + 1) * C + 16 * N * C * C
    hand += tower + trunk + 2 * B * C * 2 * C + 2 * N * C * D
    assert counting.forward_flops(cfg, B, T, L) == hand
    assert counting.train_flops(cfg, B, T, L) == 3 * hand
    # frame attention: rows B L H = 6 of 2 queries and 3 keys of 2 channels
    ops, nbytes = counting.flash_work(cfg, B, T, L, itemsize=4)
    assert ops == 12 * 2 * 2 * 3 * 6
    q, kv, bias, lse = 6 * 2 * 2, 6 * 3 * 2, 6 * 3, 6 * 2
    assert nbytes == 4 * ((q + 2 * kv + bias) + (q + lse) + (3 * q + 2 * kv + bias) + lse
                          + (q + 2 * kv))
    assert counting.least_seconds(989e12, 1.0, 989e12) == (1.0, "operations")
    assert counting.least_seconds(1.0, 3.35e12, 989e12) == (1.0, "bytes")


def test_device_busy_is_the_union_of_intervals():
    busy, gaps = union([(0, 2), (1, 3), (5, 6), (5.5, 5.7), (8, 9)])
    assert busy == 5 and gaps == [(3, 5), (6, 8)]
