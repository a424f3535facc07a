"""What the benchmark loads: no JAX and no JAX package on the path that
runs on the card, nothing of the program in the reference, and no result
without a card or without the program."""
from __future__ import annotations

import ast
import glob
import json
import os
import shutil
import subprocess
import sys

from .conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "mdgen_tpu"}


def _clean_env():
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def _modules_after(code: str, cwd: str) -> set:
    code += "\nimport sys, json\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
    out = subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True, text=True,
                         env=_clean_env(), timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_whole_run_loads_no_jax(tiny_root):
    """Every cell's driver, metrics and the program it drives, run end to
    end at a tiny size, leave no module whose top-level name is jax, jaxlib,
    flax or mdgen_tpu (names compared whole: mdgen_tpu_torch is the port)."""
    code = ("import time; T = time.perf_counter()\n"
            "from portbench import harness, run, calibrate, trace\n"
            "for c in ('t4', 'ta'):\n"
            "    res = harness.measure(harness.load_cell(c), 5, 0.2, c == 'ta', T, device='cpu',"
            " log=run.log)\n")
    mods = _modules_after(code, tiny_root)
    assert "mdgen_tpu_torch" in mods and "torch" in mods
    assert not mods & FORBIDDEN, mods & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    files = glob.glob(os.path.join(ROOT, "portbench", "reference", "*.py"))
    files += [os.path.join(ROOT, "portbench", f) for f in ("weights.py", "synthetic.py",
                                                          "counting.py")]
    for path in files:
        for node in ast.walk(ast.parse(open(path).read())):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) and node.level == 0 else []
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN | {"mdgen_tpu_torch"}, (path, n)
    code = ("import portbench.reference.train, portbench.weights, portbench.synthetic,"
            " portbench.counting")
    mods = _modules_after(code, ROOT)
    assert not mods & (FORBIDDEN | {"mdgen_tpu_torch"})


def _run(cwd):
    return subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "train-4aa-b8",
                           "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, env=_clean_env(), timeout=300)


def test_no_card_no_result():
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == "", "no result line without a card"
    assert "CUDA" in out.stderr


def test_the_benchmark_alone_gives_no_result(tmp_path):
    """A directory that holds only BENCHMARK.json and portbench/."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(str(tmp_path))
    assert out.returncode != 0 and out.stdout.strip() == ""
