"""Fixtures of the benchmark's own tests: a copy of ``portbench/`` with a
``BENCHMARK.json`` of tiny cells (2 layers x 32 wide, a few frames) that the
harness runs on the CPU, and the card when a test needs one. Run with
``python -m pytest portbench/tests`` from the repository's root; the tests
marked ``cuda`` run on a card."""
from __future__ import annotations

import json
import os
import shutil

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TINY_MODEL = {"num_layers": 2, "embed_dim": 32, "mha_heads": 4, "ipa_heads": 2, "ipa_head_dim": 8,
              "ipa_qk": 4, "ipa_v": 4}


def _dump(obj, path):
    with open(path, "w") as fh:
        json.dump(obj, fh, indent=1)


def build_tiny_root(dest: str) -> str:
    """``dest`` with a copy of ``portbench/`` (the program beside it, by a
    link), tiny configurations and cells, and their ``BENCHMARK.json``:
    ``t4`` (4AA training) and ``ta`` (ATLAS training)."""
    shutil.copytree(os.path.join(ROOT, "portbench"), os.path.join(dest, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(os.path.join(ROOT, "mdgen_tpu_torch"), os.path.join(dest, "mdgen_tpu_torch"))
    pb = os.path.join(dest, "portbench")
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    c4 = json.load(open(os.path.join(pb, "configs", "mdgen-4aa-34m.json")))
    c4["model"].update(TINY_MODEL)
    c4["train"]["num_frames"] = 16
    ca = json.load(open(os.path.join(pb, "configs", "mdgen-atlas-34m.json")))
    ca["model"].update(TINY_MODEL, crop=12)
    ca["train"]["num_frames"] = 6
    _dump(c4, os.path.join(pb, "configs", "tiny4.json"))
    _dump(ca, os.path.join(pb, "configs", "tinya.json"))
    wl = os.path.join(pb, "workloads")
    t4 = json.load(open(os.path.join(wl, "train-4aa-b8.json")))
    t4.update(pool=8, frames=24, batch_size=2, trace_units=2)
    ta = json.load(open(os.path.join(wl, "train-atlas-b1.json")))
    ta.update(pool=3, frames=10, trace_units=2)
    for name, w in (("t4", t4), ("ta", ta)):
        _dump(w, os.path.join(wl, name + ".json"))
    bench["configs"] = [
        {"name": "tiny4", "source": "test", "file": "portbench/configs/tiny4.json",
         "reduced": [], "why": "test"},
        {"name": "tinya", "source": "test", "file": "portbench/configs/tinya.json",
         "reduced": [], "why": "test"}]
    ren = {"train-4aa-b8": "t4", "train-atlas-b1": "ta"}
    cfg = {"t4": "tiny4", "ta": "tinya"}
    bench["workloads"] = [{"name": n, "config": cfg[n], "traffic": n, "chips": 1, "why": "test"}
                          for n in ("t4", "ta")]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [ren[w] for w in m["workloads"]]
    _dump(bench, os.path.join(dest, "BENCHMARK.json"))
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return build_tiny_root(str(tmp_path))


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
