"""The control on the card: the reference computed one step below each
cell's stated precision (TF32 for ``32-true``, float8 e4m3 for
``bf16-mixed``) put in the program's place fails the cell's check, and the
program itself passes it, at the cell's widths on a shorter window and a
smaller batch than the cell runs (``python -m pytest -m cuda
portbench/tests/test_portbench_control.py`` on a card)."""
from __future__ import annotations

import json
import os

import pytest

from portbench import harness
from portbench.drivers.train import gaps
from portbench.reference import precision as P

from .conftest import ROOT

CELLS = [w["name"] for w in json.load(open(os.path.join(ROOT, "BENCHMARK.json")))["workloads"]]
SMALL = {"batch_size": 2, "pool": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_and_the_program_passes(cuda_device, name):
    import torch

    cell = harness.load_cell(name)
    if torch.cuda.device_count() < cell.chips:
        pytest.skip(f"needs {cell.chips} CUDA devices")
    cell.traffic = dict(cell.traffic, **SMALL)
    drv = cell.driver(cell, 2**31 + 99, cuda_device)
    drv.trace = False
    try:
        drv.setup()
        drv.unit()
        drv.memory_peak()
        drv.release()
        ctrl = P.Precision(P.control_mode(drv.cfg["precision"]),
                           low=drv.cfg["precision"] == "bf16-mixed")
        ref = drv.reference()
        prog, control = gaps(drv.readings(), ref), gaps(drv.reference(ctrl), ref)
        assert harness.verdict(drv.numbers(prog)), prog
        assert not harness.verdict(drv.numbers(control)), control
    finally:
        drv.close()
