"""The check fails a run whose timed path is broken underneath: the whole
run (set-up, window, reference, verdict) at a tiny size on the CPU, the
look for a card skipped, with the program patched at the point where each
fault would be made. A sound run of the same cells is correct."""
from __future__ import annotations

import time

import pytest

from portbench import harness


def _run(root, cell, seed=2**31 + 21):
    res = harness.measure(harness.load_cell(cell, root), seed, 0.3, False, time.perf_counter(),
                          device="cpu", log=lambda m: None)
    return harness.verdict(res["numbers"]) and res["failed"] == 0, res["numbers"]


def _state_unchanged(monkeypatch):
    from mdgen_tpu_torch.runtime import optim

    monkeypatch.setattr(optim.Optimizer, "step", lambda self, params, grads, state: None)


def _half_batch_train(monkeypatch):
    from mdgen_tpu_torch.runtime import TrainRuntime

    orig = TrainRuntime.loss_fn

    def half(self, model, batch, generator=None, t=None, x0=None, *a, **k):
        n = batch["atom14"].shape[0] // 2
        batch = {key: v[:n] for key, v in batch.items()}
        return orig(self, model, batch, generator, t[:n], x0[:n], *a, **k)

    monkeypatch.setattr(TrainRuntime, "loss_fn", half)


@pytest.mark.parametrize("cell", ["t4", "ta"])
def test_a_sound_run_is_correct(tiny_root, cell):
    ok, numbers = _run(tiny_root, cell)
    assert ok, numbers


@pytest.mark.parametrize("cell,fault", [
    ("t4", _state_unchanged), ("t4", _half_batch_train), ("ta", _state_unchanged)])
def test_a_broken_run_is_not_correct(tiny_root, monkeypatch, cell, fault):
    fault(monkeypatch)
    ok, numbers = _run(tiny_root, cell)
    assert not ok, numbers
