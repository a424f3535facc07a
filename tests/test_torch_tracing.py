"""The port's host-clock spans (``mdgen_tpu_torch.tracing``): the record, its
nesting and the ring's bound; the spans of a tiny CPU train step, of the
loader's two threads and of the copy to the device; ``record_function``
entered only while a profiler records; the train CLI's log line; and the
benchmark's six readers of the spans (``portbench/spans.py``)."""
import collections
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mdgen_tpu_torch import tracing, train
from mdgen_tpu_torch.config import MDGenConfig
from mdgen_tpu_torch.data import Loader, synthetic_trajectory
from mdgen_tpu_torch.geometry import constants as rc
from mdgen_tpu_torch.runtime import TrainRuntime, batch_to_device

TINY = dict(num_layers=1, embed_dim=32, mha_heads=4, ipa_heads=2, ipa_head_dim=8, ipa_qk=2,
            ipa_v=2, num_frames=6, crop=4, batch_size=2, sim_condition=True,
            prepend_ipa=True, abs_pos_emb=True, abs_time_emb=True, ema=True)
SEQS = ("ACDE", "KLMW")


@pytest.fixture(autouse=True)
def ring(monkeypatch):
    """A fresh ring a test, so records of other tests in the process do not
    mix in."""
    fresh = collections.deque(maxlen=tracing._RING.maxlen)
    monkeypatch.setattr(tracing, "_RING", fresh)
    return fresh


def _mine():
    me = threading.get_ident()
    return [r for r in tracing.records() if r[3] == me]


def test_record_nesting_and_step():
    """One tuple a span, (name, step, parent, thread, t0_ns, t1_ns): a child
    takes its parent's step unless given one, and lies inside it."""
    with tracing.span("a", 7):
        with tracing.span("b"):
            pass
        with tracing.span("c", 9):
            pass
    b, c, a = tracing.records()
    me = threading.get_ident()
    assert a[:4] == ("a", 7, None, me) and b[:4] == ("b", 7, "a", me)
    assert c[:4] == ("c", 9, "a", me)
    for child in (b, c):
        assert a[4] <= child[4] <= child[5] <= a[5]
    assert b[5] <= c[4]
    assert tracing._LOCAL.stack == []


def test_a_span_is_recorded_when_its_body_raises():
    with pytest.raises(KeyError):
        with tracing.span("boom", 1):
            raise KeyError("x")
    assert [r[:3] for r in tracing.records()] == [("boom", 1, None)]
    assert tracing._LOCAL.stack == []


def test_the_ring_keeps_the_newest():
    n = tracing._RING.maxlen
    assert n == 1 << 16
    for i in range(n + 100):
        with tracing.span("x", i):
            pass
    recs = tracing.records()
    assert len(recs) == n and recs[0][1] == 100 and recs[-1][1] == n + 99


def test_spans_of_one_train_step():
    """``train.step`` once, with its phases inside it in order, every one at
    the step the state held on entry."""
    cfg = MDGenConfig(**TINY)
    rt = TrainRuntime(cfg)
    state = rt.init(torch.Generator().manual_seed(0))
    atom14 = np.stack([synthetic_trajectory(s, 6, seed=i) for i, s in enumerate(SEQS)])
    batch = batch_to_device({"atom14": atom14.astype(np.float32),
                             "seqres": np.stack([rc.str_sequence_to_aatype(s) for s in SEQS]),
                             "mask": np.ones((2, 4), np.float32)}, "cpu")
    tracing._RING.clear()
    state.step = 41
    state, _ = rt.train_step(state, batch, generator=torch.Generator().manual_seed(1))
    assert state.step == 42
    recs = sorted(_mine(), key=lambda r: r[4])
    assert [r[0] for r in recs] == ["train.step", "train.forward", "train.tokenize",
                                    "train.backward", "train.grad_mean", "train.optimizer"]
    by = {r[0]: r for r in recs}
    parents = {"train.step": None, "train.forward": "train.step",
               "train.tokenize": "train.forward", "train.backward": "train.step",
               "train.grad_mean": "train.step", "train.optimizer": "train.step"}
    for name, _, parent, _, t0, t1 in recs:
        assert parent == parents[name] and t0 <= t1
        if parent is not None:
            assert by[parent][4] <= t0 and t1 <= by[parent][5], name
    assert {r[1] for r in recs} == {41}
    phases = [by[n] for n in ("train.forward", "train.backward", "train.grad_mean",
                              "train.optimizer")]
    assert all(a[5] <= b[4] for a, b in zip(phases, phases[1:]))


def test_hyena_spans_and_fftconv_calls_of_train_steps():
    """``model.hyena`` once a trunk layer a forward, under ``train.forward``
    at the step's number; ``fftconv`` counts layers x steps (none in the
    backward)."""
    from mdgen_tpu_torch import ops

    cfg = MDGenConfig(**dict(TINY, num_layers=2, hyena=True))
    rt = TrainRuntime(cfg)
    state = rt.init(torch.Generator().manual_seed(0))
    atom14 = np.stack([synthetic_trajectory(s, 6, seed=i) for i, s in enumerate(SEQS)])
    batch = batch_to_device({"atom14": atom14.astype(np.float32),
                             "seqres": np.stack([rc.str_sequence_to_aatype(s) for s in SEQS]),
                             "mask": np.ones((2, 4), np.float32)}, "cpu")
    tracing._RING.clear()
    ops.reset_launch_counts()
    steps = 3
    for _ in range(steps):
        state, _ = rt.train_step(state, batch, generator=torch.Generator().manual_seed(1))
    assert ops.launch_counts()["fftconv"] == cfg.num_layers * steps
    recs = _mine()
    forwards = [r for r in recs if r[0] == "train.forward"]
    hyena = [r for r in recs if r[0] == "model.hyena"]
    assert len(forwards) == steps and len(hyena) == cfg.num_layers * steps
    for f in forwards:
        inside = [r for r in hyena if f[4] <= r[4] and r[5] <= f[5]]
        assert len(inside) == cfg.num_layers
        assert all(r[2] == "train.forward" and r[1] == f[1] for r in inside)


class _Items:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"atom14": np.full((3, 4, 14, 3), i, np.float32),
                "seqres": np.full(4, i, np.int64), "mask": np.ones(4, np.float32),
                "name": f"item{i}"}


def test_loader_spans_on_both_threads():
    """``data.load`` a batch on the prefetch thread, ``data.wait`` a get on
    the consumer's (the last one the end of the epoch), each with the
    batch's index; the batches are the items in order."""
    loader = Loader(_Items(7), 2, shuffle=False)
    for epoch in range(2):
        tracing._RING.clear()
        got = list(loader)
        assert [b["name"] for b in got] == [[f"item{2 * i}", f"item{2 * i + 1}"]
                                            for i in range(3)]
        for i, b in enumerate(got):
            np.testing.assert_array_equal(b["seqres"][:, 0], [2 * i, 2 * i + 1])
        recs = tracing.records()
        me = threading.get_ident()
        waits = [r for r in recs if r[0] == "data.wait"]
        loads = [r for r in recs if r[0] == "data.load"]
        assert [r[1] for r in waits] == [0, 1, 2, 3] and {r[3] for r in waits} == {me}
        assert [r[1] for r in loads] == [0, 1, 2]
        assert len({r[3] for r in loads}) == 1 and loads[0][3] != me
        assert all(r[2] is None and r[4] <= r[5] for r in waits + loads)


def test_batch_to_device_is_a_span():
    with tracing.span("outer", 3):
        batch_to_device({"atom14": np.zeros((1, 2, 4, 14, 3), np.float32),
                         "seqres": np.zeros((1, 4), np.int64),
                         "mask": np.ones((1, 4), np.float32)}, "cpu")
    assert [r[:3] for r in tracing.records()] == [("data.to_device", 3, "outer"),
                                                   ("outer", 3, None)]


@pytest.mark.parametrize("profiled", [False, True])
def test_record_function_only_under_a_profiler(monkeypatch, profiled):
    """Off, a span never enters ``record_function``; while a profiler
    records, each span does, and its name stands among the profiler's
    events."""
    entered = []
    real = torch.autograd.profiler.record_function

    class Counting(real):
        def __init__(self, name, *a):
            entered.append(name)
            super().__init__(name, *a)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counting)

    def work():
        with tracing.span("test.outer", 0):
            with tracing.span("test.inner"):
                torch.ones(4).add_(1)

    if profiled:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            work()
        assert {"test.outer", "test.inner"} <= {e.name for e in prof.events()}
        assert entered == ["test.outer", "test.inner"]
    else:
        assert not tracing.profiling()
        work()
        assert entered == []
    assert [r[0] for r in tracing.records()] == ["test.inner", "test.outer"]


def test_profiler_module_checks_the_flag():
    good = SimpleNamespace(_is_profiler_enabled=False, record_function=object)
    assert tracing.profiler_module({}) is None
    assert tracing.profiler_module({"torch.autograd.profiler": good}) is good
    for bad in (SimpleNamespace(record_function=object),
                SimpleNamespace(_is_profiler_enabled=False)):
        with pytest.raises(ImportError, match="_is_profiler_enabled"):
            tracing.profiler_module({"torch.autograd.profiler": bad})
    assert tracing.profiler_module() is torch.autograd.profiler


def test_the_cli_logs_each_spans_mean_host_ms():
    ms = 1_000_000
    tracing._RING.extend([("train.step", 9, None, 1, 5 * ms, 15 * ms),  # before the mark
                          ("train.step", 10, None, 1, 20 * ms, 30 * ms),
                          ("data.wait", 10, None, 1, 30 * ms, 32 * ms),
                          ("train.step", 11, None, 1, 40 * ms, 46 * ms)])
    lines = []
    mark = train._log_spans(SimpleNamespace(info=lines.append), (20 * ms, 10), 12)
    assert mark[1] == 12 and mark[0] > 46 * ms
    assert lines == ["host ms a step, steps 10-12: train.step 8.000, data.wait 1.000"]


# -- the benchmark's readers ---------------------------------------------------

METRICS = {"step_host_ms.train": ["train.step"], "forward_host_ms.train": ["train.forward"],
           "backward_host_ms.train": ["train.backward"],
           "optimizer_host_ms.train": ["train.optimizer", "train.ema"],
           "loader_wait_ms.train": ["data.wait"], "h2d_ms.train": ["data.to_device"]}
# ms of each span in every unit (made up)
TOOK = {"train.step": 300, "train.forward": 40, "train.backward": 90, "train.optimizer": 70,
        "train.ema": 20, "data.wait": 6, "data.to_device": 2, "data.load": 50}


def _records(t0_s, ends_s, lo_s):
    """Every span of TOOK in each unit, at its start; and one train.step
    that straddles ``lo_s``, the start of the window's untraced units."""
    recs = []
    for start, end in zip([t0_s] + ends_s, ends_s):
        for name, ms in TOOK.items():
            a = int(start * 1e9) + 1000
            recs.append((name, 0, None, 1, a, a + ms * 1_000_000))
        assert recs[-1][5] < end * 1e9
    mid = int(lo_s * 1e9)
    recs.append(("train.step", 0, None, 1, mid - 10, mid + 10))
    return recs


@pytest.fixture(scope="module")
def cell():
    from portbench import harness

    return harness.load_cell("train-4aa-b8")


@pytest.mark.parametrize("traced", [0, 2])
@pytest.mark.parametrize("name", sorted(METRICS))
def test_benchmark_readers(cell, name, traced):
    """Each reader is wired into the cell with its spans, and reads the mean
    host ms a unit of its spans over the units after the traced ones."""
    m = cell.metrics[name]
    assert m.entry["source"] == "host_clock" and m.meta["spans"] == METRICS[name]
    t0, ends = 1000.0, [1000.5, 1001.0, 1001.5, 1002.0, 1002.5]
    tracing._RING.extend(_records(t0, ends, ends[traced - 1] if traced else t0))
    ctx = SimpleNamespace(t0=t0, ends=ends, traced_units=traced, meta=m.meta)
    want = sum(TOOK[s] for s in METRICS[name])
    assert m.read(ctx) == pytest.approx(want, rel=1e-9)
    # no span in the window, or a program without the module: no reading
    assert m.read(SimpleNamespace(t0=0.0, ends=[1.0, 2.0], traced_units=traced,
                                  meta=m.meta)) is None


def test_a_program_without_spans_gives_no_reading(cell, monkeypatch):
    """As the parent of this module's commit, which has no ``tracing``."""
    import mdgen_tpu_torch

    monkeypatch.setitem(sys.modules, "mdgen_tpu_torch.tracing", None)
    monkeypatch.delattr(mdgen_tpu_torch, "tracing")
    m = cell.metrics["step_host_ms.train"]
    tracing._RING.extend(_records(0.0, [1.0, 2.0], 0.0))
    assert m.read(SimpleNamespace(t0=0.0, ends=[1.0, 2.0], traced_units=0, meta=m.meta)) is None


@pytest.mark.parametrize("traced", [0, 2])
def test_graph_replay_share_reader(traced):
    """``graph_replay_pct.train`` reads the share of the units after the
    traced ones whose ``train.step`` holds a ``train.graph_replay``; a
    capture's step that replays counts, an eager step does not, and a
    program that records neither span (no graph) gives no reading."""
    from portbench import harness

    m = harness.load_cell("train-4aa-b8").metrics["graph_replay_pct.train"]
    assert (m.entry["source"], m.entry["layer"], m.meta["unit"]) == \
        ("program_span", "runtime", "%")
    ms = 1_000_000
    t0, ends = 1000.0, [1000.5, 1001.0, 1001.5, 1002.0, 1002.5]
    ctx = SimpleNamespace(t0=t0, ends=ends, traced_units=traced, meta=m.meta)
    steps = []
    for start in [t0] + ends[:-1]:
        a = int(start * 1e9) + ms
        steps.append(("train.step", 0, None, 1, a, a + 100 * ms))
    tracing._RING.extend(steps)
    assert m.read(ctx) is None  # eager steps alone: a program without a graph
    inner = {0: "train.graph_capture", 3: "train.graph_replay", 4: "train.graph_replay"}
    for i, name in inner.items():
        a = steps[i][4] + ms
        tracing._RING.append((name, 0, "train.step", 1, a, a + 10 * ms))
    # of the untraced units (all five, or the last three), two replay
    assert m.read(ctx) == pytest.approx(100.0 * 2 / (len(ends) - traced), rel=1e-12)
