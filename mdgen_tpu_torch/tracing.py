"""Host-clock spans at the boundaries of the train step and the loader.

    with tracing.span("train.step", state.step):
        ...

A span keeps a thread-local stack of the spans open on its thread. On exit
it appends one record to a module ring (the newest ``1 << 16``):

    (name, step, parent_name, thread_ident, t0_ns, t1_ns)

Both times are ``time.perf_counter_ns()``. ``step`` is the train step or the
loader's batch index; a span given none takes its parent's, so every span of
one step shares it. ``records()`` returns a copy of the ring.

With no profiler recording, a span reads the clock twice, pushes and pops
the stack and appends its record: no device call, no synchronisation. While
a ``torch.profiler`` records (the benchmark's ``--trace 1``, the train CLI's
``--profile_steps``), it also enters ``record_function(name)``, so the span
stands on the profiler's timeline beside the device's kernels.

Importing this module imports no torch; the profiler's flag is read only
once torch has been imported by someone else.

Spans: ``train.step`` (``TrainRuntime.train_step``) and inside it
``train.forward`` (with ``train.tokenize``), ``train.backward``,
``train.grad_mean`` and ``train.optimizer`` (norm, clip, Adam and EMA), on
a step that runs eagerly or is captured as a CUDA graph
(``train.graph_capture``, around them); a step replayed from the graph
holds ``train.graph_replay`` alone; ``data.wait``
(the consumer's wait on ``Loader``'s queue), ``data.load`` (a batch's reads
and stack on the loader's thread) and ``data.to_device``
(``runtime.batch_to_device``); ``model.hyena`` (each
``HyenaOperator.forward``, one a trunk layer a forward of a ``--hyena``
model, under ``train.forward`` in a train step).
"""
from __future__ import annotations

import collections
import sys
import threading
from time import perf_counter_ns

_RING: collections.deque = collections.deque(maxlen=1 << 16)


class _Local(threading.local):
    def __init__(self):
        self.stack = []


_LOCAL = _Local()


def profiler_module(modules=sys.modules):
    """``torch.autograd.profiler`` once torch is imported, else None. Its
    ``_is_profiler_enabled`` is True while a profiler records; a torch that
    lacks that flag fails here, not as a span that never reaches the trace."""
    prof = modules.get("torch.autograd.profiler")
    if prof is None:
        return None
    if not isinstance(getattr(prof, "_is_profiler_enabled", None), bool) or not hasattr(
            prof, "record_function"):
        raise ImportError(
            "torch.autograd.profiler lacks _is_profiler_enabled or record_function, which "
            "mdgen_tpu_torch.tracing reads to put its spans on a profiler's timeline"
        )
    return prof


_PROFILER = profiler_module()


def profiling() -> bool:
    """True while a torch profiler records."""
    global _PROFILER
    if _PROFILER is None:
        _PROFILER = profiler_module()
        if _PROFILER is None:
            return False
    return _PROFILER._is_profiler_enabled


class span:
    """A context manager that records its host interval (module docstring)."""

    __slots__ = ("name", "step", "parent", "t0", "rf")

    def __init__(self, name: str, step=None):
        self.name, self.step = name, step

    def __enter__(self):
        stack = _LOCAL.stack
        if stack:
            top = stack[-1]
            self.parent = top.name
            if self.step is None:
                self.step = top.step
        else:
            self.parent = None
        stack.append(self)
        self.rf = None
        if profiling():
            self.rf = _PROFILER.record_function(self.name)
            self.rf.__enter__()
        self.t0 = perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _LOCAL.stack.pop()
        _RING.append((self.name, self.step, self.parent, threading.get_ident(), self.t0, t1))
        return False


def records() -> list:
    """A copy of the ring, oldest first."""
    return list(_RING)

