"""Graceful stop on SIGTERM or a ``STOP`` sentinel: the JAX package's
``mdgen_tpu/runtime/preempt.py`` (os and signal only), executed by file
path and shared, not copied. ``GracefulStop.clear_sentinel`` compares the
sentinel's mtime with the run's ``step_*`` directories, the layout of
``runtime/checkpoint.py``."""
from .._shared import load_module

GracefulStop = load_module(
    "mdgen_tpu_torch._jax_preempt", "mdgen_tpu/runtime/preempt.py"
).GracefulStop
