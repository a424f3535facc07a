"""Load the JAX package's jax-free source files by path.

``mdgen_tpu/config.py``, ``mdgen_tpu/geometry/constants/__init__.py``,
``mdgen_tpu/data/loader.py``, ``mdgen_tpu/runtime/preempt.py`` and
``mdgen_tpu/runtime/metrics.py`` use only the standard library and numpy,
but importing them through the ``mdgen_tpu`` package runs its ``__init__``
files, which import jax. The GPU host has no jax, so the port executes
those files directly and shares them instead of copying them.
"""
from __future__ import annotations

import importlib.util
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_module(name: str, relpath: str):
    """Execute ``<repo>/<relpath>`` as module ``name`` (cached in sys.modules)."""
    if name in sys.modules:
        return sys.modules[name]
    path = os.path.join(_REPO, relpath)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    # registered before execution: dataclasses look their module up by name
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[name]
        raise
    return mod
