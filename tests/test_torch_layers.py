"""The port's layers import one way, and the rotary tables have one cached
home.

Imports point down: ``ops`` (the kernels and their plain twins) imports
torch and its own modules alone; ``config``, ``geometry``, ``tracing`` and
``parallel.distributed`` are leaves; ``models`` imports those, ``ops`` and
``transport``, never ``parallel.mesh`` (which knows the model's tree),
``runtime`` or ``data``; and no module of ``models/`` or ``ops/`` imports
the package inside a function. ``ops.rope_tables`` is the one rotary-table
helper of the model and the fused kernels: cached, bit for bit the
uncached formula, and usable for backward after a first build in inference
mode.
"""
import ast
import os
import subprocess
import sys

import pytest
import torch

from mdgen_tpu_torch.models import attention
from mdgen_tpu_torch.models.attention import RoPEAttention
from mdgen_tpu_torch.ops import rope_tables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "mdgen_tpu_torch"

# module -> the modules of the package it may load (itself and those below
# it): each entry a module or, ending in ".", a subpackage with its modules
LAYERS = {
    "ops": ("ops.",),
    "config": (),
    "geometry": ("geometry.",),
    "tracing": (),
    "parallel.distributed": ("parallel", "parallel.distributed"),
    "models": ("models.", "ops.", "config", "geometry.", "tracing", "transport.", "parallel",
               "parallel.distributed"),
}

_LOADED = ("import importlib, sys; importlib.import_module(sys.argv[1]); "
           "print(' '.join(m for m in sys.modules if m.startswith(sys.argv[2])))")


def _allowed(name, below):
    name = name[len(PKG) + 1:]
    return not name or any(name == b.rstrip(".") or (b.endswith(".") and name.startswith(b))
                           for b in below)


@pytest.mark.parametrize("layer", list(LAYERS))
def test_a_layer_loads_nothing_above_it(layer):
    """A fresh process that imports the layer loads no module of the
    package outside the layer and those below it."""
    r = subprocess.run([sys.executable, "-c", _LOADED, f"{PKG}.{layer}", PKG], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    loaded = r.stdout.split()
    assert f"{PKG}.{layer}" in loaded
    above = sorted(m for m in loaded if not _allowed(m, (layer,) + LAYERS[layer]))
    assert not above, f"importing {layer} loads {above}"


def _package_imports_in_functions(path):
    """(line, statement) of each import of the package inside a function."""
    found = []
    for fn in ast.walk(ast.parse(open(path).read())):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.ImportFrom) and (
                    node.level or (node.module or "").split(".")[0] == PKG):
                found.append((node.lineno, ast.unparse(node)))
            elif isinstance(node, ast.Import) and any(
                    a.name.split(".")[0] == PKG for a in node.names):
                found.append((node.lineno, ast.unparse(node)))
    return found


@pytest.mark.parametrize("subpackage", ["models", "ops"])
def test_no_function_level_imports_of_the_package(subpackage):
    """Imports of the package sit at the top of each module: none hides a
    cycle inside a function body."""
    root = os.path.join(REPO, PKG, subpackage)
    files = sorted(f for f in os.listdir(root) if f.endswith(".py"))
    assert files
    found = {f: _package_imports_in_functions(os.path.join(root, f)) for f in files}
    assert not any(found.values()), {f: v for f, v in found.items() if v}


def _uncached_tables(S, hd, dtype, device=None):
    """The formula every caller ran before the cache: f32, then the cast."""
    inv_freq = 1.0 / (10000 ** (torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd))
    t = torch.arange(S, dtype=torch.float32, device=device)
    freqs = t[:, None] * inv_freq[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.sin(emb).to(dtype), torch.cos(emb).to(dtype)


# the key counts (bias key included) of the cells' attentions, head dim 24:
# 4AA's frames and residues, ATLAS's residues and frames
CELL_KEYS = [1001, 5, 257, 251]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("S", CELL_KEYS)
def test_cached_tables_equal_the_uncached_formula(S, dtype):
    rope_tables.cache_clear()
    sin, cos = rope_tables(S, 24, dtype, torch.device("cpu"))
    want_sin, want_cos = _uncached_tables(S, 24, dtype)
    assert sin.dtype == cos.dtype == dtype and sin.shape == (S, 24)
    assert sin.is_contiguous() and cos.is_contiguous()
    assert torch.equal(sin, want_sin) and torch.equal(cos, want_cos)
    again = rope_tables(S, 24, dtype, torch.device("cpu"))
    assert again[0] is sin and again[1] is cos


def _forward_backward(mod, x, mask, axis):
    x = x.clone().requires_grad_(True)
    out = mod(x, mask, axis=axis)
    grads = torch.autograd.grad(out.float().square().sum(), [x, *mod.parameters()])
    return out.detach(), grads


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("axis", [1, 2], ids=["frames", "residues"])
def test_tables_built_while_sampling_serve_a_train_step(axis, dtype, monkeypatch):
    """A forward under ``torch.inference_mode()`` builds the table first;
    the forward and backward at the same shape after it run and equal the
    module on the uncached formula."""
    rope_tables.cache_clear()
    mod = RoPEAttention(32, 4, dtype=dtype)
    mod.reset_parameters(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 6, 5, 32, generator=g)
    mask = torch.ones(2, 6, 5)
    mask[1, :, -1] = 0.0
    with torch.inference_mode():
        sampled = mod(x, mask, axis=axis)
    assert rope_tables.cache_info().currsize == 1
    out, grads = _forward_backward(mod, x, mask, axis)
    assert rope_tables.cache_info().hits >= 1
    monkeypatch.setattr(attention, "rope_tables", _uncached_tables)
    want_out, want_grads = _forward_backward(mod, x, mask, axis)
    assert torch.equal(sampled, want_out) and torch.equal(out, want_out)
    for got, want in zip(grads, want_grads):
        assert torch.equal(got, want)
