"""The port's flash attention (``mdgen_tpu_torch/ops/flash_attention.py``)
against the JAX package's, on the CPU.

The plain twins of the four CUDA kernels are held to the Pallas kernels
themselves, run in interpret mode (MDGEN_PALLAS_INTERPRET=1, as
``tests/test_flash_vjp.py`` does): ``_flash_fwd_tpu`` (o, lse) and
``_flash_bwd_tpu`` (dq, dk, dv, dbias), at (Tq, Tk) = (300, 301), which takes
JAX's multi-block and padding paths, and (24, 25), with masked keys. The
backward twins take JAX's own (o, lse), so each output is held alone.
Tolerances: f32 2e-5 absolute on o and lse (the bound of
``test_flash_vjp.py``: f32 online softmax against one dense softmax), 1e-5
relative to each gradient's largest entry (f32 sums over 301 keys or 300
queries in another order); bf16 operands 1e-2 relative (outputs rounded to
bf16, one ulp is 2^-8).

Also: ``chunked_attention`` against JAX's; the ``FlashAttention`` autograd
function against dense autograd; and ``RoPEAttention`` over 520 frames
(521 keys, the flash path) against the JAX module's ``impl="auto"``,
forward and input gradient, under ``jax.default_matmul_precision("highest")``.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdgen_tpu.models.attention import RoPEAttention as JaxAttention
from mdgen_tpu_torch import ops
from mdgen_tpu_torch.interop import jax_params_to_state_dict
from mdgen_tpu_torch.models.attention import RoPEAttention, resolve_impl

# the packages export a function of the module's name: import the modules by name
fa = importlib.import_module("mdgen_tpu_torch.ops.flash_attention")
jax_flash = importlib.import_module("mdgen_tpu.ops.flash_attention")

SHAPES = {"multi_block": (2, 300, 301, 8), "single_block": (3, 24, 25, 16)}


@pytest.fixture()
def interp(monkeypatch):
    monkeypatch.setenv("MDGEN_PALLAS_INTERPRET", "1")


def _inputs(N, Tq, Tk, d, seed=0):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(N, Tq, d)) * 0.3).astype(np.float32)
    k = (rng.normal(size=(N, Tk, d)) * 0.3).astype(np.float32)
    v = (rng.normal(size=(N, Tk, d)) * 0.3).astype(np.float32)
    do = rng.normal(size=(N, Tq, d)).astype(np.float32)
    mask = np.ones((N, Tk), np.float32)
    mask[:, Tk // 3: Tk // 2] = 0.0
    mask[0, :-1] = 0.0  # one row attends to its last key alone
    bias = np.where(mask > 0, 0.0, np.finfo(np.float32).min).astype(np.float32)
    return q, k, v, bias, do


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_plain_twins_match_pallas_kernels(interp, shape, dtype):
    q, k, v, bias, do = _inputs(*SHAPES[shape])
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jq, jk, jv, jdo = (jnp.asarray(x).astype(jdt) for x in (q, k, v, do))
    with jax.default_matmul_precision("highest"):
        o_j, lse_j = jax_flash._flash_fwd_tpu(jq, jk, jv, jnp.asarray(bias))
        grads_j = jax_flash._flash_bwd_tpu(jq, jk, jv, jnp.asarray(bias), o_j, lse_j, jdo)
    tq, tk, tv, tdo = (torch.from_numpy(np.array(x.astype(jnp.float32))).to(tdt)
                       for x in (jq, jk, jv, jdo))
    tb = torch.from_numpy(bias)
    o, lse = fa.flash_attention_plain(tq, tk, tv, tb)
    assert o.dtype == tdt and lse.dtype == torch.float32
    o_jt = torch.from_numpy(np.array(o_j.astype(jnp.float32))).to(tdt)
    lse_jt = torch.from_numpy(np.array(lse_j))
    grads = fa.flash_attention_bwd_plain(tq, tk, tv, tb, o_jt, lse_jt, tdo)
    if dtype == "f32":
        np.testing.assert_allclose(o.numpy(), np.asarray(o_j), atol=2e-5)
        np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), atol=2e-5)
        tol = 1e-5
    else:
        assert _rel(o.float(), o_j) <= 1e-2
        np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), atol=1e-4)
        tol = 1e-2
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), grads, grads_j):
        assert a.dtype == (torch.float32 if name == "dbias" else tdt), name
        assert _rel(a.float(), b) <= tol, (name, _rel(a.float(), b))


def test_chunked_attention_matches_jax():
    q, k, v, bias, _ = _inputs(2, 300, 301, 8, seed=1)
    with jax.default_matmul_precision("highest"):
        ref = jax_flash.chunked_attention(*(jnp.asarray(x) for x in (q, k, v, bias)), block_k=128)
    out = ops.chunked_attention(*(torch.from_numpy(x) for x in (q, k, v, bias)), block_k=128)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-6)


def _dense(q, k, v, bias):
    s = torch.einsum("nqd,nkd->nqk", q, k) + bias[:, None, :]
    return torch.einsum("nqk,nkd->nqd", torch.softmax(s, dim=-1), v)


def test_autograd_function_matches_dense_autograd():
    """The FlashAttention Function (kernel 5 forward, kernels 6 and 7
    backward: their plain twins here) against autograd through dense
    attention; 1e-5 relative (f32, sums in another order)."""
    q, k, v, bias, do = (torch.from_numpy(x) for x in _inputs(2, 70, 65, 24, seed=2))
    bias = bias.clone().requires_grad_(True)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = ops.flash_attention(*leaves, bias)
    (out * do).sum().backward()
    ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref_bias = bias.detach().clone().requires_grad_(True)
    ref = _dense(*ref_leaves, ref_bias)
    (ref * do).sum().backward()
    assert _rel(out.detach(), ref.detach()) <= 1e-5
    for a, b in zip(leaves + [bias], ref_leaves + [ref_bias]):
        assert _rel(a.grad, b.grad) <= 1e-5
    with torch.no_grad():  # no grad: the plain forward alone (kernel 4's twin)
        assert _rel(ops.flash_attention(q, k, v, bias), ref.detach()) <= 1e-5


def test_impl_resolution_matches_jax():
    for impl in ("auto", "flash"):
        assert resolve_impl(impl, 512) == "dense"
        assert resolve_impl(impl, 513) == "flash"
    assert resolve_impl("dense", 1001) == "dense"
    assert resolve_impl("chunked", 10) == "chunked"


def test_rope_attention_flash_path_matches_jax():
    """B=1, T=520 frames (521 keys with the bias token: flash), L=2, C=32,
    4 heads; residue 1 masked, so its queries see only the bias key.
    Forward and gradient wrt the input; 1e-5 absolute (|out| ~ 0.3)."""
    B, T, L, C, H = 1, 520, 2, 32, 4
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(B, T, L, C)) * 0.2).astype(np.float32)
    mask = np.ones((B, T, L), np.float32)
    mask[:, :, 1] = 0.0
    w = rng.normal(size=(B, T, L, C)).astype(np.float32)
    jmod = JaxAttention(C, H, impl="auto")
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask), axis=1)

    def loss(xx):
        return jnp.sum(jmod.apply(params, xx, jnp.asarray(mask), axis=1) * w)

    with jax.default_matmul_precision("highest"):
        out_j = jmod.apply(params, jnp.asarray(x), jnp.asarray(mask), axis=1)
        g_j = jax.grad(loss)(jnp.asarray(x))

    mod = RoPEAttention(C, H, impl="auto")
    mod.load_state_dict(jax_params_to_state_dict(params["params"]))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = mod(xt, torch.from_numpy(mask), axis=1)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_j), atol=1e-5)
