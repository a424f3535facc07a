"""The port's flash attention (``mdgen_tpu_torch/ops/flash_attention.py``)
against the JAX package's, on the CPU.

The plain twins of the four CUDA kernels are held to the Pallas kernels
themselves, run in interpret mode (MDGEN_PALLAS_INTERPRET=1, as
``tests/test_flash_vjp.py`` does): ``_flash_attention_tpu`` (o, kernel 4),
``_flash_fwd_tpu`` (o, lse, kernel 5) and ``_flash_bwd_tpu`` (dq, dk, dv,
dbias, kernels 6 and 7), at (Tq, Tk) = (300, 301), which takes JAX's
multi-block and padding paths, and (24, 25), with masked keys; also at d = 24
and d = 40, (70, 65) and (40, 41); and at the edges of the tensor-core
kernels' tiles: Tq = 5, fewer rows than one MMA tile, and d = 7, rows of no
whole 16 bytes. The backward twins take JAX's own (o, lse), so each output is
held alone.
Tolerances: f32 2e-5 absolute on o and lse (the bound of
``test_flash_vjp.py``: f32 online softmax against one dense softmax), 1e-5
relative to each gradient's largest entry (f32 sums over 301 keys or 300
queries in another order); bf16 operands 1e-2 relative (outputs rounded to
bf16, one ulp is 2^-8).

Also: ``chunked_attention`` against JAX's; the ``FlashAttention`` autograd
function against dense autograd; and ``RoPEAttention`` over 520 frames
(521 keys, the flash path) against the JAX module's ``impl="auto"``,
forward and input gradient, under ``jax.default_matmul_precision("highest")``.

The choice of route: off CUDA the JAX module's rule (flash from 513 keys);
on CUDA the card's crossover (``CUDA_FLASH_MIN_KEYS``), with dropout, keys
gathered over sp and a forward-mode tangent dense on both, and the module
passing its device and those conditions to the rule; under
``torch.func.jvp`` the module over 101 keys takes the dense route under the
card's rule and equals the dense module, and over 521 keys raises. The
folded flash route (its plain twin here) against the dense route run in f32
on the same operands at an ATLAS-like shape (3 of 10 residues padded, the
bias key), over both axes, forward and the gradients of q, k and v, f32
(1e-5 relative) and bf16 (8e-3 relative: the flash route keeps the logits
and probabilities in f32, the dense bf16 route rounds both), and under
non-reentrant ``torch.utils.checkpoint`` (the recompute calls the flash
route again; gradients equal to the plain run's).
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
from mdgen_tpu_torch.models import attention
from mdgen_tpu_torch.models.attention import CUDA_FLASH_MIN_KEYS, RoPEAttention, resolve_impl

# the packages export a function of the module's name: import the modules by name
fa = importlib.import_module("mdgen_tpu_torch.ops.flash_attention")
jax_flash = importlib.import_module("mdgen_tpu.ops.flash_attention")

# d = 24 (the recipe's head width) and 40: the widths that the tensor-core
# kernels pad to a whole MMA step; tq5: fewer queries than one 16-row MMA
# tile; d7: rows of no whole 16 bytes (loaded element by element)
SHAPES = {"multi_block": (2, 300, 301, 8), "single_block": (3, 24, 25, 16),
          "d24": (2, 70, 65, 24), "d40": (2, 40, 41, 40), "tq5": (2, 5, 6, 24),
          "d7": (2, 33, 70, 7)}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


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
    jdt, tdt = DTYPES[dtype]
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


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_no_grad_forward_matches_pallas_kernel(interp, shape, dtype):
    """Kernel 4: the port's ``flash_fwd`` on CPU tensors (its plain twin)
    against ``_flash_attention_tpu``, the JAX package's no-grad forward,
    with the tolerances of test_plain_twins_match_pallas_kernels."""
    q, k, v, bias, _ = _inputs(*SHAPES[shape])
    jdt, tdt = DTYPES[dtype]
    jq, jk, jv = (jnp.asarray(x).astype(jdt) for x in (q, k, v))
    with jax.default_matmul_precision("highest"):
        o_j = jax_flash._flash_attention_tpu(jq, jk, jv, jnp.asarray(bias))
    tq, tk, tv = (torch.from_numpy(np.array(x.astype(jnp.float32))).to(tdt) for x in (jq, jk, jv))
    before = fa.flash_fwd.launches
    o = fa.flash_fwd(tq, tk, tv, torch.from_numpy(bias))
    assert fa.flash_fwd.launches == before  # a CPU tensor takes the plain twin
    assert o.dtype == tdt and o.shape == tq.shape
    if dtype == "f32":
        np.testing.assert_allclose(o.numpy(), np.asarray(o_j), atol=2e-5)
    else:
        assert _rel(o.float(), o_j.astype(jnp.float32)) <= 1e-2


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


# (impl, keys with the bias key, dense_only: dropout or sp-gathered keys) -> route on CUDA
CUDA_RULE = {
    "4aa_residue": ("auto", 5, False, "dense"),
    "below_crossover": ("auto", CUDA_FLASH_MIN_KEYS - 1, False, "dense"),
    "flash_below_crossover": ("flash", CUDA_FLASH_MIN_KEYS - 1, False, "dense"),
    "crossover": ("auto", CUDA_FLASH_MIN_KEYS, False, "flash"),
    "atlas_frame": ("auto", 251, False, "flash"),
    "atlas_residue": ("flash", 257, False, "flash"),
    "4aa_frame": ("auto", 1001, False, "flash"),
    "dropout_or_sp": ("auto", 257, True, "dense"),
    "dropout_or_sp_4aa_frame": ("flash", 1001, True, "dense"),
    "dense": ("dense", 257, False, "dense"),
    "chunked": ("chunked", 257, False, "chunked"),
}


@pytest.mark.parametrize("case", list(CUDA_RULE))
def test_impl_resolution_on_cuda(case):
    """The card's crossover on CUDA; the same case off CUDA keeps the JAX
    rule (flash from 513 keys), and dense_only forces dense on both."""
    impl, keys, dense_only, want = CUDA_RULE[case]
    assert resolve_impl(impl, keys, cuda=True, dense_only=dense_only) == want
    off = "dense" if dense_only else resolve_impl(impl, keys)
    assert resolve_impl(impl, keys, cuda=False, dense_only=dense_only) == off
    assert 5 < CUDA_FLASH_MIN_KEYS <= 251


@pytest.mark.parametrize("case", ["plain", "dropout", "sp", "jvp"])
def test_module_passes_device_and_dense_only_to_the_rule(case, monkeypatch):
    """RoPEAttention asks the rule with its input's device and with
    dense_only set by a dropout, by frame keys gathered over sp (one rank of
    size 2 here: the gather is stubbed to repeat the local keys) or by a
    forward-mode tangent (``torch.func.jvp``)."""
    from mdgen_tpu_torch.models.layers import Dropout

    seen = []
    real = attention.resolve_impl
    monkeypatch.setattr(attention, "resolve_impl",
                        lambda *a: seen.append(a[2:]) or real(*a))
    kw = {}
    if case == "dropout":
        kw["drop"] = Dropout(0.1, 0, "cpu")
    if case == "sp":
        class Axis:
            size, index = 2, 0
        monkeypatch.setattr(attention, "gather_along", lambda t, dim, ax: torch.cat([t, t], dim))
        kw["sp"] = Axis()
    mod = RoPEAttention(32, 4)
    mod.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(1, 6, 3, 32, generator=torch.Generator().manual_seed(1))
    if case == "jvp":
        out, _ = torch.func.jvp(lambda xx: mod(xx, torch.ones(1, 6, 3), axis=1), (x,),
                                (torch.ones_like(x),))
    else:
        out = mod(x, torch.ones(1, 6, 3), axis=1, **kw)
    assert out.shape == x.shape
    assert seen == [(False, case != "plain")]


def test_forward_mode_ad_takes_the_dense_route(monkeypatch):
    """Below the JAX module's 513 keys a tangent takes the dense route on
    any device: under the card's rule (forced here), 101 keys take the
    flash route without a tangent and the dense one under
    ``torch.func.jvp`` (as the likelihood runs the model), its output and
    tangent equal to the dense module's. From 513 keys the flash route
    refuses the tangent, as it did before the card's rule."""
    real, real_fa, calls = attention.resolve_impl, ops.flash_attention, []
    monkeypatch.setattr(attention, "resolve_impl",
                        lambda impl, n, cuda, dense_only: real(impl, n, True, dense_only))
    monkeypatch.setattr(ops, "flash_attention", lambda *a: calls.append(a[0].shape) or real_fa(*a))
    mod = RoPEAttention(32, 4, impl="auto")
    mod.reset_parameters(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(2)
    x, dx = torch.randn(1, 520, 2, 32, generator=g), torch.randn(1, 520, 2, 32, generator=g)
    mask = torch.ones(1, 520, 2)
    x, dx, mask = x[:, :100], dx[:, :100], mask[:, :100]
    with torch.no_grad():
        mod(x, mask, axis=1)
    assert calls == [(2 * 4, 100, 8)]
    runs = {}
    for impl in ("auto", "dense"):
        mod.impl = impl
        with torch.no_grad():
            runs[impl] = torch.func.jvp(lambda xx: mod(xx, mask, axis=1), (x,), (dx,))
    assert len(calls) == 1
    for a, b in zip(runs["auto"], runs["dense"]):
        assert torch.equal(a, b)
    mod.impl = "auto"
    x, dx = torch.randn(1, 520, 2, 32, generator=g), torch.randn(1, 520, 2, 32, generator=g)
    with pytest.raises(RuntimeError, match="no forward-mode derivative"):
        torch.func.jvp(lambda xx: mod(xx, torch.ones(1, 520, 2), axis=1), (x,), (dx,))


def _atlas_like_qkv(axis, dtype, seed=5):
    """Roped-like q [1, T=6, L=10, H=4, hd=8], k and v with the bias key on
    ``axis``, the key mask with it (the last 3 residues padded), and a
    cotangent: the shapes the trunk hands its inner loop."""
    g = torch.Generator().manual_seed(seed)
    B, T, L, H, hd = 1, 6, 10, 4, 8
    kshape = [B, T, L, H, hd]
    kshape[axis] += 1
    q = (torch.randn(B, T, L, H, hd, generator=g) * hd**-0.5).to(dtype)
    k, v = (torch.randn(*kshape, generator=g).to(dtype) for _ in range(2))
    mask = torch.ones(B, T, L)
    mask[:, :, -3:] = 0.0
    mshape = [B, T, L]
    mshape[axis] = 1
    mask = torch.cat([mask, torch.ones(mshape)], dim=axis)
    return q, k, v, mask, torch.randn(B, T, L, H, hd, generator=g).to(dtype)


def _route_grads(fn, q, k, v, do):
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fn(*leaves)
    return [out.detach(), *torch.autograd.grad(out, leaves, do)]


# the folded flash route against the dense route run in f32 on the same
# (rounded) operands, relative to each tensor's largest entry: in bf16 the
# flash route keeps the logits and the probabilities in f32 and rounds its
# outputs alone, below the dense bf16 route's rounding of both
FOLDED_TOL = {"f32": 1e-5, "bf16": 8e-3}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("axis", [1, 2], ids=["frames", "residues"])
def test_folded_flash_route_matches_dense_at_an_atlas_like_shape(axis, dtype, monkeypatch):
    """The folded flash route against the dense route in f32 on the same
    operands: output and the gradients of q, k and v within FOLDED_TOL;
    then the same under non-reentrant checkpointing, where the recompute
    calls ``ops.flash_attention`` again (as kernel 5 runs twice a
    checkpointed layer on the card)."""
    from torch.utils.checkpoint import checkpoint

    dt = DTYPES[dtype][1]
    q, k, v, mask, do = _atlas_like_qkv(axis, dt)
    calls, real = [], ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention", lambda *a: calls.append(a[0].shape) or real(*a))

    def flash(a, b, c):
        return RoPEAttention._folded_attention(a, b, c, mask, axis, "flash")

    got = _route_grads(flash, q, k, v, do)
    want = _route_grads(lambda a, b, c: RoPEAttention._dense_attention(a, b, c, mask, axis),
                        *(t.float() for t in (q, k, v, do)))
    rows = 1 * 4 * (10 if axis == 1 else 6)
    assert calls == [(rows, 6 if axis == 1 else 10, 8)]
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        assert a.dtype == dt, name
        assert _rel(a.float(), b) <= FOLDED_TOL[dtype], (name, _rel(a.float(), b))
    remat = _route_grads(lambda a, b, c: checkpoint(flash, a, b, c, use_reentrant=False),
                         q, k, v, do)
    assert len(calls) == 3  # the plain run's, then the checkpointed forward and its recompute
    for a, b in zip(remat, got):
        assert torch.equal(a, b)


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
