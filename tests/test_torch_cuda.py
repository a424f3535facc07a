"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card: the three fused serving sublayers and the four flash-attention
kernels (at the end of the file). Run there with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` imports jax, which the card's
machine lacks). This file imports no jax. Each test skips in its body when
no CUDA device is present.

Shapes: the main path's (B=1, T=100, L=4, C=384, 16 heads, hidden 1536),
plus the edges of the model's gates (L=16 and L=3 residues, T=1024 frames)
and a batch of 2 with a masked residue.

Tolerances: f32 1e-4 (the same f32 operands, sums of 384..1536 products
taken in another order, |y| up to ~10); bf16 operands 1e-2 (both versions
round the same values to bf16, but a value that lands next to a rounding
boundary can round the other way in one of them: one bf16 ulp of an
operand is 2^-8 of it).
"""
import importlib

import pytest
import torch

from mdgen_tpu_torch import ops

pytestmark = pytest.mark.cuda

C, H = 384, 16
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _inputs(B, T, L, dt, seed=0):
    """x f32; parameters and adaLN chunks in ``dt``, as after the serving cast;
    the last residue of the last batch entry masked."""
    g = torch.Generator().manual_seed(seed)

    def f(*s, sc=1.0, dtype=dt):
        return (torch.randn(*s, generator=g) * sc).to(dtype).cuda()

    mask = torch.ones(B, L)
    mask[-1, -1] = 0.0
    return dict(
        x=f(B, T, L, C, dtype=torch.float32), shift=f(B, 1, C, sc=0.1),
        scale=f(B, 1, C, sc=0.1), gate=f(B, 1, C, sc=0.5), mask=mask.cuda(),
        qkv_w=f(3 * C, C, sc=C**-0.5), qkv_b=f(3 * C, sc=0.05), bias_k=f(C, sc=0.3),
        bias_v=f(C, sc=0.3), out_w=f(C, C, sc=C**-0.5), out_b=f(C, sc=0.05),
        w1=f(4 * C, C, sc=C**-0.5), b1=f(4 * C, sc=0.05),
        w2=f(C, 4 * C, sc=(4 * C) ** -0.5), b2=f(C, sc=0.05),
    )


ATTN_ARGS = ["x", "shift", "scale", "gate", "mask", "qkv_w", "qkv_b", "bias_k", "bias_v",
             "out_w", "out_b"]
FFN_ARGS = ["x", "shift", "scale", "gate", "w1", "b1", "w2", "b2"]
ATTN = {
    "l": (ops.fused_l_sublayer, ops.fused_l_sublayer_plain),
    "t": (ops.fused_t_sublayer, ops.fused_t_sublayer_plain),
}
# name: (B, T, L)
# (T1024, the frame kernel's gate, is only a batch size to the residue kernel)
SHAPES = {"main": (1, 100, 4), "batch2": (2, 37, 4), "L16": (1, 20, 16), "L3": (2, 30, 3),
          "T1024": (1, 1024, 2)}


def _check(y, ref, dt):
    torch.cuda.synchronize()
    assert y.shape == ref.shape and y.dtype == torch.float32
    assert torch.isfinite(y).all()
    err = (y - ref).abs().max().item()
    assert err <= TOL[dt], f"max abs err {err:.3e} > {TOL[dt]:g}"


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize(
    "kernel,shape", [(k, s) for k in ATTN for s in SHAPES if not (k == "l" and s == "T1024")]
)
def test_attention_kernel_matches_plain(kernel, shape, dtype):
    _need_cuda()
    B, T, L = SHAPES[shape]
    dt = DTYPES[dtype]
    a = _inputs(B, T, L, dt)
    fn, plain = ATTN[kernel]
    args = [a[n] for n in ATTN_ARGS]
    kw = dict(num_heads=H, compute_dtype=dt)
    before = fn.launches
    y = fn(*args, **kw)
    assert fn.launches == before + 1
    _check(y, plain(*args, **kw), dt)


@pytest.mark.parametrize("use_rope", [True, False], ids=["rope", "no_rope"])
@pytest.mark.parametrize("kernel", list(ATTN))
def test_attention_kernel_without_rope(kernel, use_rope):
    _need_cuda()
    a = _inputs(1, 100, 4, torch.float32, seed=1)
    fn, plain = ATTN[kernel]
    args = [a[n] for n in ATTN_ARGS]
    kw = dict(num_heads=H, use_rope=use_rope, compute_dtype=torch.float32)
    _check(fn(*args, **kw), plain(*args, **kw), torch.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", ["main", "batch2", "L3"])
def test_ffn_kernel_matches_plain(shape, dtype):
    _need_cuda()
    B, T, L = SHAPES[shape]
    dt = DTYPES[dtype]
    a = _inputs(B, T, L, dt)
    args = [a[n] for n in FFN_ARGS]
    before = ops.fused_ffn_sublayer.launches
    y = ops.fused_ffn_sublayer(*args, compute_dtype=dt)
    assert ops.fused_ffn_sublayer.launches == before + 1
    _check(y, ops.fused_ffn_sublayer_plain(*args, compute_dtype=dt), dt)


def test_kernels_refuse_what_they_do_not_take():
    """A CUDA tensor takes the kernel or raises; it never falls back."""
    _need_cuda()
    a = _inputs(1, 8, 4, torch.float32)
    args = [a[n] for n in ATTN_ARGS]
    with pytest.raises(ValueError):  # the residual stream must be f32
        ops.fused_l_sublayer(args[0].half(), *args[1:], num_heads=H)
    with pytest.raises(ValueError):  # and contiguous
        ops.fused_t_sublayer(args[0].transpose(1, 2), *args[1:], num_heads=H)
    with pytest.raises(ValueError):  # above the residue kernel's gate
        b = _inputs(1, 2, 17, torch.float32)
        ops.fused_l_sublayer(*[b[n] for n in ATTN_ARGS], num_heads=H)


# -- flash attention (kernels 4-7) ----------------------------------------------
#
# Each kernel against its plain twin on the same inputs; the backward kernels
# take the twin's (o, lse). Shapes: the training recipe's frame attention
# (N = 8 x 4 x 16 = 512 rows, Tq = 1000, Tk = 1001, d = 24) and ragged small
# ones (Tk not a multiple of the 64-row tile, d padded to 16 or 64).
# Tolerances: o and lse absolute, gradients relative to their largest entry;
# f32 1e-4 / 1e-3 (sums of 1001 keys or 1000 queries in another order), bf16
# operands 1e-2 (outputs rounded to bf16, one ulp is 2^-8).

FLASH_SHAPES = {"recipe": (512, 1000, 1001, 24), "ragged": (2, 300, 301, 8),
                "single_tile": (3, 24, 25, 16), "d40": (2, 70, 65, 40)}
FLASH_TOL = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (1e-2, 1e-2)}


def _flash_inputs(N, Tq, Tk, d, dt, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(N, Tq, d, generator=g) * d**-0.5
    k, v = torch.randn(N, Tk, d, generator=g), torch.randn(N, Tk, d, generator=g)
    do = torch.randn(N, Tq, d, generator=g)
    mask = torch.ones(N, Tk)
    mask[:, Tk // 3: Tk // 2] = 0.0
    mask[0, :-1] = 0.0  # only the last (bias) key valid
    bias = torch.where(mask > 0, 0.0, torch.finfo(torch.float32).min)
    return [t.to(dt).cuda() for t in (q, k, v)] + [bias.cuda(), do.to(dt).cuda()]


def _rel_max(a, ref):
    return ((a.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", list(FLASH_SHAPES))
def test_flash_kernels_match_plain(shape, dtype):
    _need_cuda()
    fa = importlib.import_module("mdgen_tpu_torch.ops.flash_attention")
    dt = DTYPES[dtype]
    q, k, v, bias, do = _flash_inputs(*FLASH_SHAPES[shape], dt)
    atol, rtol = FLASH_TOL[dt]
    o_ref, lse_ref = fa.flash_attention_plain(q, k, v, bias)
    delta = fa.attention_delta(o_ref, do)
    bwd = (q, k, v, bias, do, lse_ref, delta)
    before = ops.launch_counts()
    o4 = fa.flash_fwd(q, k, v, bias)
    o5, lse = fa.flash_fwd_lse(q, k, v, bias)
    dq = fa.flash_bwd_dq(*bwd)
    dk, dv, db = fa.flash_bwd_dkv(*bwd)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    for name in ("flash_fwd", "flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv"):
        assert after[name] == before[name] + 1, name
    assert o4.dtype == o5.dtype == dq.dtype == dk.dtype == dv.dtype == dt
    for o in (o4, o5):
        assert (o.float() - o_ref.float()).abs().max().item() <= atol
    assert (lse - lse_ref).abs().max().item() <= atol
    dq_r = fa.flash_bwd_dq_plain(*bwd)
    for got, ref in zip((dq, dk, dv, db), (dq_r, *fa.flash_bwd_dkv_plain(*bwd))):
        assert torch.isfinite(got).all()
        assert _rel_max(got, ref) <= rtol


def test_flash_autograd_matches_dense_on_the_card():
    """FlashAttention (kernels 5, 6, 7) against autograd through dense f32
    attention, gradients in q, k, v and bias; 1e-4 relative to the largest
    entry."""
    _need_cuda()
    q, k, v, bias, do = _flash_inputs(4, 600, 601, 24, torch.float32, seed=1)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v, bias)]
    before = ops.launch_counts()
    (ops.flash_attention(*leaves) * do).sum().backward()
    after = ops.launch_counts()
    assert [after[n] - before[n] for n in ("flash_fwd", "flash_fwd_lse", "flash_bwd_dq",
                                           "flash_bwd_dkv")] == [0, 1, 1, 1]
    ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v, bias)]
    rq, rk, rv, rb = ref_leaves
    p = torch.softmax(torch.einsum("nqd,nkd->nqk", rq, rk) + rb[:, None, :], dim=-1)
    (torch.einsum("nqk,nkd->nqd", p, rv) * do).sum().backward()
    for a, b in zip(leaves, ref_leaves):
        assert _rel_max(a.grad, b.grad) <= 1e-4


def test_flash_wrapper_refuses_what_it_does_not_take():
    _need_cuda()
    fa = importlib.import_module("mdgen_tpu_torch.ops.flash_attention")
    q, k, v, bias, _ = _flash_inputs(2, 40, 41, 24, torch.float32)
    with pytest.raises(ValueError, match="head dim"):  # d > 64
        big = torch.zeros(2, 40, 72, device="cuda")
        fa.flash_fwd(big, torch.zeros(2, 41, 72, device="cuda"),
                     torch.zeros(2, 41, 72, device="cuda"), bias)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_fwd(q.transpose(0, 1).contiguous().transpose(0, 1), k, v, bias)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_fwd(q.half(), k.half(), v.half(), bias)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_fwd(q.bfloat16(), k, v, bias)
    with pytest.raises(ValueError, match="bias must be float32"):
        fa.flash_fwd(q, k, v, bias.bfloat16())
    with pytest.raises(ValueError, match="must be on"):
        fa.flash_fwd(q, k, v, bias.cpu())


def test_fused_sublayers_refuse_autograd_on_the_card():
    _need_cuda()
    a = _inputs(1, 8, 4, torch.float32)
    w1 = a["w1"].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        ops.fused_ffn_sublayer(a["x"], a["shift"], a["scale"], a["gate"], w1, a["b1"], a["w2"],
                               a["b2"], compute_dtype=torch.float32)
