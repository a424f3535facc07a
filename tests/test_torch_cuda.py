"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card: the three fused serving sublayers, the four flash-attention kernels
and, at the end of the file, the train step's optimizer pass (the
gradients' sum of squares and the fused clip, Adam and EMA: bit-equal to
the eager loop given the same norm). Run there with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` imports jax, which the card's
machine lacks). This file imports no jax. Each test skips in its body when
no CUDA device is present.

Shapes: the main path's (B=1, T=100, L=4, C=384, 16 heads, hidden 1536),
plus the edges of the model's gates (L=16 and L=3 residues, T=1024 frames)
and a batch of 2 with a masked residue; token counts that are no multiple of
the 32-token tiles of the fused kernels (4 tokens; B=3, T=37; L = 1 and 7);
and for the frame kernel (2) the edges of its 64-frame tiles (T = 1, 63, 64,
65, 129), head widths 8, 32 and 64 (48, 12 and 6 heads at C = 384), and a
batch entry whose residues are all masked. All must be bit-deterministic.

Tolerances: f32 1e-4 (the same f32 operands, sums of 384..1536 products
taken in another order, |y| up to ~10); bf16 operands 1e-2 (both versions
round the same values to bf16, but a value that lands next to a rounding
boundary can round the other way in one of them: one bf16 ulp of an
operand is 2^-8 of it).
"""
import functools
import importlib
import math

import numpy as np
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


def _inputs(B, T, L, dt, seed=0, all_masked=False):
    """x f32; parameters and adaLN chunks in ``dt``, as after the serving cast;
    the last residue of the last batch entry masked (with ``all_masked``,
    every residue of the first too)."""
    g = torch.Generator().manual_seed(seed)

    def f(*s, sc=1.0, dtype=dt):
        return (torch.randn(*s, generator=g) * sc).to(dtype).cuda()

    mask = torch.ones(B, L)
    mask[-1, -1] = 0.0
    if all_masked:
        mask[0] = 0.0
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
SHAPES = {"main": (1, 100, 4), "batch2": (2, 37, 4), "L16": (1, 20, 16), "L3": (2, 30, 3),
          "T1024": (1, 1024, 2), "tokens4": (1, 1, 4), "batch3": (3, 37, 4), "L1": (2, 20, 1),
          "L7": (2, 19, 7), "T1": (2, 1, 4), "T63": (1, 63, 4), "T64": (1, 64, 4),
          "T65": (2, 65, 3), "T129": (1, 129, 4), "hd8": (1, 100, 4), "hd32": (1, 100, 4),
          "hd64": (1, 100, 4), "all_masked": (2, 37, 4)}
# heads where not 16: the head widths 8, 32 and 64
HEADS = {"hd8": 48, "hd32": 12, "hd64": 6}
# the frame kernel's own edges (T1024, its gate, is only a batch size to the
# residue kernel)
FRAME_EDGES = ["T1024", "T1", "T63", "T64", "T65", "T129", "hd8", "hd32", "hd64", "all_masked"]
# the token-tile edges of the fused kernels (1-3)
EDGES = ["main", "tokens4", "batch3", "L1", "L7", "L16"]


def _check(y, ref, dt):
    torch.cuda.synchronize()
    assert y.shape == ref.shape and y.dtype == torch.float32
    assert torch.isfinite(y).all()
    err = (y - ref).abs().max().item()
    assert err <= TOL[dt], f"max abs err {err:.3e} > {TOL[dt]:g}"


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize(
    "kernel,shape", [(k, s) for k in ATTN for s in SHAPES if k == "t" or s not in FRAME_EDGES]
)
def test_attention_kernel_matches_plain(kernel, shape, dtype):
    _need_cuda()
    dt = DTYPES[dtype]
    a = _inputs(*SHAPES[shape], dt, all_masked=shape == "all_masked")
    fn, plain = ATTN[kernel]
    args = [a[n] for n in ATTN_ARGS]
    kw = dict(num_heads=HEADS.get(shape, H), compute_dtype=dt)
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
@pytest.mark.parametrize("shape", ["batch2", "L3"] + EDGES)
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


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", ["main", "batch3", "L7"])
@pytest.mark.parametrize("kernel", ["l", "t", "ffn"])
def test_tensor_core_kernels_are_deterministic(kernel, shape, dtype):
    """No sum crosses blocks (no atomics): two calls give the same bits."""
    _need_cuda()
    a = _inputs(*SHAPES[shape], DTYPES[dtype], seed=2)
    if kernel in ATTN:
        fn, args, kw = ATTN[kernel][0], [a[n] for n in ATTN_ARGS], dict(num_heads=H)
    else:
        fn, args, kw = ops.fused_ffn_sublayer, [a[n] for n in FFN_ARGS], {}
    kw["compute_dtype"] = DTYPES[dtype]
    y1, y2 = fn(*args, **kw), fn(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2)


def test_tensor_core_kernels_refuse_widths_off_16_bytes():
    """The fused kernels (1-3) copy rows 16 bytes at a time: C % 8 != 0
    raises (here with an even head width of 18, which the kernels take)."""
    _need_cuda()
    c = 36
    z = lambda *s: torch.zeros(*s, device="cuda")  # noqa: E731
    x, v = torch.randn(1, 2, 4, c, device="cuda"), z(1, 1, c)
    with pytest.raises(ValueError):
        ops.fused_ffn_sublayer(x, v, v, v, z(4 * c, c), z(4 * c), z(c, 4 * c), z(c),
                               compute_dtype=torch.float32)
    for fn, _ in ATTN.values():
        with pytest.raises(ValueError):
            fn(x, v, v, v, torch.ones(1, 4, device="cuda"), z(3 * c, c), z(3 * c), z(c), z(c),
               z(c, c), z(c), num_heads=2, compute_dtype=torch.float32)


def test_tensor_core_kernels_refuse_rows_off_16_bytes():
    """x and the weights are copied 16 bytes at a time: a view that starts
    4 bytes into its storage raises instead of being copied."""
    _need_cuda()
    a = _inputs(1, 8, 4, torch.float32)
    x = torch.empty(a["x"].numel() + 1, device="cuda")[1:].view_as(a["x"]).copy_(a["x"])
    with pytest.raises(ValueError, match="16-byte"):
        ops.fused_ffn_sublayer(x, *[a[n] for n in FFN_ARGS[1:]], compute_dtype=torch.float32)
    for fn, _ in ATTN.values():
        with pytest.raises(ValueError, match="16-byte"):
            fn(x, *[a[n] for n in ATTN_ARGS[1:]], num_heads=H, compute_dtype=torch.float32)


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
# ones (Tk not a multiple of the 64-row tile, d padded to 16 or 64), and the
# edges of the tensor-core kernels (4-7): Tq below one 16-row
# MMA tile, Tq and Tk one past two 64-row tiles, N = 1, d = 64, and d = 7
# (rows of no whole 16 bytes: loaded element by element, not by cp.async).
# Tolerances: o and lse absolute, gradients relative to their largest entry;
# f32 1e-4 / 1e-4 (sums of 1001 keys or 1000 queries in another order; split
# TF32 keeps them to about 2e-5), bf16 operands 1e-2 (outputs rounded to
# bf16, one ulp is 2^-8).

FLASH_SHAPES = {"recipe": (512, 1000, 1001, 24), "ragged": (2, 300, 301, 8),
                "single_tile": (3, 24, 25, 16), "d40": (2, 70, 65, 40),
                "tq5": (2, 5, 6, 24), "tile_plus_one": (2, 129, 129, 24), "n1": (1, 65, 200, 32),
                "d64": (2, 64, 64, 64), "d7": (2, 33, 70, 7)}
FLASH_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2)}


def _flash_inputs(N, Tq, Tk, d, dt, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(N, Tq, d, generator=g) * d**-0.5
    k, v = torch.randn(N, Tk, d, generator=g), torch.randn(N, Tk, d, generator=g)
    do = torch.randn(N, Tq, d, generator=g)
    mask = torch.ones(N, Tk)
    mask[:, Tk // 3: Tk // 2] = 0.0
    if N > 1:  # row 0: only the last (bias) key valid (its dq, dk, dbias are 0)
        mask[0, :-1] = 0.0
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


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", ["recipe", "tile_plus_one"])
@pytest.mark.parametrize("kernels", ["fwd", "fwd_lse", "bwd"])
def test_flash_backward_kernels_are_deterministic(kernels, shape, dtype):
    """Every flash kernel sums in a fixed order (no atomics): two calls on
    the same inputs give the same bits. Cases: kernel 4 (o), kernel 5 (o,
    lse), and the backward pair, kernels 6 and 7 (dq, dk, dv, dbias)."""
    _need_cuda()
    fa = importlib.import_module("mdgen_tpu_torch.ops.flash_attention")
    q, k, v, bias, do = _flash_inputs(*FLASH_SHAPES[shape], DTYPES[dtype], seed=3)
    if kernels == "fwd":
        run = lambda: (fa.flash_fwd(q, k, v, bias),)  # noqa: E731
    elif kernels == "fwd_lse":
        run = lambda: fa.flash_fwd_lse(q, k, v, bias)  # noqa: E731
    else:
        o, lse = fa.flash_attention_plain(q, k, v, bias)
        bwd = (q, k, v, bias, do, lse, fa.attention_delta(o, do))
        run = lambda: (fa.flash_bwd_dq(*bwd), *fa.flash_bwd_dkv(*bwd))  # noqa: E731
    first, second = run(), run()
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


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


def _task_model(**kw):
    """The 5 x 384 x 16 model of a task configuration on the card, seeded,
    with noise on the zero-init adaLN producers and head (as chip_smoke.py)."""
    from mdgen_tpu_torch.config import MDGenConfig
    from mdgen_tpu_torch.models import LatentMDGenModel

    cfg = MDGenConfig(prepend_ipa=True, abs_pos_emb=True, abs_time_emb=True, crop=4, **kw)
    g = torch.Generator().manual_seed(0)
    model = LatentMDGenModel(cfg, cfg.latent_dim).reset_parameters(g)
    lins = [model.trunk_adaln, model.ipa_adaln]
    if hasattr(model, "emb_to_latent"):  # the mpnn modes have no latent head
        lins += [model.emb_to_latent.dense_0, model.emb_to_latent.dense_1]
    with torch.no_grad():
        for lin in lins:
            lin.weight.add_(torch.randn(lin.weight.shape, generator=g) * 0.05)
    return cfg, model.state_dict()


def _fused_vs_dense(cfg, state_dict, tok):
    """One forward of the fused and the dense model on the same inputs, f32;
    returns (fused, dense, {fused: its forward's launch counts})."""
    from mdgen_tpu_torch.models import LatentMDGenModel
    from mdgen_tpu_torch.tasks import prep_batch

    kwargs = prep_batch(cfg, tok).model_kwargs
    B, T, L = kwargs["mask"].shape
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(B, T, L, cfg.latent_dim, device="cuda", generator=g)
    t = torch.full((B,), 0.4, device="cuda")
    outs = {}
    for fused in (True, False):
        model = LatentMDGenModel(cfg.replace(fused_block=fused), cfg.latent_dim)
        model.load_state_dict(state_dict)
        before = ops.launch_counts()
        with torch.inference_mode():
            outs[fused] = model.cuda().eval()(x, t, **kwargs)
        after = ops.launch_counts()
        outs[fused, "launches"] = {k: after[k] - before[k] for k in after}
    return outs[True], outs[False], {f: outs[f, "launches"] for f in (True, False)}


def test_tps_forward_fused_matches_dense_on_the_card():
    """The TPS model (both IPA streams) at full width, T = 100: kernels 1-3
    against the dense path, 1e-4 relative to max(|out|, 1)."""
    _need_cuda()
    from mdgen_tpu_torch.data import synthetic_trajectory
    from mdgen_tpu_torch.geometry import constants as rc
    from mdgen_tpu_torch.runtime import tokenize_atom14

    cfg, sd = _task_model(tps_condition=True, num_frames=100)
    traj = torch.from_numpy(synthetic_trajectory("ACDE", 30, seed=0)).float()
    atom14 = traj[3][None, None].repeat(1, 100, 1, 1, 1)
    atom14[:, -1] = traj[27]
    tok = tokenize_atom14({"atom14": atom14.cuda(), "mask": torch.ones(1, 4, device="cuda"),
                           "seqres": torch.from_numpy(rc.str_sequence_to_aatype("ACDE")[None])
                           .long().cuda()})
    fused, dense, launches = _fused_vs_dense(cfg, sd, tok)
    assert launches[True]["fused_l_sublayer"] == launches[True]["fused_ffn_sublayer"] == 5
    assert launches[True]["fused_t_sublayer"] == 5 and not any(launches[False].values())
    scale = max(dense.abs().max().item(), 1.0)
    assert torch.isfinite(fused).all() and (fused - dense).abs().max().item() <= 1e-4 * scale


def test_upsampling_window_fused_matches_dense_on_the_card():
    """One upsampling window of the reference recipe (T = 1000, cond_interval
    100: 10 kept frames, identity frames between them) at full width: the
    fused path (kernel 2 at T = 1000) against the dense one, whose frame
    attention takes flash kernel 4 (1001 keys); 1e-4 relative to
    max(|out|, 1)."""
    _need_cuda()
    import numpy as np

    from mdgen_tpu_torch.data import synthetic_trajectory
    from mdgen_tpu_torch.geometry import constants as rc
    from mdgen_tpu_torch.runtime import tokenize_atom14
    from mdgen_tpu_torch.tasks import build_upsampling_windows

    cfg, sd = _task_model(sim_condition=True, cond_interval=100, num_frames=1000)
    kept = torch.from_numpy(synthetic_trajectory("ACDE", 10, seed=0)).float()[None]
    tok = tokenize_atom14({"atom14": kept.cuda(), "mask": torch.ones(1, 4, device="cuda"),
                           "seqres": torch.from_numpy(rc.str_sequence_to_aatype("ACDE")[None])
                           .long().cuda()})
    (window,) = build_upsampling_windows({k: v[0].cpu().numpy() for k, v in tok.items()},
                                         1000, 100)
    win = {k: torch.from_numpy(np.asarray(v)[None]).cuda() for k, v in window.items()}
    win["seqres"] = win["seqres"].long()
    fused, dense, launches = _fused_vs_dense(cfg, sd, win)
    assert launches[True]["fused_t_sublayer"] == 5 and launches[True]["flash_fwd"] == 0
    assert launches[False]["flash_fwd"] == 5 and launches[False]["fused_t_sublayer"] == 0
    scale = max(dense.abs().max().item(), 1.0)
    assert torch.isfinite(fused).all() and (fused - dense).abs().max().item() <= 1e-4 * scale


DESIGN_MODES = {"design": dict(inpainting=True, no_aa_emb=True, no_torsion=True),
                "mpnn": dict(sim_condition=True, mpnn=True),
                "dynamic_mpnn": dict(inpainting=True, dynamic_mpnn=True)}


@pytest.mark.parametrize("mode", list(DESIGN_MODES))
def test_design_forward_fused_matches_dense_on_the_card(mode):
    """The design recipe and the two mpnn modes at full width on two windows
    of T = 100 frames (the mpnn modes keep the first frame, or the first and
    last: kernel 2 at T = 1 and 2): kernels 1-3 against the dense path, 1e-4
    relative to max(|out|, 1)."""
    _need_cuda()
    import numpy as np

    from mdgen_tpu_torch.data import synthetic_trajectory
    from mdgen_tpu_torch.geometry import constants as rc
    from mdgen_tpu_torch.runtime import tokenize_atom14

    cfg, sd = _task_model(design=True, num_frames=100, **DESIGN_MODES[mode])
    traj = synthetic_trajectory("ACDE", 102, seed=0)
    tok = tokenize_atom14({"atom14": torch.from_numpy(np.stack([traj[:100], traj[2:]])).float()
                           .cuda(), "mask": torch.ones(2, 4, device="cuda"),
                           "seqres": torch.from_numpy(rc.str_sequence_to_aatype("ACDE")[None])
                           .long().cuda().expand(2, 4)})
    fused, dense, launches = _fused_vs_dense(cfg, sd, tok)
    assert fused.shape == ((2, 100, 4, 48) if mode == "design" else (2, 1, 4, 20))
    assert all(launches[True][k] == 5 for k in
               ("fused_l_sublayer", "fused_t_sublayer", "fused_ffn_sublayer"))
    assert not any(launches[False].values())
    scale = max(dense.abs().max().item(), 1.0)
    assert torch.isfinite(fused).all() and (fused - dense).abs().max().item() <= 1e-4 * scale


# -- tensor and sequence parallelism on one card -------------------------------

GRID_FRAMES = 520  # 521 keys: the frame attention takes the flash kernels


@pytest.mark.parametrize("grid", ["tp", "sp"])
def test_two_gloo_ranks_on_one_card_train_as_one_rank(grid, tmp_path):
    """`python -m mdgen_tpu_torch.train --device cuda:0 --dist_backend gloo`
    with --tp_size 2 (each rank 2 of the 4 heads, kernels 5-7 on them) or
    --sp_size 2 (each rank 260 of the frames, the frame attention dense)
    against one rank: 2 steps of a 2-layer model at T = 520, losses and grad
    norms within 1e-5 relative (f32 sums in another order)."""
    _need_cuda()
    import json
    import os
    import subprocess
    import sys

    import numpy as np

    from mdgen_tpu_torch.data import synthetic_trajectory

    seqs = ("ACDE", "FGHI")
    for i, s in enumerate(seqs):
        np.save(tmp_path / f"{s}.npy", synthetic_trajectory(s, GRID_FRAMES, seed=i))
    (tmp_path / "split.csv").write_text("name,seqres\n" + "".join(f"{s},{s}\n" for s in seqs))
    base = [sys.executable, "-m", "mdgen_tpu_torch.train", "--sim_condition", "--prepend_ipa",
            "--abs_pos_emb", "--abs_time_emb", "--crop", "4", "--num_frames", str(GRID_FRAMES),
            "--num_layers", "2", "--embed_dim", "64", "--mha_heads", "4", "--batch_size", "2",
            "--epochs", "2", "--no_validate", "--ckpt_freq", "100", "--train_split",
            str(tmp_path / "split.csv"), "--val_split", str(tmp_path / "split.csv"),
            "--data_dir", str(tmp_path), "--workdir", str(tmp_path), "--dp_size", "1"]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    for name, flags in (("one", ["--device", "cuda"]),
                        ("grid", ["--device", "cuda:0", "--dist_backend", "gloo",
                                  f"--{grid}_size", "2"])):
        proc = subprocess.run([*base, *flags, "--run_name", name, "--record",
                               str(tmp_path / f"{name}.{{rank}}.json")], env=env,
                              capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    one = json.loads((tmp_path / "one.0.json").read_text())
    for r in range(2):
        rec = json.loads((tmp_path / f"grid.{r}.json").read_text())
        np.testing.assert_allclose(rec["losses"], one["losses"], rtol=1e-5)
        np.testing.assert_allclose(rec["grad_norms"], one["grad_norms"], rtol=1e-5)
        flash = 2 * 2 if grid == "tp" else 0  # layers x steps
        assert rec["launches"]["flash_fwd_lse"] == rec["launches"]["flash_bwd_dkv"] == flash
    assert one["launches"]["flash_fwd_lse"] == 2 * 2


_OTHER_CARD = r"""
import importlib, json, sys
import torch
sys.path.insert(0, sys.argv[1])
import test_torch_cuda as t
from mdgen_tpu_torch import ops
fa = importlib.import_module("mdgen_tpu_torch.ops.flash_attention")

dev, dt = torch.device("cuda:1"), torch.float32
a = {k: v.to(dev) for k, v in t._inputs(*t.SHAPES["main"], dt).items()}
errs = {}
for name, (fn, plain) in t.ATTN.items():
    args = [a[n] for n in t.ATTN_ARGS]
    errs[name] = (fn(*args, num_heads=t.H, compute_dtype=dt)
                  - plain(*args, num_heads=t.H, compute_dtype=dt)).abs().max().item()
args = [a[n] for n in t.FFN_ARGS]
errs["ffn"] = (ops.fused_ffn_sublayer(*args, compute_dtype=dt)
               - ops.fused_ffn_sublayer_plain(*args, compute_dtype=dt)).abs().max().item()
q, k, v, bias, do = [x.to(dev) for x in t._flash_inputs(*t.FLASH_SHAPES["recipe"], dt)]
o_ref, lse_ref = fa.flash_attention_plain(q, k, v, bias)
bwd = (q, k, v, bias, do, lse_ref, fa.attention_delta(o_ref, do))
errs["flash_fwd"] = (fa.flash_fwd(q, k, v, bias) - o_ref).abs().max().item()
errs["flash_fwd_lse"] = (fa.flash_fwd_lse(q, k, v, bias)[1] - lse_ref).abs().max().item()
errs["flash_bwd_dq"] = t._rel_max(fa.flash_bwd_dq(*bwd), fa.flash_bwd_dq_plain(*bwd))
errs["flash_bwd_dkv"] = t._rel_max(fa.flash_bwd_dkv(*bwd)[0], fa.flash_bwd_dkv_plain(*bwd)[0])
rows = t._opt_rows([(384, 384), (4097,), (3,)], True, dev)
ref = [[x.clone() for x in r] for r in rows]
norm = ops.sum_of_squares(rows[1], root=True)
ops.fused_adam(*rows, norm, **t._opt_kw(1, 1.0, True))
ops.fused_adam_plain(*ref, norm, **t._opt_kw(1, 1.0, True))
errs["sum_of_squares"] = abs(norm.item() / ops.sum_of_squares_plain(rows[1], True).item() - 1)
errs["fused_adam"] = max((x - y).abs().max().item() for got, want in zip(rows, ref)
                         for x, y in zip(got, want))
torch.cuda.synchronize(dev)
print(json.dumps({"current": torch.cuda.current_device(), "errs": errs,
                  "launches": ops.launch_counts()}))
"""


def test_kernels_run_on_the_card_of_their_operands():
    """A process whose tensors live on ``cuda:1`` and which never set its
    device (``tps_inference --device cuda:1``: ``cuda:0`` stays current):
    each of the nine kernels, first launched there, matches its plain twin
    at the main path's and the training recipe's shapes (the optimizer's on
    three tensors), once each, and the current device stays ``cuda:0``. Before the wrappers made the operands'
    card current, the kernels launched on ``cuda:0`` and the fused sampling
    of a checkpoint on ``cuda:1-3`` failed."""
    _need_cuda()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    import json
    import os
    import subprocess
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.dirname(here))
    proc = subprocess.run([sys.executable, "-c", _OTHER_CARD, here], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["current"] == 0
    assert all(n == 1 for n in out["launches"].values()), out["launches"]
    for name, err in out["errs"].items():  # f32: TOL and FLASH_TOL are both 1e-4
        assert err <= TOL[torch.float32], (name, err)


# -- the optimizer pass (csrc/fused_adam.cu) -----------------------------------


@functools.lru_cache(maxsize=1)
def _model_shapes():
    """The 4AA model's parameter shapes (193 tensors, 34.15M elements), then
    tensors of 1, 3 and 4097 elements (off the 16-byte vectors)."""
    from mdgen_tpu_torch.config import MDGenConfig
    from mdgen_tpu_torch.models import LatentMDGenModel

    cfg = MDGenConfig(sim_condition=True, prepend_ipa=True, abs_pos_emb=True,
                      abs_time_emb=True, crop=4)
    model = LatentMDGenModel(cfg, cfg.latent_dim)
    return [tuple(p.shape) for p in model.parameters()] + [(1,), (3,), (4097,)]


def _opt_rows(shapes, ema, dev="cuda", seed=0, views=False):
    """[params, grads, mu, nu, ema or None] on the card, a state some steps
    in: random p, g, mu and EMA, a positive nu. With ``views`` each tensor
    of a row is a view at an odd offset of one buffer (4-byte aligned)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    sizes = [math.prod(s) for s in shapes]

    def row(scale, positive=False):
        if not views:
            ts = [torch.randn(s, generator=gen, device=dev) * scale for s in shapes]
            return [t.abs() for t in ts] if positive else ts
        buf = torch.randn(sum(sizes) + 2 * len(sizes), generator=gen, device=dev) * scale
        buf = buf.abs() if positive else buf
        offsets = np.cumsum([1] + [n + 2 for n in sizes[:-1]])
        return [buf[o:o + n].view(s) for o, n, s in zip(offsets, sizes, shapes)]

    p = row(0.05)
    e = [x + y for x, y in zip(p, row(1e-3))] if ema else None
    return [p, row(1e-3), row(1e-3), row(1e-6, positive=True), e]


def _opt_kw(count, clip, adamw, ema_decay=0.999):
    return dict(count=count, lr=1e-4, grad_clip=clip, b1=0.9, b2=0.999, eps=1e-8,
                weight_decay=1e-4 if adamw else 0.0, ema_decay=ema_decay)


def _opt_launches():
    return ops.sum_of_squares.launches, ops.fused_adam.launches


def _same(rows, ref):
    """Names of the rows (p, g, mu, nu, ema) where a tensor differs in a bit."""
    names = ("p", "g", "mu", "nu", "ema")
    return [n for n, r, q in zip(names, rows, ref) if r is not None
            and not all(torch.equal(a, b) for a, b in zip(r, q))]


def _check_opt_steps(rows, clipped, adamw, per_step):
    """Two steps of the kernels against the eager loop from copies of the
    same state: given the kernel's norm, every p, mu, nu and EMA bit-equal;
    the norm within 1e-6 of the loop's and equal to itself bit for bit;
    ``per_step`` launches of each kernel a step."""
    ref = [None if r is None else [t.clone() for t in r] for r in rows]
    gen = torch.Generator(device="cuda").manual_seed(7)
    for count in (1, 2):
        if count == 2:  # new gradients
            for g, h in zip(rows[1], ref[1]):
                h.copy_(g.copy_(torch.randn(g.shape, generator=gen, device="cuda") * 1e-3))
        before = _opt_launches()
        norm = ops.sum_of_squares(rows[1], root=True)
        again = ops.sum_of_squares(rows[1], root=True)
        plain = ops.sum_of_squares_plain(rows[1], root=True)
        torch.cuda.synchronize()
        assert torch.equal(norm, again), (norm.item(), again.item())
        assert abs(norm.item() - plain.item()) <= 1e-6 * plain.item(), (norm.item(), plain.item())
        clip = norm.item() / 2 if clipped else norm.item() * 2
        ops.fused_adam(*rows, norm, **_opt_kw(count, clip, adamw))
        ops.fused_adam_plain(*ref, norm, **_opt_kw(count, clip, adamw))
        torch.cuda.synchronize()
        assert _opt_launches() == (before[0] + 2 * per_step, before[1] + per_step)
        assert not _same(rows, ref), f"step {count}: {_same(rows, ref)} differ"


@pytest.mark.parametrize("ema", [True, False], ids=["ema", "no_ema"])
@pytest.mark.parametrize("adamw", [False, True], ids=["adam", "adamw"])
@pytest.mark.parametrize("clipped", [True, False], ids=["clipped", "unclipped"])
def test_optimizer_kernels_match_plain(clipped, adamw, ema):
    """At the 4AA model's 193 tensors and 1, 3 and 4097 elements: the clip
    engaged (norm twice the clip) or not, Adam or AdamW, with an EMA or
    without; one launch of each kernel a step (``_check_opt_steps``)."""
    _need_cuda()
    _check_opt_steps(_opt_rows(_model_shapes(), ema), clipped, adamw, per_step=1)


@pytest.mark.parametrize("case", ["views", "many"])
def test_optimizer_kernels_off_the_vectors_and_past_one_table(case):
    """``views``: the model's tensors at odd offsets of one buffer, so no
    tensor takes the 16-byte path; ``many``: 600 tensors of 1 to 5000
    elements and some of none, three tables of at most 256 (CUDA 12.1's
    kernel parameters): three launches of each kernel a step."""
    _need_cuda()
    if case == "views":
        rows, per_step = _opt_rows(_model_shapes(), True, views=True), 1
    else:
        sizes = np.random.default_rng(0).integers(0, 5000, 600)
        rows = _opt_rows([(int(n),) for n in sizes], True)
        per_step = -(-int((sizes > 0).sum()) // ops.fused_optim.max_tensors())
        assert per_step >= 3 or ops.fused_optim.max_tensors() < 256
    _check_opt_steps(rows, True, True, per_step)


def test_optimizer_kernels_refuse_what_they_do_not_take():
    """A CUDA tensor that is not float32, not contiguous or on another
    device raises; nothing falls back to the eager loop."""
    _need_cuda()
    rows = _opt_rows([(64, 64), (5,)], True)
    norm = ops.sum_of_squares(rows[1], root=True)
    kw = _opt_kw(1, 1.0, False)
    before = _opt_launches()
    bad = {"bf16 grad": lambda r: r[1].__setitem__(0, r[1][0].bfloat16()),
           "strided grad": lambda r: r[1].__setitem__(0, r[1][0].t()),
           "cpu mu": lambda r: r[2].__setitem__(1, r[2][1].cpu())}
    for name, spoil in bad.items():
        r = [list(x) for x in rows]
        spoil(r)
        with pytest.raises(ValueError):
            ops.fused_adam(*r, norm, **kw)
        if name != "cpu mu":
            with pytest.raises(ValueError):
                ops.sum_of_squares(r[1])
    with pytest.raises(ValueError):
        ops.fused_adam(*rows, norm.cpu(), **kw)
    assert _opt_launches() == before


def test_optimizer_phase_never_waits_for_the_card(monkeypatch):
    """A train step's optimizer phase (span ``train.optimizer``: the norm,
    the clip, Adam and the EMA) under ``set_sync_debug_mode("error")``: no
    host read of the card and no synchronous copy, one launch of each
    kernel, and ``grad_norm`` a device tensor."""
    _need_cuda()
    from mdgen_tpu_torch.config import MDGenConfig
    from mdgen_tpu_torch.data import synthetic_trajectory
    from mdgen_tpu_torch.geometry import constants as rc
    from mdgen_tpu_torch.runtime import TrainRuntime, batch_to_device

    seqs = ("ACDE", "KLMW")
    cfg = MDGenConfig(num_layers=1, embed_dim=32, mha_heads=4, ipa_heads=2, ipa_head_dim=8,
                      ipa_qk=2, ipa_v=2, crop=4, batch_size=2, num_frames=6, sim_condition=True,
                      prepend_ipa=True, abs_pos_emb=True, abs_time_emb=True, ema=True)
    rt = TrainRuntime(cfg, "cuda")
    state = rt.init(torch.Generator().manual_seed(0))
    atom14 = np.stack([synthetic_trajectory(s, 6, seed=i) for i, s in enumerate(seqs)])
    batch = batch_to_device({"atom14": atom14.astype(np.float32),
                             "seqres": np.stack([rc.str_sequence_to_aatype(s) for s in seqs]),
                             "mask": np.ones((2, 4), np.float32)}, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    state, _ = rt.train_step(state, batch, gen)  # builds the kernels
    params, grads, metrics = rt._grads(state.model, batch, gen)
    monkeypatch.setattr(rt, "_grads", lambda *a, **k: (params, grads, dict(metrics)))
    ema_before = [e.clone() for e in state.ema.parameters()]
    before = _opt_launches()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, m = rt.train_step(state, batch, gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert _opt_launches() == (before[0] + 1, before[1] + 1)
    assert m["grad_norm"].device.type == "cuda" and state.opt_state["count"] == 2
    assert any(not torch.equal(a, b) for a, b in zip(state.ema.parameters(), ema_before))
