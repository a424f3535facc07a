"""Parity of the port's fused sublayers (their plain PyTorch versions, which
CPU tensors take) with the JAX package's kernels, run on the CPU both as the
Pallas body in interpret mode and as the JAX fallback.

Tolerances: f32 at rtol = atol = 2e-5, as the JAX package's own fused-vs-
module tests (the JAX fallback builds erf from A&S 7.1.26, |err| <= 1.5e-7,
inside that); bf16 operands at 0.05, the JAX package's bf16 tolerance (the
two frameworks round the same operands but sum in other orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdgen_tpu.ops.fused_block import fused_l_sublayer as jax_l
from mdgen_tpu.ops.fused_ffn import fused_ffn_sublayer as jax_ffn
from mdgen_tpu.ops.fused_t_block import fused_t_sublayer as jax_t
from mdgen_tpu_torch import ops

C, H = 64, 8


def _inputs(T, seed=0, B=2, L=4):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)  # noqa: E731
    mask = np.ones((B, L), np.float32)
    mask[1, -1] = 0.0  # one padded residue
    return dict(
        x=f(B, T, L, C), shift=f(B, 1, C, sc=0.1), scale=f(B, 1, C, sc=0.1),
        gate=f(B, 1, C, sc=0.5), mask=mask,
        qkv_w=f(C, 3 * C, sc=0.15), qkv_b=f(3 * C, sc=0.05),
        bias_k=f(C, sc=0.3), bias_v=f(C, sc=0.3),
        out_w=f(C, C, sc=0.15), out_b=f(C, sc=0.05),
        w1=f(C, 4 * C, sc=0.1), b1=f(4 * C, sc=0.05),
        w2=f(4 * C, C, sc=0.1), b2=f(C, sc=0.05),
    )


def _torch(a, transpose=False):
    return torch.from_numpy(np.ascontiguousarray(a.T if transpose else a))


ATTN = {"l": (jax_l, ops.fused_l_sublayer), "t": (jax_t, ops.fused_t_sublayer)}
CASES = {
    # name: (T, use_rope, dtype); T=70 is not a multiple of the 64-frame block
    "f32": (10, True, "f32"),
    "f32_tail": (70, True, "f32"),
    "no_rope": (10, False, "f32"),
    "bf16": (10, True, "bf16"),
}
_DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype):
    return 2e-5 if dtype == "f32" else 0.05


def _check_attention(kernel, a, heads, use_rope, dtype, interpret):
    """The port's sublayer (CPU: its plain twin) against the JAX kernel."""
    jdt, tdt = _DT[dtype]
    jax_fn, torch_fn = ATTN[kernel]
    names = ["x", "shift", "scale", "gate", "mask", "qkv_w", "qkv_b", "bias_k",
             "bias_v", "out_w", "out_b"]
    with jax.default_matmul_precision("highest"):
        y_jax = jax_fn(*[jnp.asarray(a[n]) for n in names], num_heads=heads,
                       use_rope=use_rope, compute_dtype=jdt, interpret=interpret)
    args = [_torch(a[n], transpose=n in ("qkv_w", "out_w")) for n in names]
    y = torch_fn(*args, num_heads=heads, use_rope=use_rope, compute_dtype=tdt)
    assert y.dtype == torch.float32 and y.shape == a["x"].shape
    tol = _tol(dtype)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_jax), rtol=tol, atol=tol)


@pytest.mark.parametrize("interpret", [False, True], ids=["fallback", "interpret"])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("kernel", list(ATTN))
def test_attention_sublayer_matches_jax(kernel, case, interpret):
    T, use_rope, dtype = CASES[case]
    _check_attention(kernel, _inputs(T), H, use_rope, dtype, interpret)


# the frame kernel's tile edges on the card, held here through its twin: T
# at one frame and one past one and two 64-frame tiles, a head width of 32
# (C = 64, H = 2), and a batch entry whose residues are all masked
FRAME_CASES = {
    # name: (T, heads, all residues of batch entry 0 masked)
    "T1": (1, H, False), "T65": (65, H, False), "T129": (129, H, False),
    "hd32": (10, 2, False), "all_masked": (10, H, True),
}


@pytest.mark.parametrize("interpret", [False, True], ids=["fallback", "interpret"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(FRAME_CASES))
def test_frame_sublayer_matches_jax_at_tile_edges(case, dtype, interpret):
    T, heads, all_masked = FRAME_CASES[case]
    a = _inputs(T, seed=2)
    if all_masked:
        a["mask"][0] = 0.0
    _check_attention("t", a, heads, True, dtype, interpret)


@pytest.mark.parametrize("interpret", [False, True], ids=["fallback", "interpret"])
@pytest.mark.parametrize("case", ["f32", "f32_tail", "bf16"])
def test_ffn_sublayer_matches_jax(case, interpret):
    T, _, dtype = CASES[case]
    jdt, tdt = _DT[dtype]
    a = _inputs(T, seed=1)
    names = ["x", "shift", "scale", "gate", "w1", "b1", "w2", "b2"]
    with jax.default_matmul_precision("highest"):
        y_jax = jax_ffn(*[jnp.asarray(a[n]) for n in names], compute_dtype=jdt,
                        interpret=interpret)
    args = [_torch(a[n], transpose=n in ("w1", "w2")) for n in names]
    y = ops.fused_ffn_sublayer(*args, compute_dtype=tdt)
    tol = _tol(dtype)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_jax), rtol=tol, atol=tol)


def test_masked_residue_attends_only_to_bias_token():
    """A residue with mask 0 has no valid frame key: in the frame sublayer
    its output depends on the bias value only, so it is the same for every
    frame when shift/scale/x do not enter the value path."""
    a = _inputs(10)
    names = ["x", "shift", "scale", "gate", "mask", "qkv_w", "qkv_b", "bias_k",
             "bias_v", "out_w", "out_b"]
    args = [_torch(a[n], transpose=n in ("qkv_w", "out_w")) for n in names]
    y = ops.fused_t_sublayer(*args, num_heads=H, compute_dtype=torch.float32)
    delta = (y - args[0])[1, :, -1] / args[3][1, 0]  # out_proj(attn) per frame
    torch.testing.assert_close(delta, delta[:1].expand_as(delta), rtol=1e-5, atol=1e-5)


def test_cpu_tensors_do_not_count_launches():
    ops.reset_launch_counts()
    a = _inputs(4)
    names = ["x", "shift", "scale", "gate", "w1", "b1", "w2", "b2"]
    ops.fused_ffn_sublayer(*[_torch(a[n], transpose=n in ("w1", "w2")) for n in names])
    q = torch.randn(2, 5, 8)
    ops.flash_attention(q, q, q, torch.zeros(2, 5))
    p = [torch.randn(3), torch.randn(2, 2)]
    norm = ops.sum_of_squares(p, root=True)
    ops.fused_adam(p, [t.clone() for t in p], [torch.zeros_like(t) for t in p],
                   [torch.zeros_like(t) for t in p], None, norm, count=1, lr=1e-3, grad_clip=1.0,
                   b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0, ema_decay=0.999)
    assert ops.launch_counts() == {
        "fused_l_sublayer": 0, "fused_t_sublayer": 0, "fused_ffn_sublayer": 0,
        "flash_fwd": 0, "flash_fwd_lse": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
        "sum_of_squares": 0, "fused_adam": 0,
    }
