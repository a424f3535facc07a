"""The short attention over the residue axis (``ops.short_attention``): its
plain twin in ``RoPEAttention``'s place against the module's dense route on
the CPU, forward and every gradient, and the rule that sends the residue
axis to its kernels on a CUDA device (``models.attention.short_route``).
The kernels themselves run on the card only (``tests/test_torch_cuda.py``).

Tolerance: 1e-5 of each tensor's largest entry. Both routes compute the same
f32 operations on the same operands (the twin repeats the dense route's
math from the packed projection), so they agree to float32 rounding.
"""
import pytest
import torch

from mdgen_tpu_torch import ops
from mdgen_tpu_torch.models import attention
from mdgen_tpu_torch.models.attention import RoPEAttention, short_route
from mdgen_tpu_torch.parallel import mesh

TOL = 1e-5

# (B, T, L, C, heads, tp, use_rope, masked keys, tower): L = 1, 4 and 16
# residues, masked keys (L = 1: every residue, so the bias key alone), RoPE
# off, the IPA tower's [B, L, C] call, and the heads narrowed to a rank's half
# as under tp = 2
CASES = {
    "L4": (2, 5, 4, 32, 4, 1, True, False, False),
    "L4_masked": (2, 5, 4, 32, 4, 1, True, True, False),
    "L1_masked": (2, 3, 1, 32, 4, 1, True, True, False),
    "L16_masked": (2, 3, 16, 48, 6, 1, True, True, False),
    "no_rope": (2, 5, 4, 32, 4, 1, False, True, False),
    "tower": (3, 1, 4, 32, 4, 1, True, True, True),
    "tp2": (2, 5, 4, 48, 6, 2, True, True, False),
}


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def _run(mod, x, mask, short, monkeypatch):
    """Output and gradients (x and every parameter) of one forward and
    backward of ``mod``, with the short route forced on or off."""
    monkeypatch.setattr(attention, "short_route", lambda *a: short)
    x = x.clone().requires_grad_(True)
    out = mod(x, mask) if x.ndim == 3 else mod(x, mask, axis=2)
    w = torch.randn(out.shape, generator=torch.Generator().manual_seed(7))
    params = [p for _, p in sorted(mod.named_parameters())]
    grads = torch.autograd.grad((out * w).sum(), [x] + params)
    return [out.detach(), *grads]


@pytest.mark.parametrize("case", list(CASES))
def test_twin_matches_the_dense_route(case, monkeypatch):
    B, T, L, C, H, tp, use_rope, masked, tower = CASES[case]
    g = torch.Generator().manual_seed(0)
    mod = RoPEAttention(C, H, use_rope=use_rope)
    mod.reset_parameters(g)
    with torch.no_grad():  # bias_k and bias_v draw small; make their terms count
        mod.qkv_proj.bias.normal_(generator=g)
    if tp > 1:  # this rank's heads, as parallel.mesh.shard_model keeps them
        axis = mesh.Axis(size=tp, index=1)
        specs = mesh.tp_specs(mod, tp)
        for name, p in list(mod.named_parameters()):
            if name in specs:
                p.data = mesh.shard_tensor(p.data, specs[name], axis)
        mod.tp = axis
        for name in ("copy_to", "reduce_from"):  # one rank alone: no collective
            monkeypatch.setattr(attention, name, lambda t, ax: t)
    x = torch.randn((B, L, C) if tower else (B, T, L, C), generator=g)
    mask = torch.ones(x.shape[:-1])
    if masked:
        mask[0, ..., -1] = 0.0
    dense = _run(mod, x, mask, False, monkeypatch)
    ops.reset_launch_counts()
    twin = _run(mod, x, mask, True, monkeypatch)
    assert ops.launch_counts()["short_attention"] == 0
    assert len(twin) == len(dense) == 2 + 6
    for i, (a, b) in enumerate(zip(twin, dense)):
        assert a.shape == b.shape and torch.isfinite(a).all(), i
        assert _rel(a, b) <= TOL, (i, _rel(a, b))


# (impl, keys with the bias key, head width, axis, cuda, dtype, dense_only) -> the kernels?
F32 = torch.float32
RULE = {
    "4aa_residue": (("auto", 5, 24, 2, True, F32, False), True),
    "gate": (("auto", ops.SHORT_ATTN_MAX_KEYS, 24, 2, True, F32, False), True),
    "flash_impl": (("flash", 5, 24, 2, True, F32, False), True),
    "widest_head": (("auto", 5, ops.SHORT_ATTN_MAX_HEAD_DIM, 2, True, F32, False), True),
    "past_gate": (("auto", ops.SHORT_ATTN_MAX_KEYS + 1, 24, 2, True, F32, False), False),
    "odd_head": (("auto", 5, 7, 2, True, F32, False), False),
    "past_widest_head": (("auto", 5, ops.SHORT_ATTN_MAX_HEAD_DIM + 2, 2, True, F32, False),
                         False),
    "cpu": (("auto", 5, 24, 2, False, F32, False), False),
    "bf16": (("auto", 5, 24, 2, True, torch.bfloat16, False), False),
    "frame_axis": (("auto", 9, 24, 1, True, F32, False), False),
    "dropout_or_tangent": (("auto", 5, 24, 2, True, F32, True), False),
    "dense_impl": (("dense", 5, 24, 2, True, F32, False), False),
    "chunked_impl": (("chunked", 5, 24, 2, True, F32, False), False),
}


@pytest.mark.parametrize("case", list(RULE))
def test_short_route_rule(case):
    """The residue axis of a CUDA float32 tensor with at most
    ``SHORT_ATTN_MAX_KEYS`` keys and an even head width up to
    ``SHORT_ATTN_MAX_HEAD_DIM`` takes the kernels under "auto" and "flash";
    the CPU, bf16, the frame axis, dropout or a tangent, and an explicit
    "dense" or "chunked" keep their routes."""
    args, want = RULE[case]
    assert short_route(*args) is want
    assert ops.SHORT_ATTN_MAX_KEYS == ops.FUSED_L_MAX_RESIDUES + 1 == 17
