"""Helpers shared by the kernels' wrappers: the fused sublayers' plain-PyTorch
math, the rotary tables and masked-key fill that the kernels and
``models.attention`` share, and the checks and argument packing of the CUDA
wrappers."""
from __future__ import annotations

import functools

import torch
from torch.autograd import forward_ad

from . import _build

# a masked key's logit (and additive bias): finite, so a fully masked row
# never gives inf - inf
NEG_INF = torch.finfo(torch.float32).min


def exact_f32() -> None:
    """The plain versions are the kernels' reference: float32 sums stay full
    float32, never TF32 (matmul and cuDNN switches both off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def ln_modulate(x, shift, scale):
    """f32 no-affine LN (eps 1e-6, two-pass variance) then adaLN modulate.
    x [B, T, L, C]; shift/scale [B, 1, C]."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    ln = (xf - mu) * torch.rsqrt(var + 1e-6)
    return ln * (1.0 + scale.float()[:, None]) + shift.float()[:, None]


def rnd(t, dt):
    """Round to the compute dtype and widen back to f32."""
    return t.to(dt).float()


def mm(a, w, dt):
    """a @ w.T with both operands rounded to ``dt`` and f32 accumulation.
    ``w`` is in nn.Linear layout [out, in]."""
    return torch.matmul(rnd(a, dt), rnd(w, dt).t())


def rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


@functools.lru_cache(maxsize=64)
def rope_tables(S: int, hd: int, dtype: torch.dtype, device: torch.device):
    """ESM rotary tables (sin, cos), each [S, hd] ([sin|sin] / [cos|cos] over
    the half-dim frequency grid), computed in f32 and cast to ``dtype``;
    contiguous, cached per (S, hd, dtype, device) and shared by every
    caller, so read-only. Built outside inference mode: a table first made
    while sampling is later saved for backward by a train step."""
    with torch.inference_mode(False):
        inv_freq = 1.0 / (
            10000 ** (torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd)
        )
        t = torch.arange(S, dtype=torch.float32, device=device)
        freqs = t[:, None] * inv_freq[None, :]
        emb = torch.cat([freqs, freqs], dim=-1)
        return torch.sin(emb).to(dtype), torch.cos(emb).to(dtype)


# -- CUDA wrappers -------------------------------------------------------------


def on_cpu(x: torch.Tensor) -> bool:
    """The plain version serves CPU tensors; CUDA tensors take the kernel."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"the kernels run on CPU (plain) or CUDA, not {x.device}")
    return False


def tangent_probes(fc=None, fwd=forward_ad):
    """(interpreter peek, wrapped-tensor test) of ``torch._C._functorch``,
    resolved once, with ``forward_ad._current_level`` checked: a torch that
    renames any of these private internals fails here, when the ops are
    imported, rather than as an AttributeError inside every kernel call."""
    fc = torch._C._functorch if fc is None else fc
    peek = getattr(fc, "peek_interpreter_stack", None)
    wrapped = getattr(fc, "is_functorch_wrapped_tensor", None)
    if peek is None or wrapped is None or not isinstance(getattr(fwd, "_current_level", None),
                                                         int):
        raise ImportError(
            f"torch {torch.__version__} lacks torch._C._functorch.peek_interpreter_stack, "
            "torch._C._functorch.is_functorch_wrapped_tensor or "
            "torch.autograd.forward_ad._current_level, which the kernel wrappers read to "
            "refuse forward-mode AD (mdgen_tpu_torch.ops._common.refuse_tangent)"
        )
    return peek, wrapped


_PEEK_TRANSFORM, _IS_WRAPPED = tangent_probes()


def carries_tangent(*tensors) -> bool:
    """Whether any of ``tensors`` is under a ``torch.func`` transform or
    carries a ``forward_ad`` tangent. Two cheap checks first: no dual level
    and no transform active."""
    if forward_ad._current_level < 0 and _PEEK_TRANSFORM() is None:
        return False
    return any(isinstance(t, torch.Tensor) and (
        _IS_WRAPPED(t) or forward_ad.unpack_dual(t).tangent is not None) for t in tensors)


def refuse_tangent(name: str, *tensors) -> None:
    """No kernel has a forward-mode derivative: a kernel reads its inputs'
    storage and would drop a tangent (``torch.func.jvp`` runs without grad
    mode, so ``refuse_grad`` does not see it). So every wrapper refuses a
    tensor under a ``torch.func`` transform or carrying a ``forward_ad``
    tangent, on any device, as the CUDA path would."""
    if carries_tangent(*tensors):
        raise RuntimeError(
            f"{name} has no forward-mode derivative and refuses a tensor under a "
            "torch.func transform or with a forward-mode tangent; run the model on its "
            "dense route"
        )


def refuse_grad(name: str, *tensors) -> None:
    """The fused sublayers are forward-only, as their JAX kernels are: their
    CUDA outputs are fresh tensors that no backward reaches. So they refuse
    to run where autograd would record them, on any device, instead of
    silently cutting the graph (the training model runs with
    ``fused_block=False``), and refuse forward-mode AD (``refuse_tangent``)."""
    refuse_tangent(name, *tensors)
    if torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors
    ):
        raise RuntimeError(
            f"{name} is forward-only (no backward kernel) and refuses tensors that "
            "require grad; run it under torch.no_grad() or torch.inference_mode(), "
            "or build the model with fused_block=False"
        )


def check_x(x: torch.Tensor, name="x"):
    if x.dtype != torch.float32 or not x.is_contiguous() or x.ndim != 4:
        raise ValueError(f"{name} must be a contiguous float32 [B, T, L, C] tensor")


def weights(dt, *ws):
    """Big matrices in the compute dtype, contiguous, on x's device."""
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype must be float32 or bfloat16, got {dt}")
    return [w.to(dt).contiguous() for w in ws]


def check_aligned16(*ts: torch.Tensor) -> None:
    """The tensor-core kernels copy x and the weights to shared memory 16
    bytes at a time: each must start on a 16-byte boundary (a fresh
    allocation always does; an offset view may not)."""
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError("x and the weights must start on a 16-byte boundary")


def vectors(*vs):
    """Small vectors as one dtype the kernel takes: bf16 when all are bf16,
    else all widened to f32 (exact). Returns (is_bf16, tensors)."""
    if all(v.dtype == torch.bfloat16 for v in vs):
        return 1, [v.contiguous() for v in vs]
    return 0, [v.float().contiguous() for v in vs]


def same_device(x, *ts):
    for t in ts:
        if t.device != x.device:
            raise ValueError(f"all operands must be on {x.device}, got {t.device}")


def launch(fn_name: str, device: torch.device, *args) -> None:
    """Call the C entry point ``fn_name`` with ``args`` and the stream of
    ``device``, with ``device`` current: the kernels launch on the CUDA
    runtime's current device, which need not be the operands' (a process on
    ``cuda:1`` that never set its device runs with ``cuda:0`` current)."""
    with torch.cuda.device(device):
        _build.call(fn_name, *args, torch.cuda.current_stream(device).cuda_stream)
