"""Helpers shared by the kernels' wrappers: the fused sublayers' plain-PyTorch
math and the checks and argument packing of the CUDA wrappers."""
from __future__ import annotations

import functools

import torch

from ..models.attention import rotary_tables


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


@functools.lru_cache(maxsize=64)
def rope_tables(S: int, hd: int, device: torch.device):
    """f32 (sin, cos) [S, hd], cached per shape and device."""
    sin, cos = rotary_tables(S, hd, torch.float32, device)
    return sin.contiguous(), cos.contiguous()


# -- CUDA wrappers -------------------------------------------------------------


def on_cpu(x: torch.Tensor) -> bool:
    """The plain version serves CPU tensors; CUDA tensors take the kernel."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"fused sublayers run on CPU (plain) or CUDA, not {x.device}")
    return False


def refuse_grad(name: str, *tensors) -> None:
    """The fused sublayers are forward-only, as their JAX kernels are: their
    CUDA outputs are fresh tensors that no backward reaches. So they refuse
    to run where autograd would record them, on any device, instead of
    silently cutting the graph (the training model runs with
    ``fused_block=False``)."""
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


def stream_ptr() -> int:
    return torch.cuda.current_stream().cuda_stream
