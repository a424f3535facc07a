"""Flash attention (port of ``mdgen_tpu/ops/flash_attention.py``).

Attention over ``[N, S, d]`` (N = batch x other axis x heads) with an
additive key bias (0, or ``finfo(f32).min`` for a masked key) and q already
scaled by ``d**-0.5``. The frame axis of the 4AA training recipe (T=1000
frames plus the bias token) takes this path; its dense logits would be
gigabytes.

Four hand-written CUDA kernels (``csrc/flash_attention.cu``), one per TPU
kernel, each behind a wrapper that counts its launches:

  * :func:`flash_fwd` -> o (kernel 4, the no-grad forward);
  * :func:`flash_fwd_lse` -> (o, lse) (kernel 5, the forward under autograd);
  * :func:`flash_bwd_dq` -> dq (kernel 6);
  * :func:`flash_bwd_dkv` -> (dk, dv, dbias) (kernel 7).

All four run on the tensor cores (``mma.sync``: bf16 operands as bf16, f32
operands as split TF32), with the probabilities kept in f32.

A CPU tensor takes the plain twin (:func:`flash_attention_plain`,
:func:`flash_attention_bwd_plain`, the FA2 formulas on dense logits); a
CUDA tensor takes the kernel or raises. :func:`flash_attention` dispatches
like the JAX ``custom_vjp``: under autograd it applies :class:`FlashAttention`
(kernel 5 forward, kernels 6 and 7 backward), otherwise kernel 4.
:func:`chunked_attention` is the JAX package's blockwise pure-array path,
differentiable by autograd.
"""
from __future__ import annotations

import torch

from ._common import NEG_INF, exact_f32, launch, on_cpu, refuse_tangent

MAX_HEAD_DIM = 64
# the H100's crossover in keys from dense attention to kernels 5-7, from
# tools/attn_crossover.py (forward plus backward, N = 4,000 rows of d = 24):
# the kernels beat the dense chain at every key count from 65 on in bf16 and
# f32 (0.9x of its time at 65, 0.2-0.4x at 257); below it their 64-key tiles
# run mostly empty (at 33 keys f32 ties, and at 5 keys and 4AA's 128,000 f32
# rows flash takes 2.8x)
CUDA_FLASH_MIN_KEYS = 65
_DTYPES = (torch.float32, torch.bfloat16)


# -- plain twins ---------------------------------------------------------------


def _logits(q, k, bias):
    return torch.einsum("nqd,nkd->nqk", q.float(), k.float()) + bias.float()[:, None, :]


def flash_attention_plain(q, k, v, bias):
    """(o [N, Tq, d] in q.dtype, lse [N, Tq] f32) on dense f32 logits."""
    exact_f32()
    s = _logits(q, k, bias)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("nqk,nkd->nqd", p, v.float()) / l
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def attention_delta(o, do):
    """delta = rowsum(dO * o) [N, Tq] f32, from o as rounded to its dtype."""
    return (do.float() * o.float()).sum(-1)


def _probs_ds(q, k, v, bias, do, lse, delta):
    """p = exp(s - lse) and ds = p (dO v^T - delta), [N, Tq, Tk] f32."""
    exact_f32()
    p = torch.exp(_logits(q, k, bias) - lse[..., None])
    ds = p * (torch.einsum("nqd,nkd->nqk", do.float(), v.float()) - delta[..., None])
    return p, ds


def flash_bwd_dq_plain(q, k, v, bias, do, lse, delta):
    """Kernel 6's math: dq = ds k, in q.dtype."""
    _, ds = _probs_ds(q, k, v, bias, do, lse, delta)
    return torch.einsum("nqk,nkd->nqd", ds, k.float()).to(q.dtype)


def _dkv(q, k, v, do, p, ds):
    dk = torch.einsum("nqk,nqd->nkd", ds, q.float())
    dv = torch.einsum("nqk,nqd->nkd", p, do.float())
    return dk.to(k.dtype), dv.to(v.dtype), ds.sum(1)


def flash_bwd_dkv_plain(q, k, v, bias, do, lse, delta):
    """Kernel 7's math: (dk = ds^T q, dv = p^T dO, dbias = sum_q ds)."""
    p, ds = _probs_ds(q, k, v, bias, do, lse, delta)
    return _dkv(q, k, v, do, p, ds)


def flash_attention_bwd_plain(q, k, v, bias, o, lse, do):
    """(dq, dk, dv in their inputs' dtypes, dbias [N, Tk] f32): the FA2
    recompute backward, p = exp(s - lse), ds = p (dO v^T - delta)."""
    p, ds = _probs_ds(q, k, v, bias, do, lse, attention_delta(o, do))
    dq = torch.einsum("nqk,nkd->nqd", ds, k.float()).to(q.dtype)
    return (dq, *_dkv(q, k, v, do, p, ds))


def chunked_attention(q, k, v, bias, block_k: int = 256):
    """The JAX package's blockwise path: online softmax over key blocks of
    ``block_k``, keys padded with zero k/v and bias finfo.min. Returns o in
    q.dtype; differentiable by autograd."""
    N, Tq, d = q.shape
    Tk = k.shape[1]
    bk = min(block_k, Tk)
    pad = -(-Tk // bk) * bk - Tk
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, pad))
    bf = torch.nn.functional.pad(bias.float(), (0, pad), value=NEG_INF)
    qf = q.float()
    m = torch.full((N, Tq, 1), NEG_INF, device=q.device)
    l = torch.zeros((N, Tq, 1), device=q.device)
    acc = torch.zeros((N, Tq, d), device=q.device)
    for j in range(0, Tk + pad, bk):
        s = torch.einsum("nqd,nkd->nqk", qf, kf[:, j:j + bk]) + bf[:, None, j:j + bk]
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        scale = torch.exp(m - m_new)
        l = l * scale + p.sum(-1, keepdim=True)
        acc = acc * scale + torch.einsum("nqk,nkd->nqd", p, vf[:, j:j + bk])
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


# -- CUDA wrappers -------------------------------------------------------------


def _check(q, k, v, bias, *rows):
    """q [N, Tq, d], k/v [N, Tk, d] (one dtype, f32 or bf16), bias [N, Tk] f32,
    and each of ``rows`` ([N, Tq] f32 or [N, Tq, d] in q's dtype), all
    contiguous on q's device, d <= 64. Returns (N, Tq, Tk, d)."""
    if q.ndim != 3 or k.ndim != 3:
        raise ValueError("flash attention takes q [N, Tq, d] and k, v [N, Tk, d]")
    N, Tq, d = q.shape
    Tk = k.shape[1]
    if k.shape != (N, Tk, d) or v.shape != (N, Tk, d) or bias.shape != (N, Tk):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"bias {tuple(bias.shape)} do not match")
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} is not in 1..{MAX_HEAD_DIM}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one dtype of {_DTYPES}, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if bias.dtype != torch.float32:
        raise ValueError(f"bias must be float32, got {bias.dtype}")
    for t in rows:
        want = (N, Tq) if t.ndim == 2 else (N, Tq, d)
        dt = torch.float32 if t.ndim == 2 else q.dtype
        if t.shape != want or t.dtype != dt:
            raise ValueError(f"expected {want} {dt}, got {tuple(t.shape)} {t.dtype}")
    for t in (q, k, v, bias, *rows):
        if t.device != q.device:
            raise ValueError(f"all operands must be on {q.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("flash attention takes contiguous tensors")
    return N, Tq, Tk, d


def _is_bf16(q) -> int:
    return int(q.dtype == torch.bfloat16)


def _fwd(fn, q, k, v, bias, with_lse: bool):
    N, Tq, Tk, d = _check(q, k, v, bias)
    o = torch.empty_like(q)
    lse = torch.empty((N, Tq), dtype=torch.float32, device=q.device) if with_lse else None
    if N and Tq:
        launch(
            "mdgen_flash_fwd", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            bias.data_ptr(), o.data_ptr(), lse.data_ptr() if with_lse else None, N, Tq, Tk, d,
            _is_bf16(q),
        )
        fn.launches += 1
    return o, lse


def flash_fwd(q, k, v, bias):
    """o = softmax(q k^T + bias) v in q.dtype (kernel 4)."""
    refuse_tangent("flash_fwd", q, k, v, bias)
    if on_cpu(q):
        return flash_attention_plain(q, k, v, bias)[0]
    return _fwd(flash_fwd, q, k, v, bias, with_lse=False)[0]


def flash_fwd_lse(q, k, v, bias):
    """(o in q.dtype, lse [N, Tq] f32) (kernel 5)."""
    refuse_tangent("flash_fwd_lse", q, k, v, bias)
    if on_cpu(q):
        return flash_attention_plain(q, k, v, bias)
    return _fwd(flash_fwd_lse, q, k, v, bias, with_lse=True)


def flash_bwd_dq(q, k, v, bias, do, lse, delta):
    """dq in q.dtype (kernel 6); ``delta`` from :func:`attention_delta`."""
    refuse_tangent("flash_bwd_dq", q, k, v, bias, do, lse, delta)
    if on_cpu(q):
        return flash_bwd_dq_plain(q, k, v, bias, do, lse, delta)
    N, Tq, Tk, d = _check(q, k, v, bias, do, lse, delta)
    dq = torch.empty_like(q)
    if N and Tq:
        launch(
            "mdgen_flash_bwd_dq", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            bias.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), N,
            Tq, Tk, d, _is_bf16(q),
        )
        flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, bias, do, lse, delta):
    """(dk, dv in k's dtype, dbias [N, Tk] f32) (kernel 7)."""
    refuse_tangent("flash_bwd_dkv", q, k, v, bias, do, lse, delta)
    if on_cpu(q):
        return flash_bwd_dkv_plain(q, k, v, bias, do, lse, delta)
    N, Tq, Tk, d = _check(q, k, v, bias, do, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    dbias = torch.empty((N, Tk), dtype=torch.float32, device=q.device)
    if N and Tk:
        launch(
            "mdgen_flash_bwd_dkv", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            bias.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), dbias.data_ptr(), N, Tq, Tk, d, _is_bf16(q),
        )
        flash_bwd_dkv.launches += 1
    return dk, dv, dbias


for _fn in (flash_fwd, flash_fwd_lse, flash_bwd_dq, flash_bwd_dkv):
    _fn.launches = 0


class FlashAttention(torch.autograd.Function):
    """The JAX ``_flash_vjp_blocked``: forward by kernel 5 saving (o, lse),
    backward by kernels 6 and 7 (delta = rowsum(dO o) between them)."""

    @staticmethod
    def forward(ctx, q, k, v, bias):
        o, lse = flash_fwd_lse(q, k, v, bias)
        ctx.save_for_backward(q, k, v, bias, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = attention_delta(o, do)
        dq = flash_bwd_dq(q, k, v, bias, do, lse, delta)
        dk, dv, dbias = flash_bwd_dkv(q, k, v, bias, do, lse, delta)
        return dq, dk, dv, dbias if ctx.needs_input_grad[3] else None


def flash_attention(q, k, v, bias):
    """o = softmax(q k^T + bias) v; differentiable in q, k, v and bias (by
    autograd; forward-mode AD is refused)."""
    refuse_tangent("flash_attention", q, k, v, bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, bias)):
        return FlashAttention.apply(q, k, v, bias)
    return flash_fwd(q, k, v, bias)
