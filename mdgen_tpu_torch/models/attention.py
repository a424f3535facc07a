"""Rotary multi-head self-attention (port of ``mdgen_tpu/models/attention.py``).

Semantics kept from the JAX module: one fused qkv projection; q scaled by
head_dim**-0.5 before RoPE; a learned bias key/value token appended at
position S (always attendable) and roped there; ESM rotary tables
(``ops.rope_tables``, cached, shared with the fused kernels); masked keys
filled with ``finfo(f32).min`` (``ops.NEG_INF``); softmax in f32 with the
probabilities cast back to the compute dtype before P·V.

``impl`` picks the inner loop: "dense" (einsum logits), "chunked"
(blockwise online softmax, ``ops.chunked_attention``), "flash"
(``ops.flash_attention``: the hand-written CUDA kernels on the GPU,
differentiable through their backward kernels) and "auto" (dense below a
crossover in keys, else flash; "flash" below it is dense too). Off CUDA the
crossover is the JAX module's, 513 keys, and the "flash" route is the
kernels' plain twin. On CUDA it is the H100's own, ``ops.CUDA_FLASH_MIN_KEYS``:
there the frame axis of the 4AA training recipe (T=1000 frames, 1001 keys)
and both axes of ATLAS (256 residues and 250 frames, 257 and 251 keys with
the bias key) take flash. The residue axis (axis 2, and the IPA tower's
[B, L, C] call) with at most ``ops.SHORT_ATTN_MAX_KEYS`` keys (the 4AA
recipe's 5) takes the short-attention kernels on CUDA in float32
(``ops.short_attention``, forward and backward from the packed projection,
``short_route``); in bf16 it stays dense.
Dropout on the probabilities (training with ``cfg.dropout > 0``: a
``layers.Dropout`` passed in) and frame keys gathered over sp force the
dense route on every device, as in JAX. So does forward-mode AD (a
``torch.func.jvp`` through the model, as the likelihood runs it), which the
kernels refuse, below the JAX module's 513 keys, where JAX is dense too;
from 513 keys the flash route refuses the tangent, as before.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .. import ops
from ..ops import (
    CUDA_FLASH_MIN_KEYS, NEG_INF, SHORT_ATTN_MAX_HEAD_DIM, SHORT_ATTN_MAX_KEYS, carries_tangent,
    rope_tables, rotate_half,
)
from ..parallel.distributed import copy_to, gather_along, reduce_from
from .layers import dense

IMPLS = ("auto", "dense", "chunked", "flash")
FLASH_MIN_KEYS = 513  # the JAX module's: dense wins below the TPU's logit-memory crossover


def resolve_impl(impl: str, num_keys: int, cuda: bool = False, dense_only: bool = False) -> str:
    """The inner loop for ``num_keys`` keys (the bias key included): "auto"
    and "flash" take flash from ``CUDA_FLASH_MIN_KEYS`` keys on a CUDA
    device, from the JAX module's ``FLASH_MIN_KEYS`` elsewhere, and dense
    below; ``dense_only`` (dropout, keys gathered over sp, a forward-mode
    tangent below ``FLASH_MIN_KEYS`` keys) forces dense."""
    if dense_only:
        return "dense"
    if impl in ("auto", "flash"):
        return "flash" if num_keys >= (CUDA_FLASH_MIN_KEYS if cuda else FLASH_MIN_KEYS) else "dense"
    return impl


def short_route(impl: str, num_keys: int, head_dim: int, axis: int, cuda: bool,
                dtype: torch.dtype, dense_only: bool = False) -> bool:
    """Whether the residue axis (``axis`` 2) takes the short-attention
    kernels (``ops.short_attention``): on a CUDA device, float32, "auto" or
    "flash", at most ``ops.SHORT_ATTN_MAX_KEYS`` keys with the bias key, an
    even head width up to ``ops.SHORT_ATTN_MAX_HEAD_DIM``, and no
    ``dense_only`` (dropout, a forward-mode tangent). Off CUDA every call
    keeps the JAX module's routes."""
    return (cuda and axis == 2 and not dense_only and impl in ("auto", "flash")
            and dtype == torch.float32 and num_keys <= SHORT_ATTN_MAX_KEYS
            and head_dim % 2 == 0 and head_dim <= SHORT_ATTN_MAX_HEAD_DIM)


class RoPEAttention(nn.Module):
    """Self-attention over one axis of a (B, S, C) or (B, T, L, C) tensor;
    ``axis`` 1 attends over frames, 2 over residues."""

    tp = None  # the tensor-parallel mesh axis when the heads are sharded

    def __init__(self, embed_dim: int, num_heads: int, use_rope: bool = True,
                 dtype: torch.dtype = torch.float32, impl: str = "auto"):
        super().__init__()
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.use_rope = use_rope
        self.dtype = dtype  # compute dtype
        self.impl = impl
        self.qkv_proj = nn.Linear(embed_dim, 3 * embed_dim)
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        self.bias_k = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.bias_v = nn.Parameter(torch.zeros(1, 1, embed_dim))

    def reset_parameters(self, generator=None):
        C = self.embed_dim
        # three independent xavier [C, C] blocks, as separate q/k/v layers
        bound = math.sqrt(6.0 / (2 * C))
        with torch.no_grad():
            self.qkv_proj.weight.uniform_(-bound, bound, generator=generator)
        nn.init.zeros_(self.qkv_proj.bias)
        nn.init.xavier_uniform_(self.out_proj.weight, generator=generator)
        nn.init.zeros_(self.out_proj.bias)
        std = math.sqrt(2.0 / (1 + C))
        for p in (self.bias_k, self.bias_v):
            nn.init.normal_(p, std=std, generator=generator)

    def forward(self, x: torch.Tensor, mask=None, axis: int = -2, drop=None, sp=None):
        """x: [B, S, C] or [B, T, L, C]; mask matches x's leading shape with
        1 = valid key; ``drop``: a ``layers.Dropout`` for the probabilities
        (training only). Returns x's shape in the compute dtype.

        ``sp`` (a mesh axis; trunk layers under sequence parallelism): x
        holds this rank's frames of T. The frame attention (axis 1)
        all-gathers the keys, the values and the key mask over sp, appends
        the bias key once, after the gathered keys, ropes the queries and
        keys at their global frame positions and runs dense, as JAX keeps
        the flash kernels off a sharded frame axis; the residue attention
        is local. ``self.tp`` (a mesh axis, set by ``parallel.mesh.shard_model``):
        this rank holds heads [i H/tp, (i + 1) H/tp) of ``qkv_proj``,
        ``bias_k`` and ``bias_v`` and the matching columns of ``out_proj``;
        the input's gradient and the output are all-reduced over tp."""
        squeeze = False
        if x.ndim == 3:
            x = x[:, None]
            mask = mask[:, None] if mask is not None else None
            axis, squeeze = 2, True
        else:
            axis = x.ndim + axis if axis < 0 else axis
            assert axis in (1, 2)

        B, T, L, _ = x.shape
        tp = self.tp
        H = self.num_heads // (1 if tp is None else tp.size)
        hd = self.embed_dim // self.num_heads

        qkv = dense(x if tp is None else copy_to(x, tp), self.qkv_proj, self.dtype)
        # the kernels have no forward-mode derivative: below the JAX module's
        # crossover a tangent takes the dense route; from it the kernels refuse it
        tangent = carries_tangent(x, self.qkv_proj.weight, self.bias_k, self.bias_v)
        if short_route(self.impl, L + 1, hd, axis, x.device.type == "cuda", qkv.dtype,
                       drop is not None or tangent):
            out = ops.short_attention(qkv, self.bias_k, self.bias_v, mask, num_heads=H,
                                      use_rope=self.use_rope)
        else:
            out = self._attention(qkv, mask, axis, drop, sp, H, hd, tangent)
        out = out.reshape(B, T, L, H * hd)
        if tp is None:
            out = dense(out, self.out_proj, self.dtype)
        else:
            dt = self.dtype or torch.float32
            out = reduce_from(F.linear(out.to(dt), self.out_proj.weight.to(dt)), tp) \
                + self.out_proj.bias.to(dt)
        return out[:, 0] if squeeze else out

    def _attention(self, qkv, mask, axis, drop, sp, H, hd, tangent):
        """The dense, chunked and flash routes from the packed projection:
        the bias key, RoPE, the inner loop (``tangent``: the input carries a
        forward-mode tangent). Returns [B, T, L, H, hd]."""
        B, T, L, _ = qkv.shape
        tp = self.tp
        q, k, v = qkv.chunk(3, dim=-1)
        q = (q * hd**-0.5).reshape(B, T, L, H, hd)
        k = k.reshape(B, T, L, H, hd)
        v = v.reshape(B, T, L, H, hd)

        # where this rank's queries sit among the one-process ones, and the
        # slices of the dropout masks it draws (layers.Dropout)
        q0, shards = 0, []
        if tp is not None:
            shards.append((2, tp.index * H, self.num_heads))
        gathered = sp is not None and sp.size > 1 and axis == 1
        if gathered:
            k, v = gather_along(k, 1, sp), gather_along(v, 1, sp)
            mask = gather_along(mask, 1, sp) if mask is not None else None
            q0 = sp.index * T
            shards.append((3, q0, T * sp.size))
        elif sp is not None and sp.size > 1:
            shards.append((1, sp.index * T, T * sp.size))
        S = k.shape[axis]

        shape = [B, T, L, H, hd]
        shape[axis] = 1
        k = torch.cat([k, self.bias_k.reshape(1, 1, 1, H, hd).to(k.dtype).expand(shape)], dim=axis)
        v = torch.cat([v, self.bias_v.reshape(1, 1, 1, H, hd).to(v.dtype).expand(shape)], dim=axis)
        if mask is not None:
            mshape = list(mask.shape)
            mshape[axis] = 1
            mask = torch.cat([mask, torch.ones(mshape, dtype=mask.dtype, device=mask.device)], dim=axis)

        if self.use_rope:
            sin, cos = rope_tables(S + 1, hd, q.dtype, qkv.device)
            view = (1, -1, 1, 1, hd) if axis == 1 else (1, 1, -1, 1, hd)
            sin, cos = sin.reshape(view), cos.reshape(view)
            sl = [slice(None)] * 5
            sl[axis] = slice(q0, q0 + q.shape[axis])
            q = q * cos[tuple(sl)] + rotate_half(q) * sin[tuple(sl)]
            k = k * cos + rotate_half(k) * sin

        dense_only = drop is not None or gathered or (S + 1 < FLASH_MIN_KEYS and tangent)
        impl = resolve_impl(self.impl, S + 1, qkv.device.type == "cuda", dense_only)
        if impl == "dense":
            return self._dense_attention(q, k, v, mask, axis, drop, shards)
        return self._folded_attention(q, k, v, mask, axis, impl)

    @staticmethod
    def _dense_attention(q, k, v, mask, axis, drop=None, shards=()):
        """Einsum logits; the probabilities are cast to the compute dtype
        (then dropped out by ``drop``, its mask sliced by ``shards``) before
        P.V. Returns [B, T, L, H, hd]."""
        if axis == 2:
            logits = torch.einsum("btqhd,btkhd->bthqk", q, k)
            key_mask = mask[:, :, None, None, :] if mask is not None else None
        else:
            logits = torch.einsum("bqlhd,bklhd->blhqk", q, k)
            key_mask = mask.transpose(1, 2)[:, :, None, None, :] if mask is not None else None
        logits = logits.float()
        if key_mask is not None:
            logits = torch.where(key_mask > 0, logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        if drop is not None:
            probs = drop(probs, shards)
        if axis == 2:
            return torch.einsum("bthqk,btkhd->btqhd", probs, v)
        return torch.einsum("blhqk,bklhd->bqlhd", probs, v)

    @staticmethod
    def _folded_attention(q, k, v, mask, axis, impl):
        """Fold (other axis, heads) into rows, [N, S, hd] with N = B*L*H for
        the frame axis, and run the flash or chunked inner loop. The key bias
        is 0 / finfo.min from the mask, row n reading mask row n // H.
        Returns [B, T, L, H, hd]."""
        fn = ops.flash_attention if impl == "flash" else ops.chunked_attention
        B, T, L, H, hd = q.shape
        S, S_k = q.shape[axis], k.shape[axis]
        # (B, T, L, H, hd) -> (B, other, H, S, hd)
        perm = (0, 2, 3, 1, 4) if axis == 1 else (0, 1, 3, 2, 4)
        # reshape copies unless (B, other, H) merge in place, as they do at
        # B = 1: the view it returns then is not contiguous, and the kernels
        # take contiguous rows
        qf, kf, vf = (t.permute(perm).reshape(-1, t.shape[axis], hd).contiguous()
                      for t in (q, k, v))
        if mask is None:
            mflat = torch.ones(qf.shape[0] // H, S_k, device=q.device)
        else:
            mflat = (mask.transpose(1, 2) if axis == 1 else mask).reshape(-1, S_k)
        bias = torch.where(mflat > 0, 0.0, NEG_INF).float().repeat_interleave(H, dim=0)
        out = fn(qf, kf, vf, bias)
        other = L if axis == 1 else T
        out = out.reshape(B, other, H, S, hd)
        return out.permute(0, 3, 1, 2, 4) if axis == 1 else out.permute(0, 1, 3, 2, 4)
