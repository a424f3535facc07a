"""Rotary multi-head self-attention (port of ``mdgen_tpu/models/attention.py``).

Semantics kept from the JAX module: one fused qkv projection; q scaled by
head_dim**-0.5 before RoPE; a learned bias key/value token appended at
position S (always attendable) and roped there; ESM rotary tables
([sin|sin] / [cos|cos] over the half-dim frequency grid); masked keys filled
with ``finfo(f32).min``; softmax in f32 with the probabilities cast back to
the compute dtype before P·V.

``impl`` picks the inner loop as the JAX module does: "dense" (einsum
logits), "chunked" (blockwise online softmax, ``ops.chunked_attention``),
"flash" (``ops.flash_attention``: the hand-written CUDA kernels on the GPU,
differentiable through their backward kernels) and "auto" (dense up to 512
keys, else flash). "flash" below 513 keys is dense too. The frame axis of
the 4AA training recipe (T=1000 frames, 1001 keys) takes flash.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .layers import dense

NEG_INF = torch.finfo(torch.float32).min
IMPLS = ("auto", "dense", "chunked", "flash")
FLASH_MIN_KEYS = 513  # dense wins below the logit-memory crossover


def resolve_impl(impl: str, num_keys: int) -> str:
    """The JAX module's choice of inner loop for ``num_keys`` keys."""
    if impl in ("auto", "flash"):
        return "flash" if num_keys >= FLASH_MIN_KEYS else "dense"
    return impl


def rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def rotary_tables(seq_len: int, dim: int, dtype=torch.float32, device=None):
    """ESM rotary tables: (sin, cos), each [seq_len, dim]."""
    inv_freq = 1.0 / (
        10000 ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim)
    )
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = t[:, None] * inv_freq[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.sin(emb).to(dtype), torch.cos(emb).to(dtype)


class RoPEAttention(nn.Module):
    """Self-attention over one axis of a (B, S, C) or (B, T, L, C) tensor;
    ``axis`` 1 attends over frames, 2 over residues."""

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

    def forward(self, x: torch.Tensor, mask=None, axis: int = -2):
        """x: [B, S, C] or [B, T, L, C]; mask matches x's leading shape with
        1 = valid key. Returns x's shape in the compute dtype."""
        squeeze = False
        if x.ndim == 3:
            x = x[:, None]
            mask = mask[:, None] if mask is not None else None
            axis, squeeze = 2, True
        else:
            axis = x.ndim + axis if axis < 0 else axis
            assert axis in (1, 2)

        B, T, L, C = x.shape
        H = self.num_heads
        hd = C // H
        S = x.shape[axis]

        qkv = dense(x, self.qkv_proj, self.dtype)
        q, k, v = qkv.chunk(3, dim=-1)
        q = (q * hd**-0.5).reshape(B, T, L, H, hd)
        k = k.reshape(B, T, L, H, hd)
        v = v.reshape(B, T, L, H, hd)

        shape = [B, T, L, H, hd]
        shape[axis] = 1
        k = torch.cat([k, self.bias_k.reshape(1, 1, 1, H, hd).to(k.dtype).expand(shape)], dim=axis)
        v = torch.cat([v, self.bias_v.reshape(1, 1, 1, H, hd).to(v.dtype).expand(shape)], dim=axis)
        if mask is not None:
            mshape = list(mask.shape)
            mshape[axis] = 1
            mask = torch.cat([mask, torch.ones(mshape, dtype=mask.dtype, device=mask.device)], dim=axis)

        if self.use_rope:
            sin, cos = rotary_tables(S + 1, hd, q.dtype, x.device)
            view = (1, -1, 1, 1, hd) if axis == 1 else (1, 1, -1, 1, hd)
            sin, cos = sin.reshape(view), cos.reshape(view)
            sl = [slice(None)] * 5
            sl[axis] = slice(0, S)
            q = q * cos[tuple(sl)] + rotate_half(q) * sin[tuple(sl)]
            k = k * cos + rotate_half(k) * sin

        impl = resolve_impl(self.impl, S + 1)
        if impl == "dense":
            out = self._dense_attention(q, k, v, mask, axis)
        else:
            out = self._folded_attention(q, k, v, mask, axis, impl)
        out = dense(out.reshape(B, T, L, C), self.out_proj, self.dtype)
        return out[:, 0] if squeeze else out

    @staticmethod
    def _dense_attention(q, k, v, mask, axis):
        """Einsum logits; the probabilities are cast to the compute dtype
        before P.V. Returns [B, T, L, H, hd]."""
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
        if axis == 2:
            return torch.einsum("bthqk,btkhd->btqhd", probs, v)
        return torch.einsum("blhqk,bklhd->bqlhd", probs, v)

    @staticmethod
    def _folded_attention(q, k, v, mask, axis, impl):
        """Fold (other axis, heads) into rows, [N, S, hd] with N = B*L*H for
        the frame axis, and run the flash or chunked inner loop. The key bias
        is 0 / finfo.min from the mask, row n reading mask row n // H.
        Returns [B, T, L, H, hd]."""
        from ..ops import chunked_attention, flash_attention

        fn = flash_attention if impl == "flash" else chunked_attention
        B, T, L, H, hd = q.shape
        S, S_k = q.shape[axis], k.shape[axis]
        # (B, T, L, H, hd) -> (B, other, H, S, hd)
        perm = (0, 2, 3, 1, 4) if axis == 1 else (0, 1, 3, 2, 4)
        qf, kf, vf = (t.permute(perm).reshape(-1, t.shape[axis], hd) for t in (q, k, v))
        if mask is None:
            mflat = torch.ones(qf.shape[0] // H, S_k, device=q.device)
        else:
            mflat = (mask.transpose(1, 2) if axis == 1 else mask).reshape(-1, S_k)
        bias = torch.where(mflat > 0, 0.0, NEG_INF).float().repeat_interleave(H, dim=0)
        out = fn(qf, kf, vf, bias)
        other = L if axis == 1 else T
        out = out.reshape(B, other, H, S, hd)
        return out.permute(0, 3, 1, 2, 4) if axis == 1 else out.permute(0, 1, 3, 2, 4)
