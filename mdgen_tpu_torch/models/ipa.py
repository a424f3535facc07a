"""Invariant Point Attention with c_z = 0 (port of ``mdgen_tpu/models/ipa.py``).

Layout traps kept from the JAX module:
  * ``linear_qkv`` is split per head after reshaping to (..., H, 3*ch);
  * ``linear_points`` is reshaped to (H*(2Pq+Pv), 3), xyz innermost, and
    runs in f32 (point distances are numerically sensitive);
  * softplus head weights are scaled by sqrt(1/(3*Pq*9/2));
  * the frame-mask term is 1e5*(m2 - 1);
  * ``linear_out`` reads [o, o_pt x, o_pt y, o_pt z, |o_pt|];
  * dropout (training only, a ``layers.Dropout``) acts on the attention
    weights after the softmax and the cast to the input's dtype.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..geometry.rigid import Rigid
from .layers import dense, xavier_, zeros_

_POINT_WEIGHT_INIT = float(np.log(np.e - 1))  # softplus(x) == 1


def _promote(a, b):
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


class InvariantPointAttention(nn.Module):
    def __init__(self, c_s: int, c_hidden: int, no_heads: int, no_qk_points: int,
                 no_v_points: int, dtype: torch.dtype = torch.float32,
                 inf: float = 1e5, eps: float = 1e-8):
        super().__init__()
        self.c_hidden, self.no_heads = c_hidden, no_heads
        self.no_qk_points, self.no_v_points = no_qk_points, no_v_points
        self.dtype, self.inf, self.eps = dtype, inf, eps
        H, Pq, Pv = no_heads, no_qk_points, no_v_points
        self.linear_qkv = nn.Linear(c_s, 3 * H * c_hidden)
        self.linear_points = nn.Linear(c_s, H * (2 * Pq + Pv) * 3)
        self.head_weights = nn.Parameter(torch.full((H,), _POINT_WEIGHT_INIT))
        self.linear_out = nn.Linear(H * c_hidden + H * Pv * 4, c_s)

    def reset_parameters(self, generator=None):
        xavier_(self.linear_qkv, generator)
        xavier_(self.linear_points, generator)
        nn.init.constant_(self.head_weights, _POINT_WEIGHT_INIT)
        zeros_(self.linear_out)

    def forward(self, s: torch.Tensor, frames: Rigid, frame_mask=None, drop=None, shards=()):
        """s [..., L, C]; frames broadcastable to [..., L]; frame_mask [..., L];
        ``drop`` a ``layers.Dropout`` or None, its masks sliced by
        ``shards`` (a rank's frames of the weights [..., H, L, L])."""
        H, ch = self.no_heads, self.c_hidden
        Pq, Pv = self.no_qk_points, self.no_v_points
        lead = s.shape[:-1]

        qkv = dense(s, self.linear_qkv, self.dtype).reshape(*lead, H, 3 * ch)
        q, k, v = qkv.chunk(3, dim=-1)

        pts = dense(s.float(), self.linear_points).reshape(*lead, H * (2 * Pq + Pv), 3)
        pts = frames.expand_dims(-1).apply(pts).reshape(*lead, H, 2 * Pq + Pv, 3)
        q_pts, k_pts, v_pts = pts[..., :Pq, :], pts[..., Pq:2 * Pq, :], pts[..., 2 * Pq:, :]

        a = torch.einsum("...qhc,...khc->...hqk", q, k).float()
        a = a * math.sqrt(1.0 / (3 * ch))

        head_weights = F.softplus(self.head_weights) * math.sqrt(1.0 / (3 * (Pq * 9.0 / 2)))
        q_sq = torch.sum(q_pts**2, dim=(-1, -2))  # [..., L, H]
        k_sq = torch.sum(k_pts**2, dim=(-1, -2))
        qk = torch.einsum("...qhpc,...khpc->...hqk", q_pts, k_pts)
        dist2 = (
            q_sq.transpose(-1, -2)[..., :, None]
            + k_sq.transpose(-1, -2)[..., None, :]
            - 2 * qk
        )
        a = a + dist2 * head_weights[..., :, None, None] * (-0.5)
        if frame_mask is not None:
            m2 = frame_mask[..., :, None] * frame_mask[..., None, :]
            a = a + (self.inf * (m2 - 1.0))[..., None, :, :]
        a = torch.softmax(a.float(), dim=-1).to(s.dtype)
        if drop is not None:
            a = drop(a, shards)

        o = torch.einsum("...hqk,...khc->...qhc", *_promote(a, v)).reshape(*lead, H * ch)
        o_pt = torch.einsum("...hqk,...khpc->...qhpc", *_promote(a, v_pts))
        o_pt = frames.expand_dims(-1).expand_dims(-1).invert_apply(o_pt)
        o_pt_norm = torch.sqrt(torch.sum(o_pt**2, dim=-1) + self.eps).reshape(*lead, H * Pv)
        o_pt = o_pt.reshape(*lead, H * Pv, 3)
        out = torch.cat([o, o_pt[..., 0], o_pt[..., 1], o_pt[..., 2], o_pt_norm], dim=-1)
        return dense(out, self.linear_out, self.dtype)
