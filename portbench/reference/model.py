"""The reference MDGen denoiser: plain PyTorch over a dict of named tensors.

A latent DiT over (B, T, L, C) tokens for forward simulation
(``sim_condition``) with the prepended IPA tower over the key frame and the
absolute position and frame embeddings: MDGen's model (Jing et al., 2024,
"Generative Modeling of Molecular Dynamics Trajectories") as its reference
code builds it, with flax's conventions (layer-norm eps 1e-6, exact gelu,
adaLN-zero modulation with 6 chunks a tower layer and 9 a trunk layer). Every
attention is dense, softmax in float32; no kernels, no cache, no
checkpointing, no dropout.

Parameters are read by the names of the program's ``state_dict`` (a
``torch.nn.Linear`` stores ``weight`` [out, in] and ``bias``), so that one
set of seeded tensors feeds both. ``prec`` (``precision.Precision``) rounds
what the configuration computes in its compute dtype.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import geometry as geo

NEG_INF = torch.finfo(torch.float32).min


def sincos_table(dim: int, n: int) -> torch.Tensor:
    """[n, dim], layout [sin | cos], from float64 positions and frequencies."""
    omega = 1.0 / 10000 ** (np.arange(dim // 2, dtype=np.float64) / (dim / 2.0))
    out = np.einsum("m,d->md", np.arange(n, dtype=np.float64), omega)
    return torch.from_numpy(np.concatenate([np.sin(out), np.cos(out)], axis=1).astype(np.float32))


class Model:
    def __init__(self, cfg: dict, params: dict, prec):
        self.cfg, self.P, self.prec = cfg, params, prec
        self.C, self.H, self.nl = cfg["embed_dim"], cfg["mha_heads"], cfg["num_layers"]

    # -- primitives ------------------------------------------------------------

    def w(self, name):
        return self.P[name]

    def dense(self, x, name):
        """A layer that computes in float32."""
        return F.linear(x, self.w(name + ".weight"), self.w(name + ".bias"))

    def dense_low(self, x, name):
        """A layer that computes in the configuration's compute dtype."""
        q = self.prec.q
        return q(F.linear(q(x), q(self.w(name + ".weight")), q(self.w(name + ".bias"))))

    @staticmethod
    def ln(x):
        return F.layer_norm(x, x.shape[-1:], eps=1e-6)

    @staticmethod
    def modulate(x, shift, scale):
        return x * (1 + scale[:, None]) + shift[:, None]

    def mlp(self, h, name):
        return self.dense_low(F.gelu(self.dense_low(h, name + ".fc1")), name + ".fc2")

    # -- attention --------------------------------------------------------------

    def attention(self, x, mask, axis, name):
        """Rotary self-attention over ``axis`` (1: frames, 2: residues) of x
        [B, T, L, C], with a learned bias key and value appended (always
        attended, roped at the last position); mask [B, T, L], 1 = valid."""
        q_ = self.prec.q
        B, T, L, C = x.shape
        H, hd = self.H, C // self.H
        qkv = self.dense_low(x, name + ".qkv_proj")
        q, k, v = qkv.chunk(3, dim=-1)
        q = q_(q * hd ** -0.5).reshape(B, T, L, H, hd)
        k, v = k.reshape(B, T, L, H, hd), v.reshape(B, T, L, H, hd)
        shape = [B, T, L, H, hd]
        shape[axis] = 1
        k = torch.cat([k, q_(self.w(name + ".bias_k")).reshape(1, 1, 1, H, hd).expand(shape)], axis)
        v = torch.cat([v, q_(self.w(name + ".bias_v")).reshape(1, 1, 1, H, hd).expand(shape)], axis)
        mshape = list(mask.shape)
        mshape[axis] = 1
        mask = torch.cat([mask, torch.ones(mshape, device=mask.device)], dim=axis)
        S = k.shape[axis]
        inv = 1.0 / 10000 ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
        ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv[None]
        ang = torch.cat([ang, ang], dim=-1)
        sin, cos = q_(torch.sin(ang)), q_(torch.cos(ang))
        view = (1, -1, 1, 1, hd) if axis == 1 else (1, 1, -1, 1, hd)
        sin, cos = sin.reshape(view), cos.reshape(view)

        def rot(t):
            a, b = t.chunk(2, dim=-1)
            return torch.cat([-b, a], dim=-1)

        n = q.shape[axis]
        sq, cq = sin.narrow(axis, 0, n), cos.narrow(axis, 0, n)
        q = q_(q * cq + rot(q) * sq)
        k = q_(k * cos + rot(k) * sin)
        if axis == 2:
            logits = q_(torch.einsum("btqhd,btkhd->bthqk", q, k))
            keep = mask[:, :, None, None, :]
        else:
            logits = q_(torch.einsum("bqlhd,bklhd->blhqk", q, k))
            keep = mask.transpose(1, 2)[:, :, None, None, :]
        logits = torch.where(keep > 0, logits, NEG_INF)
        probs = q_(torch.softmax(logits, dim=-1))
        if axis == 2:
            out = torch.einsum("bthqk,btkhd->btqhd", probs, v)
        else:
            out = torch.einsum("blhqk,bklhd->bqlhd", probs, v)
        return self.dense_low(q_(out).reshape(B, T, L, C), name + ".out_proj")

    def ipa(self, s, frames, mask, name):
        """Invariant point attention without pair features over s [B, L, C]
        and the key frames [B, L]."""
        cfg, q_ = self.cfg, self.prec.q
        H, ch, Pq, Pv = cfg["ipa_heads"], cfg["ipa_head_dim"], cfg["ipa_qk"], cfg["ipa_v"]
        B, L, _ = s.shape
        qkv = self.dense_low(s, name + ".linear_qkv").reshape(B, L, H, 3 * ch)
        q, k, v = qkv.chunk(3, dim=-1)
        pts = self.dense(s, name + ".linear_points").reshape(B, L, H * (2 * Pq + Pv), 3)
        pts = geo.apply(geo.unsqueeze(frames, -1), pts).reshape(B, L, H, 2 * Pq + Pv, 3)
        q_pts, k_pts, v_pts = pts[..., :Pq, :], pts[..., Pq:2 * Pq, :], pts[..., 2 * Pq:, :]
        a = q_(torch.einsum("bqhc,bkhc->bhqk", q, k)) * math.sqrt(1.0 / (3 * ch))
        hw = F.softplus(self.w(name + ".head_weights")) * math.sqrt(1.0 / (3 * (Pq * 9.0 / 2)))
        q_sq, k_sq = (q_pts ** 2).sum((-1, -2)), (k_pts ** 2).sum((-1, -2))  # [B, L, H]
        qk = torch.einsum("bqhpc,bkhpc->bhqk", q_pts, k_pts)
        d2 = q_sq.transpose(1, 2)[..., :, None] + k_sq.transpose(1, 2)[..., None, :] - 2 * qk
        a = a + d2 * hw[:, None, None] * -0.5
        m2 = mask[:, :, None] * mask[:, None, :]
        a = torch.softmax(a + (1e5 * (m2 - 1.0))[:, None], dim=-1)
        o = torch.einsum("bhqk,bkhc->bqhc", a, v).reshape(B, L, H * ch)
        o_pt = torch.einsum("bhqk,bkhpc->bqhpc", a, v_pts)
        o_pt = geo.invert_apply(geo.unsqueeze(geo.unsqueeze(frames, -1), -1), o_pt)
        norm = torch.sqrt((o_pt ** 2).sum(-1) + 1e-8).reshape(B, L, H * Pv)
        o_pt = o_pt.reshape(B, L, H * Pv, 3)
        out = torch.cat([o, o_pt[..., 0], o_pt[..., 1], o_pt[..., 2], norm], dim=-1)
        return self.dense_low(out, name + ".linear_out")

    # -- the model -----------------------------------------------------------------

    def t_embed(self, t):
        half = 128
        freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                            device=t.device) / half)
        args = t[:, None] * freqs[None]
        x = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
        return self.dense(F.silu(self.dense(x, "t_embedder.dense_0")), "t_embedder.dense_1")

    def ipa_layer(self, i, x, mod, mask, frames):
        name = f"ipa_layers.{i}"
        sh_l, sc_l, g_l, sh_m, sc_m, g_m = mod.chunk(6, dim=-1)
        xn = F.layer_norm(x, x.shape[-1:], self.w(name + ".ipa_norm.weight"),
                          self.w(name + ".ipa_norm.bias"), 1e-6)
        x = x + self.ipa(xn, frames, mask, name + ".ipa")
        h = self.modulate(self.ln(x), sh_l, sc_l)[:, None]
        h = self.attention(h, mask[:, None], 2, name + ".mha_l")[:, 0]
        x = x + g_l[:, None] * h
        h = self.modulate(self.ln(x), sh_m, sc_m)
        return x + g_m[:, None] * self.mlp(h, name)

    def trunk_layer(self, i, x, mod, mask):
        name = f"layers.{i}"
        sh_l, sc_l, g_l, sh_t, sc_t, g_t, sh_m, sc_m, g_m = mod.chunk(9, dim=-1)
        h = self.attention(self.modulate(self.ln(x), sh_l, sc_l), mask, 2, name + ".mha_l")
        x = x + g_l[:, None] * h
        h = self.attention(self.modulate(self.ln(x), sh_t, sc_t), mask, 1, name + ".mha_t")
        x = x + g_t[:, None] * h
        h = self.modulate(self.ln(x), sh_m, sc_m)
        return x + g_m[:, None] * self.mlp(h, name)

    def __call__(self, x, t, inputs):
        """x [B, T, L, D], t [B] -> velocity [B, T, L, D]. ``inputs``: the
        prepared batch's mask [B, T, L], key frames, aatype [B, L], x_cond and
        x_cond_mask."""
        cfg, C, nl = self.cfg, self.C, self.nl
        mask = inputs["mask"]
        B, T, L, _ = x.shape
        h = self.dense(x, "latent_to_emb")
        if cfg["abs_pos_emb"]:
            h = h + sincos_table(C, cfg["crop"]).to(x.device)[None, None, :L]
        if cfg["abs_time_emb"]:
            h = h + sincos_table(C, cfg["num_frames"]).to(x.device)[None, :T, None]
        h = h + self.dense(inputs["x_cond"], "cond_to_emb") \
            + self.w("mask_to_emb.weight")[inputs["x_cond_mask"].long()]
        t_emb = self.t_embed(t * cfg["time_multiplier"])  # [B, C]
        mods = self.dense_low(F.silu(t_emb), "ipa_adaln").chunk(nl, dim=-1)
        s = self.w("aatype_to_emb.weight")[inputs["aatype"].long()]
        for i in range(nl):
            s = self.ipa_layer(i, s, mods[i], mask[:, 0], inputs["start_frames"])
        h = h + s[:, None]
        mods = self.dense_low(F.silu(t_emb[:, None]), "trunk_adaln").chunk(nl, dim=-1)
        for i in range(nl):
            h = self.trunk_layer(i, h, mods[i], mask)
        shift, scale = self.dense(F.silu(t_emb[:, None]), "emb_to_latent.dense_0").chunk(2, dim=-1)
        return self.dense(self.modulate(self.ln(h), shift, scale), "emb_to_latent.dense_1")


# -- tokens ----------------------------------------------------------------------


def tokenize(atom14, seqres, mask, drop_left_context=False):
    """Raw atom14 windows [B, T, L, 14, 3] -> frames, torsions and masks. An
    ATLAS item's column 0 is its left-context residue: it gives the first
    residue its phi and omega and is dropped after."""
    B, T, L = atom14.shape[:3]
    aa = seqres[:, None].expand(B, T, L).long()
    rots, trans = geo.backbone_frames(atom14)
    atom37 = geo.atom14_to_atom37(atom14, aa)
    amask = geo.table("a37_mask", atom14.device)[aa]
    if drop_left_context:
        amask = amask * mask[:, None, :, None]
    tors, tmask = geo.torsions(atom37, aa, amask)
    if drop_left_context:
        tors, tmask, rots, trans = tors[:, :, 1:], tmask[:, :, 1:], rots[:, :, 1:], trans[:, :, 1:]
        seqres, mask = seqres[:, 1:], mask[:, 1:]
    pad = (mask < 0.5)[:, None, :]
    eye = torch.eye(3, device=atom14.device).expand(rots.shape)
    rots = torch.where(pad[..., None, None], eye, rots)
    trans = torch.where(pad[..., None], torch.zeros_like(trans), trans)
    return {"torsions": tors, "torsion_mask": tmask[:, 0] * mask[..., None],
            "rots": rots, "trans": trans, "seqres": seqres, "mask": mask}


def prepare(tok):
    """Tokens -> (latents [B, T, L, 21], loss mask, model inputs): each
    frame's offset from frame 0 as a quaternion (real part >= 0) and a
    translation, then the 14 torsion channels; frame 0 is the condition."""
    rots, trans = tok["rots"], tok["trans"]
    B, T, L = trans.shape[:3]
    ref = (rots[:, :1], trans[:, :1])
    off = geo.to_tensor_7(geo.compose(geo.invert(ref), (rots, trans)))
    sign = torch.where(off[..., :1] < 0, -1.0, 1.0)
    off = torch.cat([off[..., :4] * sign, off[..., 4:]], dim=-1)
    latents = torch.cat([off, tok["torsions"].reshape(B, T, L, 14)], dim=-1)
    fmask = tok["mask"][..., None].expand(B, L, 7)
    tmask = tok["torsion_mask"][..., None].expand(B, L, 7, 2).reshape(B, L, 14)
    loss_mask = torch.cat([fmask, tmask], dim=-1)[:, None].expand(B, T, L, 21)
    cond = torch.zeros((B, T, L), dtype=torch.int64, device=trans.device)
    cond[:, 0] = 1
    inputs = {"mask": tok["mask"][:, None].expand(B, T, L), "aatype": tok["seqres"],
              "start_frames": (rots[:, 0], trans[:, 0]),
              "x_cond": torch.where(cond[..., None] > 0, latents, 0.0), "x_cond_mask": cond}
    return latents, loss_mask, inputs
