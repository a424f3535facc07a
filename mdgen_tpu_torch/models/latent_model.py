"""The latent MD trajectory denoiser (port of ``mdgen_tpu/models/latent_model.py``).

A DiT over (B, T, L, C) latents with factorized attention (residue axis L,
frame axis T), per-layer adaLN-zero with 9 chunks, and the prepend-IPA tower
over the key frame. Ported configuration: forward simulation
(``sim_condition``, optionally ``prepend_ipa``, ``abs_pos_emb``,
``abs_time_emb``). Module and parameter names follow the JAX tree, so a
flax parameter tree converts by renaming and transposing
(``interop.jax_params_to_state_dict``).

With ``cfg.fused_block`` and L <= 16 each trunk layer runs as three fused
serving sublayers (``ops/``): hand-written CUDA kernels on the GPU, their
plain twins on the CPU; they are forward-only, and the training model is
built with ``fused_block=False``. The IPA tower's residue attention stays
unfused, as in the JAX package. The unfused frame attention takes
``cfg.attn_impl``: at the training recipe's T=1000 "auto" picks the flash
kernels (``ops/flash_attention.py``), forward and backward.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config import torch_dtype
from .attention import RoPEAttention
from .ipa import InvariantPointAttention
from .layers import (
    FinalLayer,
    TimestepEmbedder,
    dense,
    gelu,
    layer_norm,
    modulate,
    sincos_pos_embed,
    xavier_,
    zeros_,
)

# unported options -> the ROADMAP item that ports them
_UNPORTED = {
    "tps_condition": "TPS",
    "inpainting": "design and inpainting",
    "design": "design and inpainting",
    "dynamic_mpnn": "design and inpainting (mpnn modes)",
    "mpnn": "design and inpainting (mpnn modes)",
    "hyena": "--hyena",
    "interleave_ipa": "remaining model options (interleave_ipa)",
    "no_frames": "remaining model options (no_frames)",
}


def check_ported(cfg) -> None:
    for flag, item in _UNPORTED.items():
        if getattr(cfg, flag):
            raise NotImplementedError(
                f"cfg.{flag} is not ported to mdgen_tpu_torch yet (ROADMAP: {item})"
            )


class IPALayer(nn.Module):
    """IPA + residue attention + MLP over (B, L, C), one per tower layer."""

    def __init__(self, cfg):
        super().__init__()
        C = cfg.embed_dim
        self.dt = torch_dtype(cfg)
        self.ipa = InvariantPointAttention(
            C, cfg.ipa_head_dim, cfg.ipa_heads, cfg.ipa_qk, cfg.ipa_v, dtype=self.dt
        )
        # flax LayerNorm default eps (1e-6), not torch's 1e-5
        self.ipa_norm = nn.LayerNorm(C, eps=1e-6)
        self.mha_l = RoPEAttention(C, cfg.mha_heads, use_rope=not cfg.no_rope, dtype=self.dt)
        self.fc1 = nn.Linear(C, 4 * C)
        self.fc2 = nn.Linear(4 * C, C)

    def reset_parameters(self, generator=None):
        self.ipa.reset_parameters(generator)
        nn.init.ones_(self.ipa_norm.weight)
        nn.init.zeros_(self.ipa_norm.bias)
        self.mha_l.reset_parameters(generator)
        xavier_(self.fc1, generator)
        xavier_(self.fc2, generator)

    def forward(self, x, mod, mask, frames):
        """``mod``: this layer's 6-chunk slice of the tower-wide adaLN."""
        sh_l, sc_l, g_l, sh_m, sc_m, g_m = mod.chunk(6, dim=-1)
        n = self.ipa_norm
        s = F.layer_norm(x.float(), n.normalized_shape, n.weight.float(), n.bias.float(), n.eps)
        x = x + self.ipa(s, frames, frame_mask=mask)
        h = self.mha_l(modulate(layer_norm(x), sh_l, sc_l).to(self.dt), mask)
        x = x + g_l[:, None] * h
        h = modulate(layer_norm(x), sh_m, sc_m).to(self.dt)
        h = dense(gelu(dense(h, self.fc1, self.dt)), self.fc2, self.dt)
        return x + g_m[:, None] * h


class LatentMDGenLayer(nn.Module):
    """Factorized spatio-temporal DiT block over (B, T, L, C)."""

    def __init__(self, cfg):
        super().__init__()
        C = cfg.embed_dim
        self.cfg = cfg
        self.dt = torch_dtype(cfg)
        rope = not cfg.no_rope
        self.mha_l = RoPEAttention(C, cfg.mha_heads, use_rope=rope, dtype=self.dt)
        self.mha_t = RoPEAttention(C, cfg.mha_heads, use_rope=rope, dtype=self.dt,
                                   impl=cfg.attn_impl)
        self.fc1 = nn.Linear(C, 4 * C)
        self.fc2 = nn.Linear(4 * C, C)

    def reset_parameters(self, generator=None):
        self.mha_l.reset_parameters(generator)
        self.mha_t.reset_parameters(generator)
        xavier_(self.fc1, generator)
        xavier_(self.fc2, generator)

    def _fused_attn(self, fn, mha, x, shift, scale, gate, mask):
        return fn(
            x, shift, scale, gate, mask[:, 0],
            mha.qkv_proj.weight, mha.qkv_proj.bias, mha.bias_k.reshape(-1),
            mha.bias_v.reshape(-1), mha.out_proj.weight, mha.out_proj.bias,
            num_heads=self.cfg.mha_heads, use_rope=not self.cfg.no_rope,
            compute_dtype=self.dt,
        )

    def forward(self, x, mod, mask, frames=None):
        """``mod``: this layer's 9-chunk slice of the trunk-wide adaLN,
        [B, 1, 9C]; mask [B, T, L] (frame-constant)."""
        B, T, L, C = x.shape
        dt = self.dt
        sh_l, sc_l, g_l, sh_t, sc_t, g_t, sh_m, sc_m, g_m = mod.chunk(9, dim=-1)
        # the same gates as the JAX model: no dropout at inference, L <= 16,
        # and T <= 1024 for the frame kernel (hyena is not ported)
        use_fused = self.cfg.fused_block and L <= 16
        use_fused_t = use_fused and T <= 1024
        if use_fused:
            from ..ops import fused_l_sublayer

            x = self._fused_attn(fused_l_sublayer, self.mha_l, x, sh_l, sc_l, g_l, mask)
        else:
            # the reference reuses one no-affine LN for both attention sublayers
            h = self.mha_l(modulate(layer_norm(x), sh_l, sc_l).to(dt), mask, axis=2)
            x = x + g_l[:, None] * h

        if use_fused_t:
            from ..ops import fused_t_sublayer

            x = self._fused_attn(fused_t_sublayer, self.mha_t, x, sh_t, sc_t, g_t, mask)
        else:
            h = self.mha_t(modulate(layer_norm(x), sh_t, sc_t).to(dt), mask, axis=1)
            x = x + g_t[:, None] * h

        if use_fused:
            from ..ops import fused_ffn_sublayer

            return fused_ffn_sublayer(
                x, sh_m, sc_m, g_m, self.fc1.weight, self.fc1.bias,
                self.fc2.weight, self.fc2.bias, compute_dtype=dt,
            )
        h = modulate(layer_norm(x), sh_m, sc_m).to(dt)
        h = dense(gelu(dense(h, self.fc1, dt)), self.fc2, dt)
        return x + g_m[:, None] * h


class LatentMDGenModel(nn.Module):
    def __init__(self, cfg, latent_dim: int):
        super().__init__()
        check_ported(cfg)
        if not cfg.sim_condition:
            raise NotImplementedError("only the forward-simulation task is ported")
        self.cfg = cfg
        C, nl = cfg.embed_dim, cfg.num_layers
        self.latent_dim = latent_dim
        self.dt = torch_dtype(cfg)

        self.latent_to_emb = nn.Linear(latent_dim, C)
        self.cond_to_emb = nn.Linear(latent_dim, C)
        self.mask_to_emb = nn.Embedding(2, C)
        if cfg.prepend_ipa:
            if not cfg.no_aa_emb:
                self.aatype_to_emb = nn.Embedding(21, C)
            self.ipa_layers = nn.ModuleList(IPALayer(cfg) for _ in range(nl))
            # tower-wide fused adaLN producer (6 chunks x layers)
            self.ipa_adaln = nn.Linear(C, 6 * C * nl)
        self.layers = nn.ModuleList(LatentMDGenLayer(cfg) for _ in range(nl))
        # trunk-wide fused adaLN producer (9 chunks x layers)
        self.trunk_adaln = nn.Linear(C, 9 * C * nl)
        self.emb_to_latent = FinalLayer(C, latent_dim)
        self.t_embedder = TimestepEmbedder(C)
        if cfg.abs_pos_emb:
            self.register_buffer(
                "pos_embed", torch.from_numpy(sincos_pos_embed(C, cfg.crop)[None]),
                persistent=False,
            )
        if cfg.abs_time_emb:
            self.register_buffer(
                "time_embed", torch.from_numpy(sincos_pos_embed(C, cfg.num_frames)[None]),
                persistent=False,
            )

    def reset_parameters(self, generator=None):
        """The JAX model's init scheme: xavier Dense layers, N(0, 1)
        embeddings, zero adaLN producers and output head, N(0, 0.02)
        timestep MLP."""
        xavier_(self.latent_to_emb, generator)
        xavier_(self.cond_to_emb, generator)
        embeddings = [self.mask_to_emb]
        if self.cfg.prepend_ipa:
            if not self.cfg.no_aa_emb:
                embeddings.append(self.aatype_to_emb)
            for layer in self.ipa_layers:
                layer.reset_parameters(generator)
            zeros_(self.ipa_adaln)
        for emb in embeddings:
            nn.init.normal_(emb.weight, std=1.0, generator=generator)
        for layer in self.layers:
            layer.reset_parameters(generator)
        zeros_(self.trunk_adaln)
        self.emb_to_latent.reset_parameters(generator)
        self.t_embedder.reset_parameters(generator)
        return self

    def run_ipa(self, t, mask, start_frames, aatype):
        """Key-frame tower (sim): t [B, C], mask [B, L] -> [B, L, C]."""
        cfg = self.cfg
        B, L = mask.shape
        x = torch.zeros((B, L, cfg.embed_dim), device=t.device)
        if aatype is not None and not cfg.no_aa_emb:
            x = x + self.aatype_to_emb(aatype.long())
        mods = dense(F.silu(t), self.ipa_adaln, self.dt).chunk(cfg.num_layers, dim=-1)
        for layer, mod in zip(self.ipa_layers, mods):
            x = layer(x, mod, mask, start_frames)
        return x

    def forward(self, x, t, mask, start_frames=None, end_frames=None, x_cond=None,
                x_cond_mask=None, aatype=None):
        """x [B, T, L, latent_dim] f32, t [B] -> velocity [B, T, L, latent_dim]."""
        cfg = self.cfg
        x = dense(x, self.latent_to_emb)
        if cfg.abs_pos_emb:
            x = x + self.pos_embed
        if cfg.abs_time_emb:
            x = x + self.time_embed[:, : x.shape[1], None]
        if x_cond is not None:
            x = x + dense(x_cond, self.cond_to_emb) + self.mask_to_emb(x_cond_mask.long())

        t_emb = self.t_embedder(t * cfg.time_multiplier)[:, None]  # [B, 1, C]
        if cfg.prepend_ipa:
            x = x + self.run_ipa(t_emb[:, 0], mask[:, 0], start_frames, aatype)[:, None]

        trunk_mods = dense(F.silu(t_emb), self.trunk_adaln, self.dt)
        for layer, mod in zip(self.layers, trunk_mods.chunk(cfg.num_layers, dim=-1)):
            x = layer(x, mod, mask, start_frames)
        return self.emb_to_latent(x, t_emb)

    forward_inference = forward
