"""The latent MD trajectory denoiser (port of ``mdgen_tpu/models/latent_model.py``).

A DiT over (B, T, L, C) latents with factorized attention (residue axis L,
frame axis T), per-layer adaLN-zero with 9 chunks, and the prepend-IPA tower
over the key frame. Every configuration of the JAX model is ported: forward
simulation (``sim_condition``, optionally ``prepend_ipa``, ``abs_pos_emb``,
``abs_time_emb``; upsampling is ``sim_condition`` with ``cond_interval``;
ATLAS proteins are the same model at crop 256), transition-path sampling and
inpainting (``tps_condition`` / ``inpainting``: the IPA tower runs twice,
once from each endpoint, over the relative transforms between them),
sequence design (``design``: 20 simplex channels, a head of logits pooled
over T and, at inference, the Dirichlet conditional flow; the ``mpnn`` and
``dynamic_mpnn`` modes predict the sequence from one or two key frames), the
Hyena frame mixer (``hyena``, ``hyena.py``, in place of the frame
attention), an IPA in every trunk layer (``interleave_ipa``, over the key
frames broadcast along T) and the raw-atom37 ablation (``no_frames``: the
111-channel latent, no frames). Module and parameter names follow the JAX
tree, so a flax parameter tree converts by renaming and transposing
(``interop.jax_params_to_state_dict``).

With ``cfg.fused_block`` and L <= 16 (``ops.FUSED_L_MAX_RESIDUES``) each
trunk layer runs as three fused serving sublayers (``ops/``): hand-written
CUDA kernels on the GPU, their plain twins on the CPU; they are
forward-only, and the training model is built with ``fused_block=False``.
Under ``hyena`` the frame sublayer is the Hyena operator, unfused. The IPA
tower's residue attention stays unfused, as in the JAX package. The unfused
frame attention takes ``cfg.attn_impl``, the residue attentions (trunk and
tower) "auto": on a CUDA device either picks the flash kernels
(``ops/flash_attention.py``), forward and backward, from
``ops.CUDA_FLASH_MIN_KEYS`` keys, so the 4AA recipe's T=1000 frames and
both axes of an ATLAS crop (256 residues, 250 frames) take them; on the CPU
from the JAX package's 513 keys. On a CUDA device in float32 the residue
attentions with at most ``ops.SHORT_ATTN_MAX_KEYS`` keys (the 4AA recipe's
5) take the short-attention kernels instead (``ops.short_attention``,
forward and backward; ``attention.short_route``); in bf16 they stay dense.

Training options: ``dropout`` (on the attention probabilities of every
attention and IPA, dense route; active only when the caller passes
``dropout_seed``, as the train step does) and ``grad_checkpointing`` (each
trunk layer under non-reentrant ``torch.utils.checkpoint``; the layer draws
its dropout masks from a generator it seeds itself, so the recompute draws
the same ones).

On a (dp, sp, tp) grid of ranks (``parallel.mesh.shard_model``) the model
holds this rank's shard of the attention and MLP projections (``tp``) and
its frames of T (``sp``); the collectives that join them are named where
they run (``RoPEAttention``, ``layers.mlp``, ``LatentMDGenLayer.forward``,
``LatentMDGenModel.forward``). The fused sublayers take whole weights and
every frame, so they stay off there.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import ops
from ..config import torch_dtype
from ..ops import FUSED_L_MAX_RESIDUES
from ..parallel.distributed import all_reduce_sum, gather_along
from ..transport.dirichlet import DirichletConditionalFlow, simplex_proj
from ..transport.transport import t_to_alpha
from .attention import RoPEAttention
from .hyena import HyenaOperator
from .ipa import InvariantPointAttention
from .layers import (
    Dropout,
    FinalLayer,
    TimestepEmbedder,
    dense,
    gelu,
    layer_norm,
    mlp,
    modulate,
    sincos_pos_embed,
    xavier_,
    zeros_,
)

def affine_layer_norm(norm: nn.LayerNorm, x):
    """flax ``nn.LayerNorm`` (scale and bias) in f32, its parameters widened."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(),
                        norm.bias.float(), norm.eps)


def _ipa(cfg, dt):
    return InvariantPointAttention(cfg.embed_dim, cfg.ipa_head_dim, cfg.ipa_heads, cfg.ipa_qk,
                                   cfg.ipa_v, dtype=dt)


class IPALayer(nn.Module):
    """IPA + residue attention + MLP over (B, L, C), one per tower layer."""

    tp = None  # the tensor-parallel mesh axis when fc1 / fc2 are sharded

    def __init__(self, cfg):
        super().__init__()
        C = cfg.embed_dim
        self.dt = torch_dtype(cfg)
        self.ipa = _ipa(cfg, self.dt)
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

    def forward(self, x, mod, mask, frames, drop=None):
        """``mod``: this layer's 6-chunk slice of the tower-wide adaLN;
        ``drop``: a ``Dropout`` (training) or None."""
        sh_l, sc_l, g_l, sh_m, sc_m, g_m = mod.chunk(6, dim=-1)
        x = x + self.ipa(affine_layer_norm(self.ipa_norm, x), frames, frame_mask=mask, drop=drop)
        h = self.mha_l(modulate(layer_norm(x), sh_l, sc_l).to(self.dt), mask, drop=drop)
        x = x + g_l[:, None] * h
        h = modulate(layer_norm(x), sh_m, sc_m).to(self.dt)
        return x + g_m[:, None] * mlp(h, self.fc1, self.fc2, self.dt, self.tp)


class LatentMDGenLayer(nn.Module):
    """Factorized spatio-temporal DiT block over (B, T, L, C)."""

    tp = None  # the tensor-parallel mesh axis when fc1 / fc2 are sharded

    def __init__(self, cfg):
        super().__init__()
        C = cfg.embed_dim
        self.cfg = cfg
        self.dt = torch_dtype(cfg)
        rope = not cfg.no_rope
        self.mha_l = RoPEAttention(C, cfg.mha_heads, use_rope=rope, dtype=self.dt)
        if cfg.hyena:
            self.mha_t = HyenaOperator(C, l_max=cfg.num_frames, order=2, filter_order=64)
        else:
            self.mha_t = RoPEAttention(C, cfg.mha_heads, use_rope=rope, dtype=self.dt,
                                       impl=cfg.attn_impl)
        if cfg.interleave_ipa:
            self.ipa = _ipa(cfg, self.dt)
            self.ipa_norm = nn.LayerNorm(C, eps=1e-6)
        self.fc1 = nn.Linear(C, 4 * C)
        self.fc2 = nn.Linear(4 * C, C)

    def reset_parameters(self, generator=None):
        if self.cfg.interleave_ipa:
            self.ipa.reset_parameters(generator)
            nn.init.ones_(self.ipa_norm.weight)
            nn.init.zeros_(self.ipa_norm.bias)
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

    def forward(self, x, mod, mask, frames=None, dropout_seed=None, dropout_rows=None,
                sp=None):
        """``mod``: this layer's 9-chunk slice of the trunk-wide adaLN,
        [B, 1, 9C]; mask [B, T, L] (frame-constant); frames [B, L] (the key
        frames, for ``interleave_ipa``); ``dropout_seed`` (training) seeds
        this call's dropout masks, ``dropout_rows`` as ``layers.Dropout``;
        ``sp`` (a mesh axis): x holds this rank's frames of T, the frame
        attention gathers its keys (``RoPEAttention``) and the Hyena
        operator its whole input."""
        cfg = self.cfg
        B, T, L, C = x.shape
        dt = self.dt
        sh_l, sc_l, g_l, sh_t, sc_t, g_t, sh_m, sc_m, g_m = mod.chunk(9, dim=-1)
        drop = None if dropout_seed is None else Dropout(cfg.dropout, dropout_seed, x.device,
                                                         dropout_rows)
        sp = sp if sp is not None and sp.size > 1 else None
        if cfg.interleave_ipa:
            shards = [] if sp is None else [(1, sp.index * T, T * sp.size)]
            x = x + self.ipa(affine_layer_norm(self.ipa_norm, x), frames.expand_dims(1),
                             frame_mask=mask, drop=drop, shards=shards)
        # the JAX model's gates: no dropout, L <= 16; for the frame kernel
        # also T <= 1024 and no Hyena. The fused wrappers take whole weights
        # and every frame: off under tensor or sequence parallelism
        whole = sp is None and all(getattr(m, "tp", None) is None
                                   for m in (self, self.mha_l, self.mha_t))
        use_fused = cfg.fused_block and L <= FUSED_L_MAX_RESIDUES and drop is None and whole
        use_fused_t = use_fused and not cfg.hyena and T <= 1024
        if use_fused:
            x = self._fused_attn(ops.fused_l_sublayer, self.mha_l, x, sh_l, sc_l, g_l, mask)
        else:
            # the reference reuses one no-affine LN for both attention sublayers
            h = self.mha_l(modulate(layer_norm(x), sh_l, sc_l).to(dt), mask, axis=2, drop=drop,
                           sp=sp)
            x = x + g_l[:, None] * h

        if use_fused_t:
            x = self._fused_attn(ops.fused_t_sublayer, self.mha_t, x, sh_t, sc_t, g_t, mask)
        else:
            h = modulate(layer_norm(x), sh_t, sc_t).to(dt)
            if cfg.hyena:
                # the FFT convolution needs every frame: gather them, keep ours
                h = gather_along(h, 1, sp)
                Tg = h.shape[1]
                h = self.mha_t(h.transpose(1, 2).reshape(B * L, Tg, C))
                h = h.reshape(B, L, Tg, C).transpose(1, 2)
                if sp is not None:
                    h = h.narrow(1, sp.index * T, T)
            else:
                h = self.mha_t(h, mask, axis=1, drop=drop, sp=sp)
            x = x + g_t[:, None] * h

        if use_fused:
            return ops.fused_ffn_sublayer(
                x, sh_m, sc_m, g_m, self.fc1.weight, self.fc1.bias,
                self.fc2.weight, self.fc2.bias, compute_dtype=dt,
            )
        h = modulate(layer_norm(x), sh_m, sc_m).to(dt)
        return x + g_m[:, None] * mlp(h, self.fc1, self.fc2, dt, self.tp)


class LatentMDGenModel(nn.Module):
    tp = None  # the tensor-parallel mesh axis when the design head's fc1 / fc2 are sharded
    sp = None  # the sequence-parallel mesh axis: the inputs hold this rank's frames
    def __init__(self, cfg, latent_dim: int):
        super().__init__()
        if not (cfg.sim_condition or cfg.tps_condition or cfg.inpainting or cfg.mpnn
                or cfg.dynamic_mpnn):
            raise NotImplementedError(
                "the model needs a task mode: sim_condition, tps_condition, inpainting, mpnn "
                "or dynamic_mpnn")
        if cfg.design and not cfg.prepend_ipa:
            raise ValueError("design needs prepend_ipa (the simplex enters through the IPA tower)")
        self.cfg = cfg
        C, nl = cfg.embed_dim, cfg.num_layers
        self.latent_dim = latent_dim
        self.dt = torch_dtype(cfg)
        self.two_towers = cfg.tps_condition or cfg.inpainting or cfg.dynamic_mpnn
        self.mpnn_mode = cfg.mpnn or cfg.dynamic_mpnn

        self.latent_to_emb = nn.Linear(latent_dim, C)
        if self.two_towers:
            # the endpoint tower's inputs: one relative transform (tensor-7) each way
            self.latent_to_emb_f = nn.Linear(7, C)
            self.latent_to_emb_r = nn.Linear(7, C)
        # the conditioning latents carry no simplex channels
        self.cond_to_emb = nn.Linear(latent_dim - 20 if cfg.design else latent_dim, C)
        self.mask_to_emb = nn.Embedding(2, C)
        if cfg.design:
            self.x_d_to_emb = nn.Linear(20, C)
        if cfg.prepend_ipa:
            if not cfg.no_aa_emb:
                self.aatype_to_emb = nn.Embedding(21, C)
            self.ipa_layers = nn.ModuleList(IPALayer(cfg) for _ in range(nl))
            # tower-wide fused adaLN producer (6 chunks x layers)
            self.ipa_adaln = nn.Linear(C, 6 * C * nl)
        self.layers = nn.ModuleList(LatentMDGenLayer(cfg) for _ in range(nl))
        # trunk-wide fused adaLN producer (9 chunks x layers)
        self.trunk_adaln = nn.Linear(C, 9 * C * nl)
        if not self.mpnn_mode:
            self.emb_to_latent = FinalLayer(C, latent_dim)
        if cfg.design:
            # the design head: an MLP per frame, pooled over T, then logits
            self.fc1 = nn.Linear(C, C)
            self.fc2 = nn.Linear(C, C)
            self.fc3 = nn.Linear(C, C)
            self.emb_to_logits = nn.Linear(C, 20)
            self.condflow = DirichletConditionalFlow(K=20, alpha_spacing=0.001,
                                                     alpha_max=cfg.alpha_max)
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
        if self.two_towers:
            xavier_(self.latent_to_emb_f, generator)
            xavier_(self.latent_to_emb_r, generator)
        xavier_(self.cond_to_emb, generator)
        if self.cfg.design:
            for lin in (self.x_d_to_emb, self.fc1, self.fc2, self.fc3, self.emb_to_logits):
                xavier_(lin, generator)
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
        if not self.mpnn_mode:
            self.emb_to_latent.reset_parameters(generator)
        self.t_embedder.reset_parameters(generator)
        return self

    def run_ipa(self, t, mask, start_frames, end_frames, aatype, x_d, drops):
        """Key-frame tower: t [B, C], mask [B, L] -> [B, L, C]. sim and
        mpnn: one pass over ``start_frames``. tps, inpainting and
        dynamic_mpnn: the same layers and modulation over both endpoints,
        the reverse stream with the start frames and the forward stream with
        the end frames, as the JAX model pairs them. Under design each
        stream starts with ``x_d_to_emb(x_d)`` added. ``drops``: each
        layer's ``Dropout`` (training) or None."""
        cfg = self.cfg
        B, L = mask.shape
        aa = xd = None
        if aatype is not None and not cfg.no_aa_emb:
            aa = self.aatype_to_emb(aatype.long())
        if cfg.design:
            xd = dense(x_d, self.x_d_to_emb)

        def embed(x):  # the JAX model's order of additions
            x = x if aa is None else x + aa
            return x if xd is None else x + xd

        mods = dense(F.silu(t), self.ipa_adaln, self.dt).chunk(cfg.num_layers, dim=-1)
        if cfg.sim_condition or cfg.mpnn:
            x = embed(torch.zeros((B, L, cfg.embed_dim), device=t.device))
            for layer, mod, drop in zip(self.ipa_layers, mods, drops):
                x = layer(x, mod, mask, start_frames, drop)
            return x
        x_f = embed(dense(start_frames.invert().compose(end_frames).to_tensor_7(),
                          self.latent_to_emb_f))
        x_r = embed(dense(end_frames.invert().compose(start_frames).to_tensor_7(),
                          self.latent_to_emb_r))
        for layer, mod, drop in zip(self.ipa_layers, mods, drops):
            x_r = layer(x_r, mod, mask, start_frames, drop)
            x_f = layer(x_f, mod, mask, end_frames, drop)
        return x_r + x_f

    def forward(self, x, t, mask, start_frames=None, end_frames=None, x_cond=None,
                x_cond_mask=None, aatype=None, dropout_seed=None, dropout_rows=None):
        """x [B, T, L, latent_dim] f32, t [B] -> velocity [B, T, L, latent_dim]
        (under design the last 20 channels carry the logits added on); the
        mpnn modes run on the first frame (``mpnn``) or the first and last
        (``dynamic_mpnn``) and return the logits [B, 1, L, 20].
        ``dropout_seed`` (an int; training with ``cfg.dropout > 0``) turns
        dropout on: each IPA tower layer and each trunk layer draws its masks
        from a seed of its own, drawn from this one on the host;
        ``dropout_rows = (lo, n)``: this batch is rows lo.. of an n-row one
        (a data-parallel rank), whose masks are drawn and sliced.

        Under sequence parallelism (``self.sp``, set by
        ``parallel.mesh.shard_model``) the frame-axis inputs hold this rank's
        frames of T, and the other inputs (t, the key frames, aatype) are
        whole: the time embedding takes the global frame offsets, the means
        over T all-reduce their sums, and the mpnn modes gather their key
        frames and run the trunk on them whole."""
        cfg = self.cfg
        nl = cfg.num_layers
        seeds = [None] * (2 * nl)
        if dropout_seed is not None and cfg.dropout > 0:
            seeds = torch.randint(0, 2**62, (2 * nl,),
                                  generator=torch.Generator().manual_seed(dropout_seed)).tolist()
        sp = self.sp if self.sp is not None and self.sp.size > 1 else None
        if self.mpnn_mode:
            if sp is not None:  # frames 0 and T-1 live on the first and last sp ranks
                x, x_cond, x_cond_mask, mask = (gather_along(v, 1, sp)
                                                for v in (x, x_cond, x_cond_mask, mask))
                sp = None
            sel = [0, x.shape[1] - 1] if cfg.dynamic_mpnn else [0]
            x, x_cond = x[:, sel], x_cond[:, sel]
            x_cond_mask, mask = x_cond_mask[:, sel], mask[:, sel]
        T = x.shape[1]
        t0 = 0 if sp is None else sp.index * T

        def mean_frames(v):  # the mean over every frame of T
            if sp is None:
                return v.mean(dim=1)
            return all_reduce_sum(v.sum(dim=1), sp) / (T * sp.size)

        x_d = mean_frames(x[..., -20:]) if cfg.design else None

        x = dense(x, self.latent_to_emb)
        if cfg.abs_pos_emb:
            x = x + self.pos_embed
        if cfg.abs_time_emb:
            x = x + self.time_embed[:, t0:t0 + T, None]
        if x_cond is not None:
            x = x + dense(x_cond, self.cond_to_emb) + self.mask_to_emb(x_cond_mask.long())

        t_emb = self.t_embedder(t * cfg.time_multiplier)[:, None]  # [B, 1, C]
        if cfg.prepend_ipa:
            drops = [None if s is None else Dropout(cfg.dropout, s, x.device, dropout_rows)
                     for s in seeds[:nl]]
            x = x + self.run_ipa(t_emb[:, 0], mask[:, 0], start_frames, end_frames,
                                 aatype, x_d, drops)[:, None]

        trunk_mods = dense(F.silu(t_emb), self.trunk_adaln, self.dt)
        remat = cfg.grad_checkpointing and torch.is_grad_enabled()
        for layer, mod, seed in zip(self.layers, trunk_mods.chunk(nl, dim=-1), seeds[nl:]):
            if remat:
                # the layer seeds its own masks (no global generator to restore)
                x = checkpoint(layer, x, mod, mask, start_frames, seed, dropout_rows, sp,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                x = layer(x, mod, mask, start_frames, seed, dropout_rows, sp)
        latent = None if self.mpnn_mode else self.emb_to_latent(x, t_emb)
        if not cfg.design:
            return latent
        x_l = mean_frames(mlp(x, self.fc1, self.fc2, tp=self.tp))  # pool over T
        logits = dense(gelu(dense(x_l, self.fc3)), self.emb_to_logits)  # [B, L, 20]
        if self.mpnn_mode:
            return logits[:, None]
        return torch.cat([latent[..., :-20], latent[..., -20:] + logits[:, None]], dim=-1)

    def forward_inference(self, x, t, mask, start_frames=None, end_frames=None, x_cond=None,
                          x_cond_mask=None, aatype=None):
        """The sampler's drift. Under design (not the mpnn modes) the 20
        logit channels become the Dirichlet conditional-flow field, in f32
        on the model's device: softmax at ``dirichlet_flow_temp``, projected
        onto the simplex; alpha from ``t[0]`` (every row of a batch shares
        its time), at most ``alpha_max - spacing``; flow = (p c - x sum(p c))
        d(alpha)/dt with c the conditional-flow factor."""
        cfg = self.cfg
        latent = self(x, t, mask, start_frames, end_frames, x_cond, x_cond_mask, aatype)
        if not cfg.design or self.mpnn_mode:
            return latent
        x_discrete = x[..., -20:].float()
        logits = latent[..., -20:].float()
        flow_probs = simplex_proj(torch.softmax(logits / cfg.dirichlet_flow_temp, dim=-1))
        alpha, dalpha_dt = t_to_alpha(t[0].float(), cfg.alpha_max)
        alpha = alpha.clamp_max(cfg.alpha_max - self.condflow.alpha_spacing)
        c_factor = self.condflow.c_factor(x_discrete, alpha)
        if cfg.allow_nan_cfactor:
            c_factor = torch.nan_to_num(c_factor)
        pc = flow_probs * c_factor
        flow = (pc - x_discrete * pc.sum(dim=-1, keepdim=True)) * dalpha_dt
        return torch.cat([latent[..., :-20], flow], dim=-1)
