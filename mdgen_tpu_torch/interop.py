"""Weights from elsewhere: flax parameter trees and reference (Lightning)
state dicts -> port state dicts.

From the JAX package. The port keeps the flax module names, so the
conversion is a rename plus a transpose:
  * ``Dense.kernel [in, out]`` -> ``Linear.weight [out, in]``; ``bias`` as is;
  * ``Embed.embedding`` and ``LayerNorm.scale`` -> ``weight``;
  * ``bias_k`` / ``bias_v`` (1, 1, C) and ``head_weights`` as they are;
  * ``layers_i`` / ``ipa_layers_i`` -> ``layers.i`` / ``ipa_layers.i``, and
    the auto-named ``Dense_0`` / ``Dense_1`` of ``t_embedder`` and
    ``emb_to_latent`` -> ``dense_0`` / ``dense_1``.
Input is nested dicts of numpy arrays (``jax.device_get`` of the tree that
``MDGenRuntime.init`` makes); no jax is needed here.

From the reference. ``port_reference_state_dict`` is the port's copy of
``mdgen_tpu/interop.py``'s map (held to it by
``tests/test_torch_selfcontained.py``): the reference keeps separate
q/k/v, IPA and adaLN projections that the flax layout fuses:
  * ``RoPEAttention.qkv_proj`` = [Wq^T | Wk^T | Wv^T] along the output axis;
  * ``InvariantPointAttention.linear_qkv`` interleaves ``linear_q`` /
    ``linear_kv`` per head: for head h the output block is [q_h | k_h |
    v_h], each c_hidden wide;
  * ``InvariantPointAttention.linear_points`` fuses ``linear_q_points`` and
    ``linear_kv_points``: the reference layouts are OpenFold's [x-block |
    y-block | z-block] with block entries h*P + p; the flax layout is
    point-major (h*(2Pq+Pv) + slot)*3 + xyz with slots [q_pts | k_pts |
    v_pts];
  * ``trunk_adaln`` / ``ipa_adaln`` stack every layer's
    ``adaLN_modulation[1]`` along the output axis (layer-major).
The copy returns the flax tree as numpy; :func:`reference_to_state_dict`
composes it with :func:`jax_params_to_state_dict`.
:func:`state_dict_to_reference` is the inverse (a port state dict -> the
reference's keys and layouts), which writes reference-layout checkpoints of
seeded models for the tests and the smoke run.
"""
from __future__ import annotations

import re

import numpy as np
import torch

_LIST = re.compile(r"^(layers|ipa_layers)_(\d+)$")
_AUTO = re.compile(r"^Dense_(\d+)$")

# Lightning precision strings -> the two modes of the port (the copy of
# ``tools/port_checkpoint.py``'s table)
PRECISION_MAP = {
    "32-true": "32-true", "32": "32-true", "64-true": "32-true",
    "64": "32-true",
    "bf16-mixed": "bf16-mixed", "bf16-true": "bf16-mixed",
    "16-mixed": "bf16-mixed", "16-true": "bf16-mixed", "16": "bf16-mixed",
}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _rename(part: str) -> str:
    m = _LIST.match(part)
    if m:
        return f"{m.group(1)}.{m.group(2)}"
    m = _AUTO.match(part)
    return f"dense_{m.group(1)}" if m else part


def jax_params_to_state_dict(params) -> dict:
    """Nested flax params (numpy leaves) -> {name: torch.Tensor}."""
    sd = {}
    for path, leaf in _flatten(params):
        arr = np.asarray(leaf)
        *mods, name = path
        if name == "kernel":
            name, arr = "weight", arr.T
        elif name in ("embedding", "scale"):
            name = "weight"
        key = ".".join([_rename(m) for m in mods] + [name])
        sd[key] = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))
    return sd


# -- the reference layout -> the flax tree (copied) ----------------------------


def _dense(sd, name):
    return {
        "kernel": np.ascontiguousarray(sd[f"{name}.weight"].T),
        "bias": np.ascontiguousarray(sd[f"{name}.bias"]),
    }


def _layer_norm(sd, name):
    return {
        "scale": np.ascontiguousarray(sd[f"{name}.weight"]),
        "bias": np.ascontiguousarray(sd[f"{name}.bias"]),
    }


def _mha(sd, name):
    """Reference fairseq-style MultiheadAttention -> RoPEAttention params."""
    wq, wk, wv = (sd[f"{name}.attn.{p}_proj.weight"] for p in "qkv")
    bq, bk, bv = (sd[f"{name}.attn.{p}_proj.bias"] for p in "qkv")
    out = {
        "qkv_proj": {
            "kernel": np.concatenate([wq.T, wk.T, wv.T], axis=1),
            "bias": np.concatenate([bq, bk, bv]),
        },
        "out_proj": _dense(sd, f"{name}.attn.out_proj"),
    }
    if f"{name}.attn.bias_k" in sd:
        out["bias_k"] = np.ascontiguousarray(sd[f"{name}.attn.bias_k"])
        out["bias_v"] = np.ascontiguousarray(sd[f"{name}.attn.bias_v"])
    return out


def _ipa(sd, name, *, c_hidden, no_heads, no_qk_points, no_v_points):
    """Reference OpenFold-style IPA -> fused-projection IPA params."""
    H, ch, Pq, Pv = no_heads, c_hidden, no_qk_points, no_v_points

    # scalar q/kv fusion: per-head [q | k | v] blocks
    wq = sd[f"{name}.linear_q.weight"].T  # [C, H*ch], col h*ch + c
    wkv = sd[f"{name}.linear_kv.weight"].T  # [C, 2*H*ch], col h*2ch + {k: c, v: ch+c}
    bq = sd[f"{name}.linear_q.bias"]
    bkv = sd[f"{name}.linear_kv.bias"]
    C = wq.shape[0]
    qkv_w = np.empty((C, 3 * H * ch), wq.dtype)
    qkv_b = np.empty((3 * H * ch,), bq.dtype)
    for h in range(H):
        o = h * 3 * ch
        qkv_w[:, o : o + ch] = wq[:, h * ch : (h + 1) * ch]
        qkv_w[:, o + ch : o + 2 * ch] = wkv[:, h * 2 * ch : h * 2 * ch + ch]
        qkv_w[:, o + 2 * ch : o + 3 * ch] = wkv[:, h * 2 * ch + ch : (h + 1) * 2 * ch]
        qkv_b[o : o + ch] = bq[h * ch : (h + 1) * ch]
        qkv_b[o + ch : o + 2 * ch] = bkv[h * 2 * ch : h * 2 * ch + ch]
        qkv_b[o + 2 * ch : o + 3 * ch] = bkv[h * 2 * ch + ch : (h + 1) * 2 * ch]

    # point fusion: reference layout is [x | y | z] blocks of width H*P with
    # entries h*P + p; flax layout is flat (h*(2Pq+Pv) + slot)*3 + xyz,
    # slots = [q | k | v] pts
    wqp = sd[f"{name}.linear_q_points.weight"].T  # [C, H*Pq*3]
    wkvp = sd[f"{name}.linear_kv_points.weight"].T  # [C, H*(Pq+Pv)*3]
    bqp = sd[f"{name}.linear_q_points.bias"]
    bkvp = sd[f"{name}.linear_kv_points.bias"]
    n_slots = 2 * Pq + Pv
    pts_w = np.empty((C, H * n_slots * 3), wqp.dtype)
    pts_b = np.empty((H * n_slots * 3,), bqp.dtype)
    for h in range(H):
        for slot in range(n_slots):
            if slot < Pq:  # q point
                src_w, src_b, idx = wqp, bqp, h * Pq + slot
                width = H * Pq
            else:  # k/v point (kv layout: [k_pts | v_pts] per head)
                src_w, src_b = wkvp, bkvp
                idx = h * (Pq + Pv) + (slot - Pq)
                width = H * (Pq + Pv)
            for xyz in range(3):
                dst = (h * n_slots + slot) * 3 + xyz
                pts_w[:, dst] = src_w[:, xyz * width + idx]
                pts_b[dst] = src_b[xyz * width + idx]

    return {
        "linear_qkv": {"kernel": qkv_w, "bias": qkv_b},
        "linear_points": {"kernel": pts_w, "bias": pts_b},
        "head_weights": np.ascontiguousarray(sd[f"{name}.head_weights"]),
        "linear_out": _dense(sd, f"{name}.linear_out"),
    }


def port_reference_state_dict(state_dict, cfg, latent_dim: int) -> dict:
    """Reference ``LatentMDGenModel.state_dict()`` (tensors or numpy arrays)
    -> the flax params tree, numpy leaves.

    Covers all four task modes. ``state_dict`` keys use the reference names
    (no ``model.`` prefix). Buffers (pos_embed/time_embed) are skipped: the
    model computes the identical sin-cos tables.
    """
    sd = {
        k: np.asarray(getattr(v, "detach", lambda: v)().cpu().numpy()
                      if hasattr(v, "cpu") else v)
        for k, v in state_dict.items()
    }
    ipa_dims = dict(
        c_hidden=cfg.ipa_head_dim,
        no_heads=cfg.ipa_heads,
        no_qk_points=cfg.ipa_qk,
        no_v_points=cfg.ipa_v,
    )
    C, n = cfg.embed_dim, cfg.num_layers
    params: dict = {}

    params["latent_to_emb"] = _dense(sd, "latent_to_emb")
    if cfg.tps_condition or cfg.inpainting or cfg.dynamic_mpnn:
        params["latent_to_emb_f"] = _dense(sd, "latent_to_emb_f")
        params["latent_to_emb_r"] = _dense(sd, "latent_to_emb_r")
    params["cond_to_emb"] = _dense(sd, "cond_to_emb")
    params["mask_to_emb"] = {
        "embedding": np.ascontiguousarray(sd["mask_to_emb.weight"])
    }
    if cfg.design:
        params["x_d_to_emb"] = _dense(sd, "x_d_to_emb")
        for fc in ("fc1", "fc2", "fc3"):
            params[fc] = _dense(sd, fc)
        params["emb_to_logits"] = _dense(sd, "emb_to_logits")

    if cfg.prepend_ipa:
        if not cfg.no_aa_emb:
            params["aatype_to_emb"] = {
                "embedding": np.ascontiguousarray(sd["aatype_to_emb.weight"])
            }
        ipa_w = np.empty((C, 6 * C * n), np.float32)
        ipa_b = np.empty((6 * C * n,), np.float32)
        for i in range(n):
            ipa_w[:, i * 6 * C : (i + 1) * 6 * C] = sd[
                f"ipa_layers.{i}.adaLN_modulation.1.weight"
            ].T
            ipa_b[i * 6 * C : (i + 1) * 6 * C] = sd[
                f"ipa_layers.{i}.adaLN_modulation.1.bias"
            ]
            pre = f"ipa_layers.{i}"
            params[f"ipa_layers_{i}"] = {
                "ipa_norm": _layer_norm(sd, f"{pre}.ipa_norm"),
                "ipa": _ipa(sd, f"{pre}.ipa", **ipa_dims),
                "mha_l": _mha(sd, f"{pre}.mha_l"),
                "fc1": _dense(sd, f"{pre}.fc1"),
                "fc2": _dense(sd, f"{pre}.fc2"),
            }
        params["ipa_adaln"] = {"kernel": ipa_w, "bias": ipa_b}

    trunk_w = np.empty((C, 9 * C * n), np.float32)
    trunk_b = np.empty((9 * C * n,), np.float32)
    for i in range(n):
        trunk_w[:, i * 9 * C : (i + 1) * 9 * C] = sd[
            f"layers.{i}.adaLN_modulation.1.weight"
        ].T
        trunk_b[i * 9 * C : (i + 1) * 9 * C] = sd[
            f"layers.{i}.adaLN_modulation.1.bias"
        ]
        pre = f"layers.{i}"
        layer = {
            "mha_l": _mha(sd, f"{pre}.mha_l"),
            "fc1": _dense(sd, f"{pre}.fc1"),
            "fc2": _dense(sd, f"{pre}.fc2"),
        }
        if cfg.hyena:
            raise NotImplementedError(
                "hyena weight port not implemented (reference HyenaOperator "
                "parameterization); train natively instead"
            )
        layer["mha_t"] = _mha(sd, f"{pre}.mha_t")
        if cfg.interleave_ipa:
            layer["ipa_norm"] = _layer_norm(sd, f"{pre}.ipa_norm")
            layer["ipa"] = _ipa(sd, f"{pre}.ipa", **ipa_dims)
        params[f"layers_{i}"] = layer
    params["trunk_adaln"] = {"kernel": trunk_w, "bias": trunk_b}

    params["t_embedder"] = {
        "Dense_0": _dense(sd, "t_embedder.mlp.0"),
        "Dense_1": _dense(sd, "t_embedder.mlp.2"),
    }
    if not (cfg.dynamic_mpnn or cfg.mpnn):
        params["emb_to_latent"] = {
            "Dense_0": _dense(sd, "emb_to_latent.adaLN_modulation.1"),
            "Dense_1": _dense(sd, "emb_to_latent.linear"),
        }

    return params


def reference_to_state_dict(state_dict, cfg) -> dict:
    """Reference state dict (no ``model.`` prefix) -> port state dict, for
    ``LatentMDGenModel.load_state_dict(..., strict=True)``."""
    return jax_params_to_state_dict(port_reference_state_dict(state_dict, cfg, cfg.latent_dim))


# -- the inverse: port state dict -> the reference layout ----------------------

# port names -> reference names of the modules whose layout is the same
_RENAMES = (("t_embedder.dense_0.", "t_embedder.mlp.0."),
            ("t_embedder.dense_1.", "t_embedder.mlp.2."),
            ("emb_to_latent.dense_0.", "emb_to_latent.adaLN_modulation.1."),
            ("emb_to_latent.dense_1.", "emb_to_latent.linear."))


def _split_mha(sd, pre, out):
    w, b = sd.pop(f"{pre}.qkv_proj.weight"), sd.pop(f"{pre}.qkv_proj.bias")
    for p, wp, bp in zip("qkv", w.chunk(3, dim=0), b.chunk(3)):
        out[f"{pre}.attn.{p}_proj.weight"], out[f"{pre}.attn.{p}_proj.bias"] = wp, bp
    for k in ("out_proj.weight", "out_proj.bias", "bias_k", "bias_v"):
        if f"{pre}.{k}" in sd:
            out[f"{pre}.attn.{k}"] = sd.pop(f"{pre}.{k}")


def _split_ipa(sd, pre, cfg, out):
    H, ch, Pq, Pv = cfg.ipa_heads, cfg.ipa_head_dim, cfg.ipa_qk, cfg.ipa_v
    w, b = sd.pop(f"{pre}.linear_qkv.weight"), sd.pop(f"{pre}.linear_qkv.bias")
    blocks = [(w[h * 3 * ch:(h + 1) * 3 * ch], b[h * 3 * ch:(h + 1) * 3 * ch]) for h in range(H)]
    out[f"{pre}.linear_q.weight"] = torch.cat([bw[:ch] for bw, _ in blocks])
    out[f"{pre}.linear_q.bias"] = torch.cat([bb[:ch] for _, bb in blocks])
    out[f"{pre}.linear_kv.weight"] = torch.cat([bw[ch:] for bw, _ in blocks])
    out[f"{pre}.linear_kv.bias"] = torch.cat([bb[ch:] for _, bb in blocks])
    # flax row (h*(2Pq+Pv) + slot)*3 + xyz -> OpenFold row xyz*H*P + h*P + p
    w, b = sd.pop(f"{pre}.linear_points.weight"), sd.pop(f"{pre}.linear_points.bias")
    w = w.reshape(H, 2 * Pq + Pv, 3, -1)
    b = b.reshape(H, 2 * Pq + Pv, 3)
    for name, sl in (("linear_q_points", slice(0, Pq)), ("linear_kv_points", slice(Pq, None))):
        out[f"{pre}.{name}.weight"] = w[:, sl].permute(2, 0, 1, 3).reshape(-1, w.shape[-1])
        out[f"{pre}.{name}.bias"] = b[:, sl].permute(2, 0, 1).reshape(-1)
    for k in ("head_weights", "linear_out.weight", "linear_out.bias"):
        out[f"{pre}.{k}"] = sd.pop(f"{pre}.{k}")


def state_dict_to_reference(state_dict, cfg) -> dict:
    """Port state dict -> the reference's keys and layouts, the inverse of
    :func:`reference_to_state_dict` (Hyena raises, as the forward map)."""
    if cfg.hyena:
        raise NotImplementedError("hyena weights have no reference layout")
    sd = {k: v.detach().cpu().float().clone() for k, v in state_dict.items()}
    out = {}
    C, n = cfg.embed_dim, cfg.num_layers
    for tower, width in (("ipa_layers", 6), ("layers", 9)):
        adaln = "ipa_adaln" if tower == "ipa_layers" else "trunk_adaln"
        if f"{adaln}.weight" not in sd:
            continue
        w, b = sd.pop(f"{adaln}.weight"), sd.pop(f"{adaln}.bias")
        for i in range(n):
            rows = slice(i * width * C, (i + 1) * width * C)
            out[f"{tower}.{i}.adaLN_modulation.1.weight"] = w[rows]
            out[f"{tower}.{i}.adaLN_modulation.1.bias"] = b[rows]
            pre = f"{tower}.{i}"
            for mha in ("mha_l", "mha_t"):
                if f"{pre}.{mha}.qkv_proj.weight" in sd:
                    _split_mha(sd, f"{pre}.{mha}", out)
            if f"{pre}.ipa.linear_qkv.weight" in sd:
                _split_ipa(sd, f"{pre}.ipa", cfg, out)
    for k, v in sd.items():
        for old, new in _RENAMES:
            if k.startswith(old):
                k = new + k[len(old):]
        out[k] = v
    return {k: v.contiguous() for k, v in out.items()}


def write_lightning_checkpoint(path: str, cfg, state_dict, ema_state_dict=None,
                               global_step: int = 0, precision: str | None = None) -> None:
    """A reference-format ``.ckpt`` of a port model: the reference layout
    under ``model.`` in ``state_dict``, ``hyper_parameters.args`` (the
    config's fields as an ``argparse.Namespace``, ``precision`` as a
    Lightning string), ``ema`` ({"params", "decay"}) when given, and
    ``global_step``."""
    import argparse
    import dataclasses

    args = dataclasses.asdict(cfg)
    args["precision"] = precision or cfg.precision
    ckpt = {
        "state_dict": {f"model.{k}": v
                       for k, v in state_dict_to_reference(state_dict, cfg).items()},
        "hyper_parameters": {"args": argparse.Namespace(**args)},
        "global_step": int(global_step),
    }
    if ema_state_dict is not None:
        ckpt["ema"] = {"params": state_dict_to_reference(ema_state_dict, cfg),
                       "decay": cfg.ema_decay}
    torch.save(ckpt, path)
