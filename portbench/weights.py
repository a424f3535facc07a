"""Seeded weights for both sides: every tensor of the model, named as the
program's ``state_dict`` names them, drawn on the device in one call.

No leaf starts at zero, so every path of the model carries signal from the
first step: weights N(0, 1/fan_in), biases N(0, 0.02^2), the adaLN
producers N(0, 0.25/fan_in) (gates of about 0.25), embeddings N(0, 1),
layer-norm scales 1 + N(0, 0.02^2), the IPA head weights about
softplus^-1(1), the bias key and value N(0, 2/(1 + C)).
"""
from __future__ import annotations

import math

import torch


def _linear(out, n_out, n_in, name, std=None):
    out[name + ".weight"] = ((n_out, n_in), 0.0, std if std is not None else n_in ** -0.5)
    out[name + ".bias"] = ((n_out,), 0.0, 0.02)


def _attention(out, name, C):
    _linear(out, 3 * C, C, name + ".qkv_proj")
    _linear(out, C, C, name + ".out_proj")
    std = math.sqrt(2.0 / (1 + C))
    out[name + ".bias_k"] = ((1, 1, C), 0.0, std)
    out[name + ".bias_v"] = ((1, 1, C), 0.0, std)


def layout(cfg: dict) -> dict:
    """{name: (shape, mean, std)} of the sim-condition model with the
    prepended IPA tower, in the program's registration order."""
    C, nl, D = cfg["embed_dim"], cfg["num_layers"], cfg["latent_dim"]
    H, ch, Pq, Pv = cfg["ipa_heads"], cfg["ipa_head_dim"], cfg["ipa_qk"], cfg["ipa_v"]
    out: dict = {}
    _linear(out, C, D, "latent_to_emb")
    _linear(out, C, D, "cond_to_emb")
    out["mask_to_emb.weight"] = ((2, C), 0.0, 1.0)
    out["aatype_to_emb.weight"] = ((21, C), 0.0, 1.0)
    for i in range(nl):
        n = f"ipa_layers.{i}"
        _linear(out, 3 * H * ch, C, n + ".ipa.linear_qkv")
        _linear(out, H * (2 * Pq + Pv) * 3, C, n + ".ipa.linear_points")
        out[n + ".ipa.head_weights"] = ((H,), math.log(math.e - 1), 0.1)
        _linear(out, C, H * ch + H * Pv * 4, n + ".ipa.linear_out")
        out[n + ".ipa_norm.weight"] = ((C,), 1.0, 0.02)
        out[n + ".ipa_norm.bias"] = ((C,), 0.0, 0.02)
        _attention(out, n + ".mha_l", C)
        _linear(out, 4 * C, C, n + ".fc1")
        _linear(out, C, 4 * C, n + ".fc2")
    _linear(out, 6 * C * nl, C, "ipa_adaln", std=0.5 * C ** -0.5)
    for i in range(nl):
        n = f"layers.{i}"
        _attention(out, n + ".mha_l", C)
        _attention(out, n + ".mha_t", C)
        _linear(out, 4 * C, C, n + ".fc1")
        _linear(out, C, 4 * C, n + ".fc2")
    _linear(out, 9 * C * nl, C, "trunk_adaln", std=0.5 * C ** -0.5)
    _linear(out, 2 * C, C, "emb_to_latent.dense_0", std=0.5 * C ** -0.5)
    _linear(out, D, C, "emb_to_latent.dense_1")
    _linear(out, C, 256, "t_embedder.dense_0")
    _linear(out, C, C, "t_embedder.dense_1")
    return out


def make(cfg: dict, generator: torch.Generator, device) -> dict:
    """{name: float32 tensor on ``device``} from one draw of ``generator``."""
    spec = layout(cfg)
    sizes = [math.prod(shape) for shape, _, _ in spec.values()]
    flat = torch.randn(sum(sizes), generator=generator, device=device)
    out, at = {}, 0
    for (name, (shape, mean, std)), n in zip(spec.items(), sizes):
        out[name] = (flat[at:at + n] * std + mean).reshape(shape)
        at += n
    return out
