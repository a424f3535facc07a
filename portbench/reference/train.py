"""The reference training step: flow-matching loss on the GVP path, global
norm clipping and Adam (optax's semantics: clip only when the norm reaches
the limit; bias corrections in float32; eps outside the root), and the EMA.
"""
from __future__ import annotations

import math

import torch

from .model import Model, prepare, tokenize


def loss(model: Model, batch: dict, t, x0, drop_left_context=False):
    """Mean over rows of the masked mean squared velocity error."""
    tok = tokenize(batch["atom14"], batch["seqres"], batch["mask"], drop_left_context)
    x1, loss_mask, inputs = prepare(tok)
    te = t[:, None, None, None]
    a, da = torch.sin(te * math.pi / 2), math.pi / 2 * torch.cos(te * math.pi / 2)
    s, ds = torch.cos(te * math.pi / 2), -math.pi / 2 * torch.sin(te * math.pi / 2)
    xt, ut = a * x1 + s * x0, da * x1 + ds * x0
    pred = model(xt, t, inputs)
    rows = ((pred - ut) ** 2 * loss_mask).sum((1, 2, 3)) / loss_mask.sum((1, 2, 3))
    return rows.mean()


@torch.no_grad()
def _leaf_norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in tensors.items()}


def train_steps(cfg: dict, params: dict, batches: list, draws: list, prec,
                drop_left_context=False, keep=False) -> dict:
    """Runs len(batches) steps from ``params`` (left untouched). Returns
    {"losses": [...], "grad": {leaf: the norm of the first step's gradient
    after clipping}, "change": {leaf: |p_n - p_0|}, "ema_change": likewise
    for the EMA (with ``cfg["ema"]``)}, and with ``keep`` also "grad_t" and
    "change_t": those two as tensors on the host, leaf by leaf."""
    lr, clip, d = cfg["lr"], cfg["grad_clip"], cfg["ema_decay"]
    b1, b2, eps = 0.9, 0.999, 1e-8
    names = list(params)
    p0 = {k: v.detach().float() for k, v in params.items()}
    P = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
    mu = {k: torch.zeros_like(v) for k, v in p0.items()}
    nu = {k: torch.zeros_like(v) for k, v in p0.items()}
    ema = {k: v.clone() for k, v in p0.items()} if cfg.get("ema") else None
    model = Model(cfg, P, prec)
    out = {"losses": []}
    for n, (batch, (t, x0)) in enumerate(zip(batches, draws), start=1):
        with prec.matmuls():
            value = loss(model, batch, t, x0, drop_left_context)
            grads = torch.autograd.grad(value, [P[k] for k in names], allow_unused=True)
        out["losses"].append(float(value.detach()))
        g = {k: torch.zeros_like(P[k]) if gr is None else gr for k, gr in zip(names, grads)}
        del value, grads
        with torch.no_grad():
            norm = torch.sqrt(sum((v ** 2).sum() for v in g.values()))
            if float(norm) >= clip:
                g = {k: (v / norm) * clip for k, v in g.items()}
            if n == 1:
                out["grad"] = _leaf_norms(g)
                if keep:
                    out["grad_t"] = {k: v.detach().float().cpu() for k, v in g.items()}
            bc1 = 1 - torch.tensor(b1) ** n
            bc2 = 1 - torch.tensor(b2) ** n
            for k in names:
                mu[k] = (1 - b1) * g[k] + b1 * mu[k]
                nu[k] = (1 - b2) * g[k] ** 2 + b2 * nu[k]
                u = (mu[k] / bc1.item()) / (torch.sqrt(nu[k] / bc2.item()) + eps)
                P[k].add_(-lr * u)
                if ema is not None:
                    ema[k] = ema[k] * d + (1 - d) * P[k]
        del g
    out["change"] = _leaf_norms({k: P[k].detach() - p0[k] for k in names})
    if keep:
        out["change_t"] = {k: (P[k].detach() - p0[k]).cpu() for k in names}
    if ema is not None:
        out["ema_change"] = _leaf_norms({k: ema[k] - p0[k] for k in names})
    return out
