"""The JAX runtime's optimizer (``mdgen_tpu/runtime/wrapper.py:174-180``),
written out in torch with optax 0.2.6's semantics:

  optax.chain(clip_by_global_norm(grad_clip), adam(lr) | adamw(lr)),
  wrapped in optax.MultiSteps(every_k_schedule=accumulate_grad) when > 1.

Where these differ from ``torch.optim`` and ``clip_grad_norm_``:
  * clipping scales by ``max_norm / norm`` only when ``norm >= max_norm``,
    as ``(g / norm) * max_norm``, with no +1e-6;
  * Adam: mu = (1-b1) g + b1 mu, nu = (1-b2) g^2 + b2 nu, update =
    (mu / (1-b1^n)) / (sqrt(nu / (1-b2^n)) + eps), eps = 1e-8 outside the
    root; AdamW adds ``weight_decay * p`` (optax's default 1e-4, not torch's
    1e-2) before the step of size lr;
  * MultiSteps keeps the running mean of k micro-batch gradients and applies
    clip and Adam on every k-th call only; the other calls leave the
    parameters as they are.
The state is a dict of tensors and ints, saved with the checkpoint. Under
tensor parallelism the parameters, gradients and moments are this rank's
shards; ``norm`` is then the global norm over every shard
(``TrainRuntime``), so every rank clips by the one-process norm.

A step that applies an update clips, runs Adam and moves the EMA copy (the
train step's, when it keeps one) in one pass over every tensor
(``ops.fused_adam``: one kernel on the card, the eager loop on the CPU); the
global norm is ``ops.sum_of_squares``, one more kernel. MultiSteps' other
calls move only the EMA, with the eager loop.
"""
from __future__ import annotations

import torch

from .. import ops
from ..ops.fused_optim import ema_update_plain


class Optimizer:
    def __init__(self, lr: float, grad_clip: float, adamw: bool = False,
                 accumulate_grad: int = 1, weight_decay: float = 1e-4,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, norm=None,
                 ema_decay: float = 0.999):
        if accumulate_grad < 1:
            raise ValueError(f"accumulate_grad must be >= 1, got {accumulate_grad}")
        self.lr, self.grad_clip = lr, grad_clip
        self.weight_decay = weight_decay if adamw else 0.0
        self.k = accumulate_grad
        self.b1, self.b2, self.eps = b1, b2, eps
        self.norm = norm or global_norm  # gradients -> their global norm
        self.ema_decay = ema_decay

    @classmethod
    def from_config(cls, cfg, norm=None) -> "Optimizer":
        return cls(cfg.lr, cfg.grad_clip, adamw=cfg.adamW, accumulate_grad=cfg.accumulate_grad,
                   norm=norm, ema_decay=cfg.ema_decay)

    def init(self, params: list[torch.Tensor]) -> dict:
        zeros = lambda: [torch.zeros_like(p) for p in params]  # noqa: E731
        state = {"count": 0, "mu": zeros(), "nu": zeros()}
        if self.k > 1:
            state.update(mini_step=0, gradient_step=0, acc=zeros())
        return state

    @torch.no_grad()
    def step(self, params: list[torch.Tensor], grads: list[torch.Tensor], state: dict,
             norm=None, ema=None) -> None:
        """Update ``params``, ``state`` and the EMA copy ``ema`` (tensors like
        ``params``, or None) in place from one micro-batch's gradients.
        ``norm``: their global norm where the caller has it (else
        ``self.norm(grads)``); the k-th call of MultiSteps clips by the norm
        of the running mean instead. The EMA follows the parameters on every
        call."""
        if self.k == 1:
            self._apply(params, grads, state, self.norm(grads) if norm is None else norm, ema)
            return
        n = state["mini_step"]
        for acc, g in zip(state["acc"], grads):
            acc.add_((g - acc) / (n + 1))
        if n == self.k - 1:
            self._apply(params, state["acc"], state, self.norm(state["acc"]), ema)
            for acc in state["acc"]:
                acc.zero_()
            state["gradient_step"] += 1
        elif ema is not None:
            ema_update_plain(ema, params, self.ema_decay)
        state["mini_step"] = (n + 1) % self.k

    def _apply(self, params, grads, state, norm, ema) -> None:
        """Clip, Adam and the EMA in one pass (``ops.fused_adam``)."""
        count = state["count"] + 1
        ops.fused_adam(params, grads, state["mu"], state["nu"], ema, norm, count=count,
                       lr=self.lr, grad_clip=self.grad_clip, b1=self.b1, b2=self.b2,
                       eps=self.eps, weight_decay=self.weight_decay, ema_decay=self.ema_decay)
        state["count"] = count


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors (optax.global_norm)."""
    return ops.sum_of_squares(tensors, root=True)
