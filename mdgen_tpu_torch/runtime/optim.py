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
The state is a dict of tensors and ints, saved with the checkpoint.
"""
from __future__ import annotations

import torch


class Optimizer:
    def __init__(self, lr: float, grad_clip: float, adamw: bool = False,
                 accumulate_grad: int = 1, weight_decay: float = 1e-4,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        if accumulate_grad < 1:
            raise ValueError(f"accumulate_grad must be >= 1, got {accumulate_grad}")
        self.lr, self.grad_clip = lr, grad_clip
        self.weight_decay = weight_decay if adamw else 0.0
        self.k = accumulate_grad
        self.b1, self.b2, self.eps = b1, b2, eps

    @classmethod
    def from_config(cls, cfg) -> "Optimizer":
        return cls(cfg.lr, cfg.grad_clip, adamw=cfg.adamW, accumulate_grad=cfg.accumulate_grad)

    def init(self, params: list[torch.Tensor]) -> dict:
        zeros = lambda: [torch.zeros_like(p) for p in params]  # noqa: E731
        state = {"count": 0, "mu": zeros(), "nu": zeros()}
        if self.k > 1:
            state.update(mini_step=0, gradient_step=0, acc=zeros())
        return state

    @torch.no_grad()
    def step(self, params: list[torch.Tensor], grads: list[torch.Tensor], state: dict) -> None:
        """Update ``params`` and ``state`` in place from one micro-batch's
        gradients."""
        if self.k == 1:
            self._clip_adam(params, grads, state)
            return
        n = state["mini_step"]
        for acc, g in zip(state["acc"], grads):
            acc.add_((g - acc) / (n + 1))
        if n == self.k - 1:
            self._clip_adam(params, state["acc"], state)
            for acc in state["acc"]:
                acc.zero_()
            state["gradient_step"] += 1
        state["mini_step"] = (n + 1) % self.k

    def _clip_adam(self, params, grads, state) -> None:
        norm = global_norm(grads)
        keep = norm < self.grad_clip
        count = state["count"] + 1
        # the bias corrections in f32, as optax computes them
        dev = params[0].device
        bc1 = (1 - torch.tensor(self.b1) ** count).to(dev)
        bc2 = (1 - torch.tensor(self.b2) ** count).to(dev)
        for p, g, mu, nu in zip(params, grads, state["mu"], state["nu"]):
            g = torch.where(keep, g, (g / norm) * self.grad_clip)
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * g**2 + self.b2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p
            p.add_(-self.lr * u)
        state["count"] = count


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors (optax.global_norm)."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))
