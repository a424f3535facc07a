"""How the reference computes, and the control's lower precisions.

``Precision("f32")`` is the reference: every product in float32 with TF32
off. The controls compute the same arithmetic one step lower than the
configuration states: ``"tf32"`` for a ``32-true`` configuration (the
matmuls and einsums on TF32 tensor cores), ``"fp8"`` for a ``bf16-mixed``
one (every value that the configuration computes in bf16, weights,
activations and products alike, rounded to float8 e4m3 with a scale of its
own tensor's largest magnitude over 448, the format's largest number).
"""
from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0


class Precision:
    def __init__(self, mode: str = "f32", low: bool = False):
        """``low``: the configuration computes in bf16 where the model says
        so (``bf16-mixed``); only then does ``"fp8"`` round anything."""
        if mode not in ("f32", "tf32", "fp8"):
            raise ValueError(f"precision mode {mode!r}")
        self.mode, self.low = mode, low

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """A value the configuration holds in its compute dtype."""
        if self.mode != "fp8" or not self.low:
            return x
        scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
        xq = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
        # the rounded value forward, the gradient straight through
        return x + (xq - x.detach()) if x.requires_grad else xq

    @contextlib.contextmanager
    def matmuls(self):
        """TF32 on for ``"tf32"``, off otherwise; restored after."""
        old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        on = self.mode == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def control_mode(precision: str) -> str:
    """The control's mode for a configuration's stated precision."""
    return {"32-true": "tf32", "bf16-mixed": "fp8"}[precision]
