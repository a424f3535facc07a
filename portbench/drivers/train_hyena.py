"""Training cells of the Hyena trunk (``--hyena``): ``drivers.train`` with
the Hyena operator's leaves in place of each trunk layer's frame attention
(``layers.{i}.mha_t``), drawn in one call as ``weights.make`` draws, and the
reference's ``reference.hyena.Model`` for the check."""
from __future__ import annotations

import math

from .. import weights
from ..reference import hyena as rhyena
from .common import subseed
from .train import Driver as TrainDriver

FILTER_ORDER = 64  # the implicit filter's width, as MDGen builds the operator


def hyena_leaves(out: dict, name: str, C: int) -> None:
    """The order-2 operator's leaves in the program's registration order.
    No leaf starts at zero: projections N(0, 1/fan_in), biases N(0, 0.02^2),
    the short filter N(0, 1/3) (fan-in 3), the sine frequencies 1 + N(0,
    0.02^2) (published: 1), the filter's bias N(0, 1) (the published
    draw)."""
    weights._linear(out, 3 * C, C, name + ".in_proj")
    out[name + ".short_filter.weight"] = ((3 * C, 1, 3), 0.0, 3 ** -0.5)
    out[name + ".short_filter.bias"] = ((3 * C,), 0.0, 0.02)
    for i in range(3):
        out[f"{name}.filter_fn.sin_freq_{i}"] = ((1, FILTER_ORDER), 1.0, 0.02)
    out[name + ".filter_fn.bias"] = ((C,), 0.0, 1.0)
    weights._linear(out, FILTER_ORDER, 3, name + ".filter_fn.mlp_0")
    weights._linear(out, FILTER_ORDER, FILTER_ORDER, name + ".filter_fn.mlp_1")
    weights._linear(out, FILTER_ORDER, FILTER_ORDER, name + ".filter_fn.mlp_2")
    out[name + ".filter_fn.mlp_out.weight"] = ((C, FILTER_ORDER), 0.0, FILTER_ORDER ** -0.5)
    weights._linear(out, C, C, name + ".out_proj")


def layout(cfg: dict) -> dict:
    """``weights.layout`` with each ``layers.{i}.mha_t`` replaced, in place,
    by the Hyena operator's leaves."""
    out: dict = {}
    for key, spec in weights.layout(cfg).items():
        head, _, leaf = key.partition(".mha_t.")
        if not leaf:
            out[key] = spec
        elif leaf == "qkv_proj.weight":  # the first of the attention's leaves
            hyena_leaves(out, head + ".mha_t", cfg["embed_dim"])
    return out


def make(cfg: dict, generator, device) -> dict:
    """{name: float32 tensor on ``device``} from one draw of ``generator``:
    ``weights.make``'s draw over this file's layout (``weights.make`` takes
    ``weights.layout``'s)."""
    import torch

    spec = layout(cfg)
    sizes = [math.prod(shape) for shape, _, _ in spec.values()]
    flat = torch.randn(sum(sizes), generator=generator, device=device)
    out, at = {}, 0
    for (name, (shape, mean, std)), n in zip(spec.items(), sizes):
        out[name] = (flat[at:at + n] * std + mean).reshape(shape)
        at += n
    return out


class Driver(TrainDriver):
    def _weights(self):
        import torch

        g = torch.Generator(device=self.device).manual_seed(subseed(self.seed, "weights"))
        return make(self.cfg, g, self.device)

    def reference(self, prec=None, rows=None, keep=False) -> dict:
        with rhyena.hyena_trunk():
            return super().reference(prec, rows, keep)
