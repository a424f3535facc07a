"""The port's Hyena trunk held to the benchmark's plain reference
(``portbench/reference/hyena.py``) on the CPU at tiny widths, with seeded
weights drawn as the benchmark draws them (``drivers/train_hyena.py``):
the reference's long convolution against a direct sum, the operator alone,
the ``--hyena`` model's forward, three train steps with clip, Adam and the
EMA (``drivers.train.gaps``), the weight layout against the 34M program
model, and the three metric readers of the Hyena cell.

Tolerances, from the errors measured here: the long convolution 1e-5 of
the largest output (float32 FFTs of 1024 points against a sum of up to 64
terms in another order; measured 1e-7); the operator 1e-5 absolute and
relative (the program transforms at 2T points with its own scaling, the
reference at a multiple of 1024; measured 3e-7 on outputs up to 6); the
model 1e-5 as ``portbench/tests``' forward of the attention trunk (two
residual layers; measured 1e-6); the train steps 1e-5 on the losses, the
first gradient and the median leaf's change (measured 0, 4.6e-7 and 0),
1e-4 on the change of every leaf of the Hyena operators (measured 1.8e-6),
and 2e-3 on the worst leaf's change and EMA (measured 4.6e-4 and 3.2e-4):
that leaf is an IPA ``linear_qkv.bias``, whose key third has a gradient of
zero but for rounding (the softmax does not see it), which Adam divides by
its own root and so moves by as much as a real update, in another
direction on each side, as in the attention trunk.
"""
from __future__ import annotations

import math
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mdgen_tpu_torch import ops, tracing
from mdgen_tpu_torch.config import MDGenConfig
from mdgen_tpu_torch.models import LatentMDGenModel
from mdgen_tpu_torch.models.hyena import HyenaOperator
from mdgen_tpu_torch.runtime import TrainRuntime
from mdgen_tpu_torch.runtime.wrapper import tokenize
from mdgen_tpu_torch.tasks import prep_batch
from portbench import harness
from portbench.drivers import train_hyena
from portbench.drivers.common import leaf_gaps
from portbench.drivers.train import gaps
from portbench.reference import constants as rc
from portbench.reference import hyena as RH
from portbench.reference import model as R
from portbench.reference import precision as P
from portbench.reference import train as RT
from portbench.synthetic import synthetic_trajectory

CELL = "train-4aa-hyena-t10k-b4"
TINY = dict(num_layers=2, embed_dim=32, mha_heads=4, ipa_heads=2, ipa_head_dim=8, ipa_qk=4,
            ipa_v=4, sim_condition=True, prepend_ipa=True, abs_pos_emb=True, abs_time_emb=True,
            hyena=True, time_multiplier=100.0, lr=1e-3, grad_clip=1.0, ema=True,
            ema_decay=0.99, latent_dim=21, crop=4)


def _program(cfg: dict) -> MDGenConfig:
    return MDGenConfig(**{k: v for k, v in cfg.items() if k in MDGenConfig.__dataclass_fields__})


def _weights(cfg: dict, seed: int) -> dict:
    return train_hyena.make(cfg, torch.Generator().manual_seed(seed), "cpu")


def _peptides(T, seqs=("ACDE", "FGHK")):
    a14 = np.stack([synthetic_trajectory(s, T, i).astype(np.float32) for i, s in enumerate(seqs)])
    return {"atom14": torch.tensor(a14),
            "seqres": torch.tensor(np.stack([rc.str_sequence_to_aatype(s) for s in seqs])).long(),
            "mask": torch.ones(len(seqs), len(seqs[0]))}


def _direct_convolution(u, k):
    """The full linear convolution over the last axis by its sum, one input
    frame at a time."""
    T = u.shape[-1]
    out = u.new_zeros(*u.shape[:-1], 2 * T - 1)
    for j in range(T):
        out[..., j:j + T] += u[..., j:j + 1] * k
    return out


@pytest.mark.parametrize("T", [37, 64])
def test_the_long_convolution_is_its_sum(T):
    g = torch.Generator().manual_seed(T)
    u, k = torch.randn(3, 5, T, generator=g), torch.randn(5, T, generator=g)
    want = _direct_convolution(u, k)
    got = RH.linear_convolution(u, k)
    assert got.shape == (3, 5, 2 * T - 1)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("T", [37, 64])
def test_the_operator_equals_the_reference(T):
    """The program's ``HyenaOperator`` (fftconv at 2T points) against the
    reference's, both from the benchmark's draw of the operator's leaves."""
    C = TINY["embed_dim"]
    spec: dict = {}
    train_hyena.hyena_leaves(spec, "op", C)
    g = torch.Generator().manual_seed(T + 1)
    w = {k: torch.randn(shape, generator=g) * std + mean for k, (shape, mean, std) in spec.items()}
    op = HyenaOperator(C, l_max=T, order=2, filter_order=train_hyena.FILTER_ORDER)
    op.load_state_dict({k.removeprefix("op."): v for k, v in w.items()})
    u = torch.randn(6, T, C, generator=g)
    ref = RH.Model(dict(TINY, num_frames=T), w, P.Precision("f32"))
    want = ref.hyena(u, "op")
    with torch.no_grad():
        got = op(u)
    assert float(want.abs().max()) > 1.0
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_the_model_forward_equals_the_reference():
    T = 12
    cfg = dict(TINY, num_frames=T)
    pcfg = _program(cfg)
    batch = _peptides(T)
    prep = prep_batch(pcfg, tokenize(pcfg, batch))
    latents, _, inputs = R.prepare(R.tokenize(batch["atom14"], batch["seqres"], batch["mask"]))
    w = _weights(cfg, 3)
    model = LatentMDGenModel(pcfg, 21)
    model.load_state_dict(w)
    assert isinstance(model.layers[0].mha_t, HyenaOperator)
    x = torch.randn(latents.shape, generator=torch.Generator().manual_seed(4))
    t = torch.rand(2, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        want = model(x, t, **prep.model_kwargs)
    got = RH.Model(cfg, w, P.Precision("f32"))(x, t, inputs)
    assert float(got.abs().max()) > 0.1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_three_train_steps_equal_the_reference():
    """``TrainRuntime.train_step`` with clip, Adam and the EMA, read as the
    benchmark reads it, against ``reference.hyena.train_steps``."""
    T = 10
    cfg = dict(TINY, num_frames=T)
    batch = _peptides(T)
    w = _weights(cfg, 5)
    rt = TrainRuntime(_program(cfg), "cpu")
    state = rt.init(state_dict=w)
    names = [n for n, _ in state.model.named_parameters()]
    assert set(names) == set(w)
    g = torch.Generator().manual_seed(6)
    draws = [(torch.rand(2, generator=g), torch.randn(2, T, 4, 21, generator=g)) for _ in range(3)]
    prog = {"losses": []}
    ops.reset_launch_counts()
    for i, (t, x0) in enumerate(draws):
        state, m = rt.train_step(state, batch, None, t, x0)
        prog["losses"].append(float(m["loss"]))
        if i == 0:
            prog["grad"] = {n: float(mu.norm() / 0.1) for n, mu in zip(names, state.opt_state["mu"])}
    assert ops.launch_counts()["fftconv"] == 3 * cfg["num_layers"]
    prog["change"] = {n: float((p.detach() - w[n]).norm())
                      for n, p in state.model.named_parameters()}
    prog["ema_change"] = {n: float((p - w[n]).norm()) for n, p in state.ema.named_parameters()}
    with RH.hyena_trunk():
        ref = RT.train_steps(cfg, w, [batch] * 3, draws, P.Precision("f32"))
    assert RT.Model is R.Model  # the loop's module has its own model back
    got = gaps(prog, ref)
    assert set(got) == {"loss_gap", "grad_gap", "update_gap", "update_gap_median", "ema_gap"}
    assert max(got["loss_gap"], got["grad_gap"], got["update_gap_median"]) < 1e-5, got
    assert max(got["update_gap"], got["ema_gap"]) < 2e-3, got
    hyena = [n for n in names if ".mha_t." in n]
    assert max(leaf_gaps(prog["change"], ref["change"], hyena).values()) < 1e-4


def test_the_layout_loads_strictly_into_the_34m_model():
    """Names and shapes only: the driver's weights for the cell's own
    configuration against the program model on the meta device."""
    cell = harness.load_cell(CELL)
    cfg = harness.flat_config(cell.config)
    spec = train_hyena.layout(cfg)
    with torch.device("meta"):
        model = LatentMDGenModel(_program(cfg), cfg["latent_dim"])
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: s for k, (s, _, _) in spec.items()} == want
    model.load_state_dict({k: torch.empty(s, device="meta") for k, (s, _, _) in spec.items()},
                          strict=True, assign=True)
    assert not any(".mha_t.qkv_proj" in k for k in spec)
    assert all(std > 0 or mean != 0 for _, mean, std in spec.values())  # no leaf starts at zero
    n = sum(math.prod(s) for s, _, _ in spec.values())
    assert 33e6 < n < 35e6, n


@pytest.fixture(scope="module")
def cell():
    return harness.load_cell(CELL)


def _ctx(cell, name, **kw):
    m = cell.metrics[name]
    base = dict(t0=0.0, ends=[1.0, 2.0, 3.0], traced_units=1, trace=None, counters={},
                cfg=harness.flat_config(cell.config), meta=m.meta,
                driver=SimpleNamespace(shapes=lambda: (4, 10000, 4)))
    base.update(kw)
    return m, SimpleNamespace(**base)


def _trace(kernels=None, window_s=1.0):
    from portbench.trace import Summary

    return Summary(window_s=window_s, busy_s=0.5 * window_s, kernels=kernels or {})


def test_the_readers_give_none_without_what_they_read(cell, monkeypatch):
    monkeypatch.setattr(tracing, "_RING", type(tracing._RING)(maxlen=tracing._RING.maxlen))
    # no model.hyena span in the window's untraced units (the second and
    # third), and a program without the module
    m, ctx = _ctx(cell, "hyena_host_ms.train")
    assert m.meta["spans"] == ["model.hyena"] and m.read(ctx) is None
    ms = 1_000_000
    span = ("model.hyena", 0, "train.forward", 1)
    tracing._RING.extend([span + (500 * ms, 503 * ms), span + (2900 * ms, 3100 * ms)])
    assert m.read(ctx) is None  # in the traced unit, and past the window's end
    tracing._RING.extend([span + (1500 * ms, 1503 * ms), span + (2500 * ms, 2504 * ms)])
    assert m.read(ctx) == pytest.approx(3.5)  # 7 ms over 2 units
    import mdgen_tpu_torch

    monkeypatch.setitem(sys.modules, "mdgen_tpu_torch.tracing", None)
    monkeypatch.delattr(mdgen_tpu_torch, "tracing")
    assert m.read(ctx) is None
    # fftconv_roofline: no counter (the parent's counts), no call, no cuFFT kernel
    kernels = {k: [0.01, 10] for k in cell.metrics["fftconv_roofline.train"].meta["kernels"]}
    m, ctx = _ctx(cell, "fftconv_roofline.train", trace=_trace(kernels))
    assert m.read(ctx) is None
    ctx.counters = {"fftconv": 0}
    assert m.read(ctx) is None
    ctx.counters = {"fftconv": 15}
    assert (m.read(ctx) is not None) == bool(kernels)
    ctx.trace = _trace({"Kernel2": [0.1, 5]})
    assert m.read(ctx) is None
    ctx.trace = None
    assert m.read(ctx) is None
    # step_mfu_hyena: no trace, or a configuration without hyena
    m, ctx = _ctx(cell, "step_mfu_hyena.train")
    assert m.read(ctx) is None
    ctx.trace = _trace()
    assert m.read(ctx) > 0
    ctx.cfg = dict(ctx.cfg, hyena=False)
    assert m.read(ctx) is None
