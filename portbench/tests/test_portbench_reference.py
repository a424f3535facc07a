"""The benchmark's reference held to the port on the CPU at tiny widths:
tokens, the forward, three train steps with clip, Adam and the EMA (4AA and
ATLAS, with a padded protein and the left-context column)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import weights
from portbench.drivers.train import gaps
from portbench.reference import constants as rc
from portbench.reference import model as R
from portbench.reference import precision as P
from portbench.reference import train as RT
from portbench.synthetic import synthetic_trajectory

from .conftest import TINY_MODEL

BASE = dict(TINY_MODEL, sim_condition=True, prepend_ipa=True, abs_pos_emb=True,
            abs_time_emb=True, time_multiplier=100.0, lr=1e-3, grad_clip=1.0, ema_decay=0.99,
            latent_dim=21)


def _program(cfg: dict):
    from mdgen_tpu_torch.config import MDGenConfig

    return MDGenConfig(**{k: v for k, v in cfg.items() if k in MDGenConfig.__dataclass_fields__})


def _peptides(T, seqs=("ACDE", "FGHK"), seed=0):
    a14 = np.stack([synthetic_trajectory(s, T, seed + i).astype(np.float32)
                    for i, s in enumerate(seqs)])
    return {"atom14": torch.tensor(a14),
            "seqres": torch.tensor(np.stack([rc.str_sequence_to_aatype(s) for s in seqs])).long(),
            "mask": torch.ones(len(seqs), len(seqs[0]))}


def _atlas(T, crop):
    """Two ATLAS items of ``crop + 1`` columns: a crop with its left context
    and a short chain padded, with a zero context column."""
    long, short = "ACDEFGHIKLMNPQRSTVWY", "MKTAY"
    a = synthetic_trajectory(long, T, 1).astype(np.float32)[:, 2:crop + 3]
    b = synthetic_trajectory(short, T, 2).astype(np.float32)
    pad = np.zeros((T, crop + 1, 14, 3), np.float32)
    pad[:, 1:len(short) + 1] = b
    seq_a = rc.str_sequence_to_aatype(long)[2:crop + 3]
    seq_b = np.zeros(crop + 1, np.int64)
    seq_b[1:len(short) + 1] = rc.str_sequence_to_aatype(short)
    mask_b = np.zeros(crop + 1, np.float32)
    mask_b[1:len(short) + 1] = 1
    return {"atom14": torch.tensor(np.stack([a, pad])),
            "seqres": torch.tensor(np.stack([seq_a, seq_b])).long(),
            "mask": torch.tensor(np.stack([np.ones(crop + 1, np.float32), mask_b]))}


@pytest.mark.parametrize("atlas", [False, True])
def test_tokens_and_forward_equal_the_program(atlas):
    from mdgen_tpu_torch.models import LatentMDGenModel
    from mdgen_tpu_torch.runtime.wrapper import tokenize
    from mdgen_tpu_torch.tasks import prep_batch

    cfg = dict(BASE, crop=8 if atlas else 4, num_frames=6, atlas=atlas)
    batch = _atlas(6, 8) if atlas else _peptides(6)
    pcfg = _program(cfg)
    prep = prep_batch(pcfg, tokenize(pcfg, batch))
    tok = R.tokenize(batch["atom14"], batch["seqres"], batch["mask"], drop_left_context=atlas)
    latents, loss_mask, inputs = R.prepare(tok)
    assert torch.equal(loss_mask, prep.loss_mask)
    assert torch.allclose(latents, prep.latents, atol=1e-6)
    w = weights.make(cfg, torch.Generator().manual_seed(3), "cpu")
    model = LatentMDGenModel(pcfg, 21)
    model.load_state_dict(w)
    x, t = torch.randn(latents.shape, generator=torch.Generator().manual_seed(4)), torch.rand(2)
    want = model(x, t, **prep.model_kwargs)
    got = R.Model(cfg, w, P.Precision("f32"))(x, t, inputs)
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("atlas", [False, True])
def test_three_train_steps_equal_the_program(atlas):
    from mdgen_tpu_torch.runtime import TrainRuntime

    cfg = dict(BASE, crop=8 if atlas else 4, num_frames=6, atlas=atlas, ema=not atlas,
               grad_checkpointing=atlas)
    batch = _atlas(6, 8) if atlas else _peptides(6)
    w = weights.make(cfg, torch.Generator().manual_seed(5), "cpu")
    rt = TrainRuntime(_program(cfg), "cpu")
    state = rt.init(state_dict=w)
    names = [n for n, _ in state.model.named_parameters()]
    g = torch.Generator().manual_seed(6)
    L = cfg["crop"]
    draws = [(torch.rand(2, generator=g), torch.randn(2, 6, L, 21, generator=g)) for _ in range(3)]
    prog = {"losses": []}
    for i, (t, x0) in enumerate(draws):
        state, m = rt.train_step(state, batch, None, t, x0)
        prog["losses"].append(float(m["loss"]))
        if i == 0:
            mus = state.opt_state["mu"]
            prog["grad"] = {n: float(mu.norm() / 0.1) for n, mu in zip(names, mus)}
    prog["change"] = {n: float((p.detach() - w[n]).norm())
                      for n, p in state.model.named_parameters()}
    if state.ema is not None:
        prog["ema_change"] = {n: float((p - w[n]).norm()) for n, p in state.ema.named_parameters()}
    ref = RT.train_steps(cfg, w, [batch] * 3, draws, P.Precision("f32"), drop_left_context=atlas)
    got = gaps(prog, ref)
    want = {"loss_gap", "grad_gap", "update_gap", "update_gap_median"} \
        | (set() if atlas else {"ema_gap"})
    assert set(got) == want
    assert max(got.values()) < 1e-4, got
