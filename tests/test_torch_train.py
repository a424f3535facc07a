"""The port's training path against the JAX package's, on the CPU.

* ``Transport.training_losses`` for every path x prediction (and the
  score / noise loss weights), with JAX's own draws: t and x0 are
  regenerated from the key as ``transport.py:115-120`` splits it and passed
  in. Tolerance 1e-5 relative (f32).
* ``runtime/optim.py`` against optax itself (clip_by_global_norm, then adam
  or adamw, in MultiSteps), step by step, 1e-6 relative; a train step's one
  global norm, the one the clip uses; ``opt_state``'s layout through a
  checkpoint; the optimizer pass's plain loop on the CPU and the pointer
  table of its kernels' launches.
* Two train steps of the port's ``TrainRuntime`` against the JAX runtime's
  jitted ``train_step`` from the same parameters (seeded, noised so that
  the adaLN-zero gates are open), the same tokenized batch (the port's
  tokens, see the test) and the JAX step's own draws: at T=8 (dense
  attention) with Adam + EMA, AdamW + accumulate_grad 2 and bf16-mixed,
  and at T=520 (521 keys: the flash
  path, chunked attention in JAX on the CPU) with Adam + EMA. JAX runs under
  ``jax.default_matmul_precision("highest")``. Compared after each step:
  loss and grad_norm (f32: 1e-5 and 1e-4 relative), the parameter update
  as a whole, |d_port - d_jax| / |d_jax| <= 1e-3, and every parameter and
  EMA entry to 1e-4 absolute, a tenth of one Adam step (lr = 1e-3): the key
  biases' exact gradient is zero (softmax ignores a shift shared by all
  keys), so their Adam steps g / (|g| + 1e-8) follow rounding noise.
  bf16-mixed: both packages round the same operands to bf16, but their
  bf16 kernels sum in another order, and entries whose gradient is within
  that noise step the other way: loss and grad_norm 2e-2 relative, the
  update as a whole 0.1.
* Fault 1: a fused (forward-only) sublayer refuses autograd. (Dropout and
  gradient checkpointing, which the trainer refused until they were
  ported, are held in ``test_torch_atlas.py``; the ``--hyena`` model's
  steps are the case ``T8_dense_hyena`` here.)
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mdgen_tpu.config import MDGenConfig
from mdgen_tpu.runtime import MDGenRuntime as JaxRuntime
from mdgen_tpu.runtime.wrapper import TrainState as JaxTrainState
from mdgen_tpu.tasks import prep_batch as jax_prep
from mdgen_tpu.transport import Transport as JaxTransport
from mdgen_tpu.transport import TransportConfig as JaxTransportConfig
from mdgen_tpu_torch import ops
from mdgen_tpu_torch.config import MDGenConfig as PortConfig
from mdgen_tpu_torch.data import synthetic_trajectory
from mdgen_tpu_torch.geometry import constants as rc
from mdgen_tpu_torch.interop import _rename, jax_params_to_state_dict
from mdgen_tpu_torch.models import LatentMDGenModel
from mdgen_tpu_torch.runtime import TrainRuntime, batch_to_device, tokenize, tokenize_atom14
from mdgen_tpu_torch.runtime.checkpoint import load_train_checkpoint, save_train_checkpoint
from mdgen_tpu_torch.runtime.optim import Optimizer
from mdgen_tpu_torch.tasks import prep_batch
from mdgen_tpu_torch.transport import Transport, TransportConfig

SIM = dict(sim_condition=True, prepend_ipa=True, abs_pos_emb=True, abs_time_emb=True)
TINY = dict(num_layers=2, embed_dim=32, mha_heads=4, ipa_heads=2, ipa_head_dim=8, ipa_qk=2,
            ipa_v=2, crop=4, batch_size=2, lr=1e-3, **SIM)
SEQS = ("ACDE", "KLMW")


# -- losses --------------------------------------------------------------------

LOSS_CASES = [(p, pr, None) for p in ("Linear", "GVP", "VP")
              for pr in ("velocity", "score", "noise")]
LOSS_CASES += [("GVP", "score", "velocity"), ("GVP", "noise", "likelihood"),
               ("Linear", "score", "likelihood")]


@pytest.mark.parametrize("path,prediction,weight", LOSS_CASES,
                         ids=[f"{p}-{pr}-{w}" for p, pr, w in LOSS_CASES])
def test_training_losses_match_jax(path, prediction, weight):
    rng = np.random.default_rng(0)
    B, T, L, D = 3, 5, 4, 21
    x1 = rng.normal(size=(B, T, L, D)).astype(np.float32)
    mask = (rng.random((B, T, L, D)) > 0.2).astype(np.float32)
    W = (rng.normal(size=(D, D)) * 0.3).astype(np.float32)
    jt = JaxTransport(JaxTransportConfig(path_type=path, prediction=prediction, loss_weight=weight))
    key = jax.random.PRNGKey(7)
    with jax.default_matmul_precision("highest"):
        ref = jt.training_losses(
            key, lambda x, t: jnp.einsum("btld,de->btle", x, W) + t[:, None, None, None],
            jnp.asarray(x1), mask=jnp.asarray(mask))
    k_t, k_x0, _ = jax.random.split(key, 3)
    t0, t1 = jt.check_interval()
    t = np.asarray(jax.random.uniform(k_t, (B,), jnp.float32) * (t1 - t0) + t0)
    x0 = np.asarray(jax.random.normal(k_x0, x1.shape, jnp.float32))

    tt = Transport(TransportConfig(path_type=path, prediction=prediction, loss_weight=weight))
    assert tt.check_interval() == (t0, t1)
    Wt = torch.from_numpy(W)
    out = tt.training_losses(
        lambda x, t: torch.einsum("btld,de->btle", x, Wt) + t[:, None, None, None],
        torch.from_numpy(x1), torch.from_numpy(mask), t=torch.from_numpy(t.copy()),
        x0=torch.from_numpy(x0.copy()))
    np.testing.assert_allclose(out["loss"].numpy(), np.asarray(ref["loss"]), rtol=1e-5)
    np.testing.assert_allclose(out["pred"].numpy(), np.asarray(ref["pred"]), rtol=1e-5, atol=1e-6)
    # without t / x0 it draws them itself, inside the interval
    drawn = tt.training_losses(lambda x, t: x, torch.from_numpy(x1), torch.from_numpy(mask),
                               generator=torch.Generator().manual_seed(0))
    assert drawn["loss"].shape == (B,) and ((drawn["t"] >= t0) & (drawn["t"] <= t1)).all()


# -- optimizer -----------------------------------------------------------------


@pytest.mark.parametrize("adamw,k", [(False, 1), (True, 1), (False, 2), (True, 3)],
                         ids=["adam", "adamw", "adam_multisteps2", "adamw_multisteps3"])
def test_optimizer_matches_optax(adamw, k):
    """Gradient norms alternate below and above the clip (1.0); AdamW with
    optax's default weight decay (1e-4)."""
    rng = np.random.default_rng(1)
    shapes = {"a": (5, 3), "b": (4,)}
    params = {n: rng.normal(size=s).astype(np.float32) for n, s in shapes.items()}
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(1e-2) if adamw else optax.adam(1e-2))
    if k > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=k)
    opt_state = tx.init(params)
    opt = Optimizer(1e-2, 1.0, adamw=adamw, accumulate_grad=k)
    tparams = [torch.from_numpy(params[n].copy()) for n in shapes]
    state = opt.init(tparams)
    for step in range(8):
        scale = 2.0 if step % 2 else 0.05
        grads = {n: (rng.normal(size=s) * scale).astype(np.float32) for n, s in shapes.items()}
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        opt.step(tparams, [torch.from_numpy(grads[n]) for n in shapes], state)
        for n, tp in zip(shapes, tparams):
            np.testing.assert_allclose(tp.numpy(), np.asarray(params[n]), rtol=1e-6, atol=1e-7,
                                       err_msg=f"step {step}, {n}")


@pytest.mark.parametrize("ema", [True, False], ids=["ema", "no_ema"])
def test_train_step_takes_one_global_norm(monkeypatch, ema):
    """A train step sums the gradients' squares once; the clip (engaged:
    grad_clip 1e-3) uses that norm, the one ``grad_norm`` reports; and the
    same pass moves the EMA copy where the state keeps one."""
    cfg = PortConfig(**TINY, num_frames=6, ema=ema, grad_clip=1e-3)
    rt = TrainRuntime(cfg)
    state = rt.init(torch.Generator().manual_seed(0))
    sums, applied = [], []
    sum_of_squares, fused_adam = ops.sum_of_squares, ops.fused_adam

    def counted(tensors, root=False):
        sums.append(root)
        return sum_of_squares(tensors, root)

    def seen(params, grads, mu, nu, ema_copy, norm, **kw):
        applied.append((norm, ema_copy))
        fused_adam(params, grads, mu, nu, ema_copy, norm, **kw)

    monkeypatch.setattr(ops, "sum_of_squares", counted)
    monkeypatch.setattr(ops, "fused_adam", seen)
    state, m = rt.train_step(state, batch_to_device(_raw_batch(6), "cpu"),
                             generator=torch.Generator().manual_seed(1))
    assert sums == [True] and len(applied) == 1
    norm, ema_copy = applied[0]
    assert norm is m["grad_norm"] and float(norm) > cfg.grad_clip
    if ema:
        assert [e is p for e, p in zip(ema_copy, state.ema.parameters())] == \
            [True] * len(list(state.model.parameters()))
    else:
        assert ema_copy is None


@pytest.mark.parametrize("k", [1, 2], ids=["adam", "multisteps2"])
def test_opt_state_layout_survives_a_checkpoint(tmp_path, k):
    """``opt_state`` keeps its keys, its per-parameter lists (one tensor of
    each parameter's shape) and its counters through three train steps and
    a checkpoint's save and load, and the loaded state trains on as the
    saved one does."""
    cfg = PortConfig(**TINY, num_frames=6, ema=True, accumulate_grad=k)
    rt = TrainRuntime(cfg)
    state = rt.init(torch.Generator().manual_seed(0))
    keys = set(state.opt_state)
    shapes = [p.shape for p in state.model.parameters()]
    lists = [key for key, v in state.opt_state.items() if isinstance(v, list)]
    assert lists == (["mu", "nu"] if k == 1 else ["mu", "nu", "acc"])
    batch = batch_to_device(_raw_batch(6), "cpu")
    for i in range(3):
        state, _ = rt.train_step(state, batch, generator=torch.Generator().manual_seed(i))
    assert state.opt_state["count"] == 3 // k
    save_train_checkpoint(str(tmp_path), cfg, state)
    loaded, step = load_train_checkpoint(str(tmp_path), rt.init(torch.Generator().manual_seed(5)))
    assert step == 3 and set(loaded.opt_state) == keys
    for key, v in state.opt_state.items():
        got = loaded.opt_state[key]
        if key in lists:
            assert [t.shape for t in got] == [t.shape for t in v] == shapes, key
            assert all(torch.equal(a, b) for a, b in zip(got, v)), key
        else:
            assert got == v, key
    for s in (state, loaded):
        rt.train_step(s, batch, generator=torch.Generator().manual_seed(9))
    for a, b in zip(loaded.model.parameters(), state.model.parameters()):
        assert torch.equal(a, b)
    assert loaded.opt_state["count"] == state.opt_state["count"] == 4 // k
    assert [t.shape for t in loaded.opt_state["mu"]] == shapes


def test_optimizer_pass_takes_the_plain_loop_on_the_cpu(monkeypatch):
    """CPU tensors take the eager loop and never the kernel library; a
    device the kernels do not run on is refused."""
    from mdgen_tpu_torch.ops import _build

    def refuse(*a, **k):
        raise AssertionError("the CPU path built the kernels")

    monkeypatch.setattr(_build, "build", refuse)
    g = torch.Generator().manual_seed(0)
    p = [torch.randn(s, generator=g) for s in ((5, 3), (1,), (4097,))]
    grads = [torch.randn(t.shape, generator=g) for t in p]
    rows = {n: [t.clone() for t in p] for n in ("p", "ref")}
    moments = {n: ([torch.zeros_like(t) for t in p], [torch.zeros_like(t) for t in p])
               for n in rows}
    ema = {n: [t.clone() for t in p] for n in rows}
    kw = dict(count=1, lr=1e-2, grad_clip=1.0, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4,
              ema_decay=0.99)
    norm = ops.sum_of_squares(grads, root=True)
    assert torch.equal(norm, ops.sum_of_squares_plain(grads, root=True))
    ops.fused_adam(rows["p"], grads, *moments["p"], ema["p"], norm, **kw)
    ops.fused_adam_plain(rows["ref"], grads, *moments["ref"], ema["ref"], norm, **kw)
    for n in range(len(p)):
        for a, b in ((rows["p"], rows["ref"]), (ema["p"], ema["ref"]),
                     (moments["p"][0], moments["ref"][0]), (moments["p"][1], moments["ref"][1])):
            assert torch.equal(a[n], b[n])
    with pytest.raises(ValueError, match="CPU \\(plain\\) or CUDA"):
        ops.sum_of_squares([torch.zeros(3, device="meta")])


@pytest.mark.parametrize("ema", [True, False], ids=["ema", "no_ema"])
def test_optimizer_plain_twin_reads_count_on_the_cpu(ema):
    """On the CPU ``fused_adam`` is the plain loop at counts 1, 2, 10 and
    1000, whether or not a pair of bias corrections is given (the card's
    kernel reads that pair; the loop computes its own from ``count``);
    ``load_bias_corrections`` writes ``bias_corrections``' f32 values."""
    from mdgen_tpu_torch.ops.fused_optim import bias_corrections

    g = torch.Generator().manual_seed(0)
    p = [torch.randn(s, generator=g) for s in ((5, 3), (1,), (4097,))]
    rows = {n: [[t.clone() for t in p], [torch.zeros_like(t) for t in p],
                [torch.zeros_like(t) for t in p], [t.clone() for t in p] if ema else None]
            for n in ("given", "plain")}
    stale = torch.zeros(2)
    for count in (1, 2, 10, 1000):
        grads = [torch.randn(t.shape, generator=g) for t in p]
        norm = ops.sum_of_squares(grads, root=True)
        kw = dict(count=count, lr=1e-2, grad_clip=1.0, b1=0.9, b2=0.999, eps=1e-8,
                  weight_decay=0.0, ema_decay=0.99)
        (pg, mg, vg, eg), (pp, mp, vp, ep) = rows["given"], rows["plain"]
        ops.fused_adam(pg, grads, mg, vg, eg, norm, **kw, corrections=stale)
        ops.fused_adam_plain(pp, grads, mp, vp, ep, norm, **kw)
        for a, b in zip(rows["given"], rows["plain"]):
            assert a is None or all(torch.equal(x, y) for x, y in zip(a, b)), count
        want = [float(b) for b in bias_corrections(0.9, 0.999, count)]
        assert ops.load_bias_corrections(torch.empty(2), 0.9, 0.999, count).tolist() == want


def test_optimizer_launches_pack_the_tensor_table(monkeypatch):
    """The pointer table of the optimizer's launches: tensors without
    elements are left out, at most ``max_tensors()`` a launch, one row of
    pointers after another (p, g, mu, nu, ema) and each tensor's size."""
    from mdgen_tpu_torch.ops import fused_optim as fa

    monkeypatch.setattr(fa, "max_tensors", lambda: 2)
    sizes = [3, 0, 4097, 1, 8192, 0]
    rows = [[torch.zeros(n) for n in sizes] for _ in range(5)]
    groups = list(fa._launch_groups(rows))
    assert [n for _, _, n in groups] == [2, 2]
    assert [s.tolist() for _, s, _ in groups] == [[3, 4097], [1, 8192]]
    for (ptrs, _, n), idx in zip(groups, ([0, 2], [3, 4])):
        assert ptrs.tolist() == [row[i].data_ptr() for row in rows for i in idx]
        assert ptrs.dtype == np.int64 and len(ptrs) == 5 * n


# -- train steps ---------------------------------------------------------------

STEP_CASES = {
    "T8_dense_adam_ema": dict(num_frames=8, ema=True),
    "T8_dense_adamw_accumulate2": dict(num_frames=8, adamW=True, accumulate_grad=2),
    "T8_dense_bf16_mixed": dict(num_frames=8, precision="bf16-mixed"),
    "T520_flash_adam_ema": dict(num_frames=520, ema=True),
    "T8_dense_hyena": dict(num_frames=8, hyena=True),
}


def _raw_batch(T):
    atom14 = np.stack([synthetic_trajectory(s, T, seed=i) for i, s in enumerate(SEQS)])
    mask = np.ones((len(SEQS), 4), np.float32)
    mask[1, -1] = 0.0  # a padded residue
    return {"atom14": atom14.astype(np.float32),
            "seqres": np.stack([rc.str_sequence_to_aatype(s) for s in SEQS]).astype(np.int32),
            "mask": mask}


def _to_jax_params(template, sd):
    """Port state dict -> a flax tree shaped like ``template``."""
    def leaf(path, spec):
        *mods, name = path
        key = ".".join([_rename(m) for m in mods]
                       + [{"kernel": "weight", "embedding": "weight", "scale": "weight"}.get(name, name)])
        arr = sd[key].numpy()
        arr = arr.T if name == "kernel" else arr
        assert arr.shape == spec.shape, key
        return jnp.asarray(arr)

    def walk(tree, path):
        return {k: walk(v, path + (k,)) if hasattr(v, "items") else leaf(path + (k,), v)
                for k, v in tree.items()}

    return walk(template, ())


def _draws(key, shape):
    """(t, x0) as the JAX step draws them (velocity / GVP: t in [0, 1))."""
    k_t, k_x0, _ = jax.random.split(key, 3)
    return (torch.from_numpy(np.asarray(jax.random.uniform(k_t, (shape[0],), jnp.float32))),
            torch.from_numpy(np.asarray(jax.random.normal(k_x0, shape, jnp.float32))))


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_two_train_steps_match_jax(case):
    cfg = MDGenConfig(**TINY, **STEP_CASES[case])
    bf16 = cfg.precision == "bf16-mixed"
    raw = _raw_batch(cfg.num_frames)

    model = LatentMDGenModel(cfg, cfg.latent_dim).reset_parameters(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    sd = {k: v + 0.03 * torch.randn(v.shape, generator=g) for k, v in model.state_dict().items()}
    # both steps take the port's tokens: the first residue's omega and phi
    # are undefined (their atoms are zero padding) and tokenize to
    # normalised rounding noise, which differs between the packages
    # (see test_torch_rollout.py); the loss masks them, the model sees them
    tokens = tokenize_atom14(batch_to_device(raw, "cpu"))
    tok_np = {k: v.numpy() for k, v in tokens.items()}
    jrt = JaxRuntime(cfg)
    prep_j = jax_prep(cfg, {k: jnp.asarray(v) for k, v in tok_np.items()})
    B, T, L = prep_j.model_kwargs["mask"].shape
    x = jnp.zeros((B, T, L, cfg.latent_dim))
    template = jax.eval_shape(jrt.model.init, jax.random.PRNGKey(0), x, jnp.zeros((B,)),
                              **prep_j.model_kwargs)["params"]
    params = _to_jax_params(template, sd)
    jstate = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params, opt_state=jrt.tx.init(params),
        ema_params=jax.tree_util.tree_map(jnp.copy, params) if cfg.ema else None)

    rt = TrainRuntime(cfg)
    state = rt.init(state_dict=sd)
    tol = dict(loss=2e-2, grad_norm=2e-2, update=0.1) if bf16 else \
        dict(loss=1e-5, grad_norm=1e-4, update=1e-3)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    for i in range(2):
        key = jax.random.PRNGKey(11 + i)
        with jax.default_matmul_precision("highest"):
            jstate, jm = jrt.train_step(jstate, tok_np, key)
        t, x0 = _draws(key, (B, T, L, cfg.latent_dim))
        state, m = rt.train_step(state, tokens, t=t, x0=x0)
        assert state.step == int(jstate.step) == i + 1
        for name in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[name]), float(jm[name]), rtol=tol[name],
                                       err_msg=f"step {i + 1} {name}")
        trees = [(state.model, jstate.params)]
        if cfg.ema:
            trees.append((state.ema, jstate.ema_params))
        for mod, tree in trees:
            want = jax_params_to_state_dict(jax.device_get(tree))
            got = {k: v for k, v in mod.state_dict().items() if k in want}
            if not bf16:
                for k, v in got.items():
                    np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0, atol=1e-4,
                                               err_msg=f"step {i + 1} {k}")
        # the parameter update as a whole: |d_port - d_jax| / |d_jax|
        want = jax_params_to_state_dict(jax.device_get(jstate.params))
        got = state.model.state_dict()
        d_port = torch.cat([(got[k] - before[k]).flatten() for k in want])
        d_jax = torch.cat([(want[k] - before[k]).flatten() for k in want])
        if cfg.accumulate_grad == 2 and i == 0:  # the first micro-step updates nothing
            assert not d_port.any() and not d_jax.any()
            continue
        rel = float((d_port - d_jax).norm() / d_jax.norm())
        assert rel <= tol["update"], f"step {i + 1}: the update differs by {rel:.3e}"
    if cfg.accumulate_grad == 2:  # one update after two micro-steps
        assert state.opt_state["count"] == 1 and state.opt_state["mini_step"] == 0


# -- fault 1 -------------------------------------------------------------------


def _model_inputs(cfg):
    prep = prep_batch(cfg, tokenize_atom14(batch_to_device(_raw_batch(cfg.num_frames), "cpu")))
    B, T, L = prep.model_kwargs["mask"].shape
    x = torch.randn(B, T, L, cfg.latent_dim, generator=torch.Generator().manual_seed(0))
    return x, torch.tensor([0.3, 0.6]), prep.model_kwargs


def test_fused_sublayers_refuse_autograd():
    """With fused_block the trunk runs forward-only sublayers; a backward
    through them would leave the trunk without gradient on the card, so
    they raise under autograd, on the CPU as well, and run under no_grad."""
    cfg = MDGenConfig(**TINY, num_frames=6, fused_block=True)
    model = LatentMDGenModel(cfg, cfg.latent_dim).reset_parameters(torch.Generator().manual_seed(0))
    x, t, kw = _model_inputs(cfg)
    with pytest.raises(RuntimeError, match="forward-only"):
        model(x, t, **kw).square().sum().backward()
    with torch.no_grad():
        assert torch.isfinite(model(x, t, **kw)).all()
    lay = model.layers[0]
    h = torch.randn(2, 6, 4, 32)
    mod = torch.zeros(2, 1, 32)
    with pytest.raises(RuntimeError, match="forward-only"):
        ops.fused_ffn_sublayer(h, mod, mod, mod, lay.fc1.weight, lay.fc1.bias,
                               lay.fc2.weight, lay.fc2.bias)
    with torch.no_grad():
        ops.fused_ffn_sublayer(h, mod, mod, mod, lay.fc1.weight, lay.fc1.bias,
                               lay.fc2.weight, lay.fc2.bias)


def test_training_model_drops_fused_block():
    """The trainer builds its model with fused_block=False (as the JAX
    runtime does), so a fused_block config still trains, with gradient in
    every trunk layer."""
    cfg = MDGenConfig(**TINY, num_frames=6, fused_block=True)
    rt = TrainRuntime(cfg)
    state = rt.init(torch.Generator().manual_seed(0))
    assert not state.model.cfg.fused_block
    state, m = rt.train_step(state, batch_to_device(_raw_batch(6), "cpu"),
                             generator=torch.Generator().manual_seed(1))
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0


# -- the train step's CUDA graph (its rule and bookkeeping; the card's tests
# capture and replay it, tests/test_torch_cuda.py) -----------------------------

GRAPH_RULE_CASES = {
    "one_cuda_rank": ({}, "cuda", {}, True),
    "cpu": ({}, "cpu", {}, False),
    "dp2": ({}, "cuda", {"dp": 2, "data": 2}, False),
    "sp2": ({}, "cuda", {"sp": 2, "data": 2}, False),
    "tp2": ({}, "cuda", {"tp": 2}, False),
    "accumulate2": ({"accumulate_grad": 2}, "cuda", {}, False),
    "dropout": ({"dropout": 0.1}, "cuda", {}, False),
    "token_batch": ({}, "cuda", {}, False),
    "short_memory": ({}, "cuda", {}, False),
}


@pytest.mark.parametrize("case", list(GRAPH_RULE_CASES))
def test_graph_rule_takes_one_cuda_rank_and_room(monkeypatch, case):
    """A step may be captured only on one CUDA device (no dp, sp or tp),
    with every call applying the update, no dropout, a raw batch and, the
    cache emptied, 1.1 eager peaks of free memory: each case breaks one
    condition of the first (no CUDA call: the memory is faked)."""
    from mdgen_tpu_torch.parallel.mesh import Axis, Grid
    from mdgen_tpu_torch.runtime import wrapper

    over, device, axes, want = GRAPH_RULE_CASES[case]
    grid = Grid(**{name: Axis(size) for name, size in axes.items()})
    rt = TrainRuntime(PortConfig(**TINY, num_frames=6, **over), device, grid=grid)
    batch = batch_to_device(_raw_batch(6), "cpu")
    if case == "token_batch":
        batch = tokenize_atom14(batch)
    peak, emptied = 1000, []
    free = int(peak * wrapper.GRAPH_MEMORY_ROOM) - (case == "short_memory")
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: emptied.append(True))
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev: (free, 80 * peak))
    assert (rt._graphable(batch) and rt._room(peak)) is want
    assert emptied == [True] * (case in ("one_cuda_rank", "short_memory"))


def test_cpu_train_steps_stay_eager_and_unchanged():
    """On the CPU every step is eager (``graph_counts``), records no graph
    span, and equals the gradient and optimizer called by hand."""
    from mdgen_tpu_torch import tracing

    cfg = PortConfig(**TINY, num_frames=6, ema=True)
    batch = batch_to_device(_raw_batch(6), "cpu")
    rt, by_hand = TrainRuntime(cfg), TrainRuntime(cfg)
    state = rt.init(torch.Generator().manual_seed(0))
    ref = by_hand.init(torch.Generator().manual_seed(0))
    n = len(tracing.records())
    for i in range(3):
        state, m = rt.train_step(state, batch, torch.Generator().manual_seed(i))
        params, grads, want = by_hand._grads(ref.model, batch, torch.Generator().manual_seed(i))
        norm = want["grad_norm"] = by_hand._global_norm(grads)
        by_hand.tx.step(params, grads, ref.opt_state, norm, list(ref.ema.parameters()))
        assert all(torch.equal(m[k], want[k]) for k in want), i
    assert rt.graph_counts() == {"captures": 0, "replays": 0, "eager_steps": 3}
    names = {r[0] for r in tracing.records()[n:]}
    assert "train.step" in names and not names & {"train.graph_capture", "train.graph_replay"}
    for mod in ("model", "ema"):
        for a, b in zip(getattr(state, mod).parameters(), getattr(ref, mod).parameters()):
            assert torch.equal(a, b), mod
    assert state.opt_state["count"] == ref.opt_state["count"] == 3


DRAW_CASES = {
    "4aa": dict(),
    "atlas_context": dict(atlas=True),
    "design": dict(inpainting=True, design=True, no_aa_emb=True, no_torsion=True),
    "no_frames": dict(no_frames=True, prepend_ipa=False),
}


@pytest.mark.parametrize("case", list(DRAW_CASES))
def test_graph_draws_are_the_losses_own(case):
    """A step that may be captured draws t, x0 (and the design simplex
    point) before the step, at the latents' shape and with
    ``training_losses``' calls in its order: the loss equals the one that
    draws inside, bit for bit (an ATLAS batch one column wider than the
    crop carries the left-context column)."""
    cfg = PortConfig(**{**TINY, "num_frames": 6, **DRAW_CASES[case]})
    raw = _raw_batch(6)
    if cfg.atlas:  # a left-context column before the crop's 4 residues
        raw = {k: np.concatenate([v[:, :, :1] if k == "atom14" else v[:, :1], v],
                                 axis=2 if k == "atom14" else 1) for k, v in raw.items()}
    batch = batch_to_device(raw, "cpu")
    rt = TrainRuntime(cfg)
    model = rt.init(torch.Generator().manual_seed(0)).model
    draws = rt._draws(batch, torch.Generator().manual_seed(3), None, None)
    latents = prep_batch(cfg, tokenize(cfg, batch)).latents
    assert draws["x0"].shape == latents.shape and draws["x0"].dtype == latents.dtype
    assert ("x_d" in draws) is cfg.design
    with torch.no_grad():
        want, _ = rt.loss_fn(model, batch, torch.Generator().manual_seed(3))
        got, _ = rt.loss_fn(model, batch, None, **draws)
    assert torch.equal(got, want)


def test_graph_keys_and_launch_credits():
    """The graph's key changes with an input's shape and with a new state,
    not with the values; ``ops.add_launch_counts`` credits a replay's
    launches to each counted function."""
    cfg = PortConfig(**TINY, num_frames=6)
    rt = TrainRuntime(cfg)
    state = rt.init(torch.Generator().manual_seed(0))
    batch = batch_to_device(_raw_batch(6), "cpu")

    def key(b, st=state, seed=0):
        inputs = {k: b[k] for k in ("atom14", "seqres", "mask")}
        inputs.update(rt._draws(b, torch.Generator().manual_seed(seed), None, None))
        return rt._graph_key(st, inputs)

    assert key(batch) == key(batch, seed=1)
    assert key(batch) != key(batch_to_device(_raw_batch(8), "cpu"))
    assert key(batch) != key(batch, st=rt.init(torch.Generator().manual_seed(0)))
    before = ops.launch_counts()
    ops.add_launch_counts({"fused_adam": 1, "fftconv": 5})
    after = ops.launch_counts()
    ops.add_launch_counts({"fused_adam": -1, "fftconv": -5})
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == \
        {"fused_adam": 1, "fftconv": 5}
    assert ops.launch_counts() == before
