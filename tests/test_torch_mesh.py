"""Tensor and sequence parallelism of the port (``mdgen_tpu_torch/parallel``,
``TrainRuntime``) against its one-process step, on the CPU with gloo ranks.

JAX holds a (dp=2, sp=2, tp=2) mesh step to one device's
(``tests/test_parallel.py``: the toy shape, the reduced ATLAS shape with
remat); GSPMD's own bound there is rtol 2e-3. The port's grid is held to the
port's one process, which ``tests/test_torch_train.py`` holds to JAX: eight
ranks in subprocesses, each with its dp rows, its sp frames and its tp
heads and hidden units, run three train steps of each case from the same
seeded weights and draws. Each step's loss and grad norm equal the
one-process step's within 1e-6 relative on the first step and 1e-5 after,
and the parameters after 3 steps, gathered whole, each within 1e-5 of its
tensor's largest entry (the row-parallel all-reduces and the frame sums
change the order of the sums). The IPA's key-bias entries are held to 2 lr
a step, as in ``tests/test_torch_parallel.py`` (their gradient is rounding
noise, which Adam turns into steps of up to lr).

The cases: the 4AA sim recipe; the ATLAS shape (a crop with its context
column) with gradient checkpointing and dropout, whose masks the ranks draw
at the one-process shape and slice by rows, heads and frames; and
``--hyena`` (its FFT convolution over gathered frames); sequence design (its
simplex mean and its logits pooled over the frames of every sp rank, the
cross entropy over every rank's tokens, the design head's fc1 / fc2 over
tp) and ``dynamic_mpnn`` (its first and last frames gathered from the sp
ranks that hold them). The same launch
writes a grid checkpoint (loaded and sampled in one process here) and
resumes a one-process checkpoint on the grid for a 4th step.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from mdgen_tpu_torch.config import MDGenConfig
from mdgen_tpu_torch.data import synthetic_trajectory
from mdgen_tpu_torch.geometry import constants as rc
from mdgen_tpu_torch.parallel import free_port
from mdgen_tpu_torch.runtime import TrainRuntime, checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
SIM = dict(sim_condition=True, prepend_ipa=True, abs_pos_emb=True, abs_time_emb=True)
TINY = dict(num_layers=2, embed_dim=32, mha_heads=4, ipa_heads=2, ipa_head_dim=8, ipa_qk=2,
            ipa_v=2, num_frames=8, crop=4)
CASES = {
    "sim": dict(TINY, **SIM),
    "atlas": dict(TINY, **SIM, atlas=True, crop=12, grad_checkpointing=True, dropout=0.1),
    "hyena": dict(TINY, **SIM, hyena=True),
    "design": dict(TINY, inpainting=True, design=True, no_aa_emb=True, no_torsion=True,
                   prepend_ipa=True, abs_pos_emb=True, abs_time_emb=True),
    "dynamic_mpnn": dict(TINY, inpainting=True, dynamic_mpnn=True, design=True,
                         prepend_ipa=True, abs_pos_emb=True, abs_time_emb=True),
}
GRID = (2, 2, 2)  # dp, sp, tp
RESUMED = ("sim", "hyena")  # the cases resumed from a one-process checkpoint
SEQS = ("ACDEFGHIKLMNP", "QRSTVWYACDEFG", "HIKLMNPQRSTVW", "YACDEFGHIKLMN")
STEPS = 3


def _global_batch(cfg):
    """Four trajectories of num_frames frames; crop (+ 1 context column
    under ATLAS) residues of each sequence."""
    L = cfg.crop + (1 if cfg.atlas else 0)
    seqs = [s[:L] for s in SEQS]
    atom14 = np.stack([synthetic_trajectory(s, cfg.num_frames, seed=i)
                       for i, s in enumerate(seqs)]).astype(np.float32)
    return {"atom14": torch.from_numpy(atom14),
            "seqres": torch.from_numpy(np.stack([rc.str_sequence_to_aatype(s)
                                                 for s in seqs])).long(),
            "mask": torch.ones(len(seqs), L)}


def _start(cfg):
    """The seeded weights with noise on every entry (as
    ``tests/test_torch_parallel.py`` starts: no exact-zero gradients)."""
    model = TrainRuntime(cfg, "cpu").init(torch.Generator().manual_seed(0)).model
    noise = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.03 * torch.randn(p.shape, generator=noise))
    return model.state_dict()


def _raw_loss(rt, state, batch):
    """This rank's loss before any average over ranks (train=False: no
    dropout)."""
    with torch.no_grad():
        return float(rt.loss_fn(state.model, batch, torch.Generator().manual_seed(7),
                                train=False)[0])


def _steps(rt, state, batch, steps=STEPS, seed=1):
    gen = torch.Generator().manual_seed(seed)
    losses, norms = [], []
    for _ in range(steps):
        state, m = rt.train_step(state, batch, gen)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms


_WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    sys.path.insert(0, sys.argv[1])
    import test_torch_mesh as tm
    from mdgen_tpu_torch.config import MDGenConfig
    from mdgen_tpu_torch.parallel import init_distributed, local_batch_slice, shutdown
    from mdgen_tpu_torch.parallel.mesh import make_grid
    from mdgen_tpu_torch.runtime import TrainRuntime, checkpoint

    addr, rank, work = sys.argv[2], int(sys.argv[3]), sys.argv[4]
    dp, sp, tp = tm.GRID
    torch.set_num_threads(1)
    init_distributed(addr, dp * sp * tp, rank, "gloo")
    grid = make_grid(dp, sp, tp)
    out = {}
    for case, kw in tm.CASES.items():
        cfg = MDGenConfig(**kw)
        lo, hi = local_batch_slice(dp, grid.dp.index, len(tm.SEQS))
        batch = {k: v[lo:hi] for k, v in tm._global_batch(cfg).items()}
        rt = TrainRuntime(cfg, "cpu", grid)
        state = rt.init(state_dict=torch.load(f"{work}/{case}_start.pt"))
        raw = tm._raw_loss(rt, state, batch)
        losses, norms = tm._steps(rt, state, batch)
        np.savez(f"{work}/{case}_rank{rank}.npz",
                 **{k: v.numpy() for k, v in state.model.state_dict().items()})
        full = rt.full_state(state)
        if rank == 0:
            np.savez(f"{work}/{case}_full.npz", **{k: v.numpy() for k, v in full["model"].items()})
            checkpoint.save_train_checkpoint(f"{work}/{case}_grid", cfg, state, 0, full)
        resumed = None
        if case in tm.RESUMED:  # the one-process run's checkpoint, for a 4th step
            state = rt.init(state_dict=torch.load(f"{work}/{case}_start.pt"))
            state, _ = checkpoint.load_train_checkpoint(f"{work}/{case}_one", state,
                                                        shard=rt.shard_state)
            resumed = tm._steps(rt, state, batch, steps=1, seed=5)
            full = rt.full_state(state)
            if rank == 0:
                np.savez(f"{work}/{case}_resumed.npz",
                         **{k: v.numpy() for k, v in full["model"].items()})
        out[case] = {"losses": losses, "grad_norms": norms, "resumed": resumed, "raw": raw,
                     "specs": sorted(rt.specs), "coords": [grid.dp.index, grid.sp.index,
                                                            grid.tp.index]}
    shutdown()
    with open(f"{work}/rank{rank}.json", "w") as fh:
        json.dump(out, fh)
""")


def _run_ranks(argvs, cwd, timeout=400):
    """Start one subprocess per argv and wait for all; a failure kills the rest."""
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(a, cwd=cwd, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for a in argvs]
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            assert p.returncode == 0, out[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One process's 3 steps (+ a 4th from its checkpoint) of every case, and
    the eight grid ranks' records."""
    work = tmp_path_factory.mktemp("mesh")
    one = {}
    for case, kw in CASES.items():
        cfg = MDGenConfig(**kw)
        start = _start(cfg)
        torch.save(start, work / f"{case}_start.pt")
        rt = TrainRuntime(cfg, "cpu")
        state = rt.init(state_dict=start)
        batch = _global_batch(cfg)
        raw = _raw_loss(rt, state, batch)
        losses, norms = _steps(rt, state, batch)
        params = {k: v.detach().numpy().copy() for k, v in state.model.state_dict().items()}
        checkpoint.save_train_checkpoint(str(work / f"{case}_one"), cfg, state)
        resumed = _steps(rt, state, batch, steps=1, seed=5) if case in RESUMED else None
        one[case] = {"cfg": cfg, "losses": losses, "grad_norms": norms, "params": params,
                     "raw": raw,
                     "resumed": resumed, "resumed_params": {
                         k: v.detach().numpy() for k, v in state.model.state_dict().items()}}
    addr = f"127.0.0.1:{free_port()}"
    world = int(np.prod(GRID))
    _run_ranks([[sys.executable, "-c", _WORKER, HERE, addr, str(r), str(work)]
                for r in range(world)], work)
    ranks = [json.loads((work / f"rank{r}.json").read_text()) for r in range(world)]
    return work, one, ranks


def _ipa_key_slots(cfg, n):
    """The k entries of the fused IPA projection's bias: per head [q | k | v]."""
    ch = cfg.ipa_head_dim
    slots = np.zeros(n, bool)
    for h in range(cfg.ipa_heads):
        slots[h * 3 * ch + ch:h * 3 * ch + 2 * ch] = True
    return slots


def _assert_params_close(got, want, cfg, steps):
    assert set(got) == set(want)
    for k, ref in want.items():
        diff = np.abs(got[k] - ref)
        if k.endswith("ipa.linear_qkv.bias"):
            key_bias = _ipa_key_slots(cfg, ref.shape[0])
            assert diff[key_bias].max() <= 2 * cfg.lr * steps, k
            diff[key_bias] = 0.0
        assert diff.max() <= 1e-5 * np.abs(ref).max(), (k, diff.max(), np.abs(ref).max())


@pytest.mark.parametrize("case", list(CASES))
def test_grid_steps_log_the_one_process_losses_and_grad_norms(case, runs):
    _, one, ranks = runs
    for rec in ranks:
        got = rec[case]
        for i in range(STEPS):
            tol = 1e-6 if i == 0 else 1e-5
            np.testing.assert_allclose(got["losses"][i], one[case]["losses"][i], rtol=tol,
                                       err_msg=(rec[case]["coords"], i))
            np.testing.assert_allclose(got["grad_norms"][i], one[case]["grad_norms"][i],
                                       rtol=tol, err_msg=(rec[case]["coords"], i))


@pytest.mark.parametrize("case", list(CASES))
def test_every_sp_and_tp_rank_holds_its_rows_whole_loss(case, runs):
    """Before the metrics are averaged: the ranks of one dp index hold the
    same loss (the loss sums its frame terms over sp), and the dp indices'
    mean is the one-process loss."""
    _, one, ranks = runs
    by_dp = {}
    for rec in ranks:
        by_dp.setdefault(rec[case]["coords"][0], []).append(rec[case]["raw"])
    for raws in by_dp.values():
        np.testing.assert_allclose(raws, raws[0], rtol=1e-6)
    np.testing.assert_allclose(np.mean([r[0] for r in by_dp.values()]), one[case]["raw"],
                               rtol=1e-6)


@pytest.mark.parametrize("case", list(CASES))
def test_grid_parameters_after_three_steps_are_the_one_process_ones(case, runs):
    work, one, ranks = runs
    got = dict(np.load(work / f"{case}_full.npz"))
    _assert_params_close(got, one[case]["params"], one[case]["cfg"], STEPS)
    # tp sharded the attention and MLP projections
    specs = ranks[0][case]["specs"]
    assert "layers.0.mha_t.qkv_proj.weight" in specs or case == "hyena"
    assert "layers.0.fc1.weight" in specs and "ipa_layers.0.fc2.weight" in specs
    assert not any("ipa.linear" in k or "adaln" in k for k in specs)


@pytest.mark.parametrize("case", list(CASES))
def test_tp_ranks_hold_equal_replicated_parameters(case, runs):
    """Every rank's replicated tensors are bit-equal (tp ranks compute the
    same replicated gradients; dp x sp ranks average theirs), and each tp
    shard is the same on every rank of its tp index."""
    work, _, ranks = runs
    specs = set(ranks[0][case]["specs"])
    params = [dict(np.load(work / f"{case}_rank{r}.npz")) for r in range(len(ranks))]
    tp_of = [rec[case]["coords"][2] for rec in ranks]
    for k, ref in params[0].items():
        for r, p in enumerate(params):
            if k not in specs or tp_of[r] == tp_of[0]:
                assert np.array_equal(p[k], ref), (k, r)
    assert any(not np.array_equal(params[0][k], params[1][k]) for k in specs)


@pytest.mark.parametrize("case", ["sim", "atlas"])
def test_grid_checkpoint_loads_and_samples_in_one_process(case, runs):
    """The grid's ``step_3/model.pt`` holds whole tensors: one process loads
    it (the trained parameters) and samples with it."""
    from mdgen_tpu_torch.runtime import MDGenRuntime

    work, one, _ = runs
    cfg = one[case]["cfg"]
    model, step = checkpoint.load_model(str(work / f"{case}_grid"), cfg.replace(ema=False))
    assert step == STEPS
    want = dict(np.load(work / f"{case}_full.npz"))
    got = {k: v.numpy() for k, v in model.state_dict().items()}
    assert all(np.array_equal(got[k], want[k]) for k in want)
    batch = {k: v[:1] for k, v in _global_batch(cfg).items()}
    rt = MDGenRuntime(cfg.replace(sampling_method="euler", inference_steps=3), model)
    atom14, _ = rt.inference(batch, torch.Generator().manual_seed(0))
    assert atom14.shape == (1, cfg.num_frames, cfg.crop, 14, 3)
    assert torch.isfinite(atom14).all()


@pytest.mark.parametrize("case", RESUMED)
def test_one_process_checkpoint_resumes_on_the_grid(case, runs):
    """A one-process run's step_3 (model, EMA and Adam moments, whole) is
    sliced onto the grid's ranks: their 4th step is the one process's."""
    work, one, ranks = runs
    for rec in ranks:
        got = rec[case]["resumed"]
        np.testing.assert_allclose(got[0], one[case]["resumed"][0], rtol=1e-5)
        np.testing.assert_allclose(got[1], one[case]["resumed"][1], rtol=1e-5)
    _assert_params_close(dict(np.load(work / f"{case}_resumed.npz")),
                         one[case]["resumed_params"], one[case]["cfg"], STEPS + 1)


# -- the sharding helpers, against the JAX package's ---------------------------


def test_pad_batch_to_dp_is_the_jax_helper():
    """``tests/test_parallel.py::test_pad_batch_to_dp``'s cases: row-0 pads
    to a dp multiple, metadata through, the unequal-dims error."""
    from mdgen_tpu.parallel import make_mesh
    from mdgen_tpu.parallel import pad_batch_to_dp as jax_pad

    from mdgen_tpu_torch.parallel.mesh import Axis, Grid, pad_batch_to_dp

    grid = Grid(dp=Axis(8, 0))
    batch = {"atom14": np.arange(3 * 2 * 4, dtype=np.float32).reshape(3, 2, 4),
             "seqres": np.arange(12).reshape(3, 4), "names": ["a", "b", "c"]}
    (got, B), (want, B_jax) = pad_batch_to_dp(batch, grid), jax_pad(batch, make_mesh(dp_size=8))
    assert B == B_jax == 3 and got.keys() == want.keys() and got["names"] == ["a", "b", "c"]
    for k in ("atom14", "seqres"):
        assert got[k].shape[0] == 8 and np.array_equal(got[k], want[k])
    assert pad_batch_to_dp(batch, None)[0]["atom14"].shape[0] == 3
    assert pad_batch_to_dp({"x": np.zeros((8, 2))}, grid)[0]["x"].shape[0] == 8
    with pytest.raises(ValueError, match="unequal leading batch dims"):
        pad_batch_to_dp({"x": np.zeros((3, 2)), "y": np.zeros((4, 2))}, grid)
    assert pad_batch_to_dp({"names": ["a"]}, None)[1] == 0


def _jax_shard(arr, mesh, d, s, t):
    """The shard of a JAX array on mesh device (d, s, t)."""
    dev = mesh.devices[d, s, t]
    return next(np.asarray(sh.data) for sh in arr.addressable_shards if sh.device == dev)


def test_shard_batch_holds_the_jax_device_shards():
    """Each grid point's ``shard_batch`` is JAX's ``shard_batch`` shard on
    that device of a (2, 2, 2) mesh: rows over dp, the frame axis of the
    trajectory keys over sp (``tests/test_parallel.py:79``), torsion_mask
    [B, L, 7] not frame-sharded (``:224``), and an array whose batch dp does
    not divide, whole."""
    from mdgen_tpu.parallel import make_mesh
    from mdgen_tpu.parallel import shard_batch as jax_shard_batch

    from mdgen_tpu_torch.parallel.mesh import Axis, Grid, shard_batch

    B, T, L = 4, 8, 4
    rng = np.random.default_rng(0)
    batch = {"atom14": rng.normal(size=(B, T, L, 14, 3)).astype(np.float32),
             "torsions": rng.normal(size=(B, T, L, 7, 2)).astype(np.float32),
             "torsion_mask": rng.normal(size=(B, L, 7)).astype(np.float32),
             "trans": rng.normal(size=(B, T, L, 3)).astype(np.float32),
             "seqres": rng.integers(0, 20, (B, L)), "odd": np.zeros((3, 2), np.float32)}
    mesh = make_mesh(dp_size=2, tp_size=2, sp_size=2)
    want = jax_shard_batch(mesh, batch)
    for d in range(2):
        for s in range(2):
            for t in range(2):
                got = shard_batch(Grid(dp=Axis(2, d), sp=Axis(2, s), tp=Axis(2, t)), batch)
                for k in batch:
                    np.testing.assert_array_equal(got[k], _jax_shard(want[k], mesh, d, s, t),
                                                  err_msg=(k, d, s, t))
    got = shard_batch(Grid(dp=Axis(2, 1), sp=Axis(2, 1)), batch)
    assert got["torsion_mask"].shape == (2, L, 7) and got["trans"].shape == (2, T // 2, L, 3)


def test_tp_shards_gather_to_the_whole_tensor():
    """Every tensor ``tp_specs`` names, sliced by ``shard_tensor`` for each
    tp index and joined back by ``join_shards``, is the whole tensor; the q, k and v rows of a rank are its heads'."""
    from mdgen_tpu_torch.models import LatentMDGenModel
    from mdgen_tpu_torch.parallel.mesh import Axis, join_shards, shard_tensor, tp_specs

    cfg = MDGenConfig(**dict(CASES["sim"], design=True, inpainting=True, sim_condition=False))
    model = LatentMDGenModel(cfg, cfg.latent_dim).reset_parameters(
        torch.Generator().manual_seed(0))
    specs = tp_specs(model, 2)
    assert {"fc1.weight", "fc2.weight", "layers.1.mha_l.bias_k",
            "ipa_layers.0.mha_l.out_proj.weight"} <= set(specs)
    assert not any(k.endswith(("fc3.weight", "out_proj.bias", "fc2.bias")) for k in specs)
    sd = model.state_dict()
    for name, spec in specs.items():
        parts = [shard_tensor(sd[name], spec, Axis(2, i)) for i in range(2)]
        assert torch.equal(join_shards(parts, spec), sd[name]), name
    C, hd = cfg.embed_dim, cfg.embed_dim // cfg.mha_heads
    w = sd["layers.0.mha_t.qkv_proj.weight"]
    mine = shard_tensor(w, specs["layers.0.mha_t.qkv_proj.weight"], Axis(2, 1))
    heads = slice(C // 2, C)  # rank 1: heads 2 and 3
    assert torch.equal(mine, torch.cat([w[heads], w[C:][heads], w[2 * C:][heads]]))
    assert hd * cfg.mha_heads == C
    assert tp_specs(model, 3) == {}  # 3 divides neither the heads nor 4C: replicated


def test_rank_plan_keeps_the_model_axes_inside_one_host():
    from mdgen_tpu_torch.parallel import plan_ranks

    grid = plan_ranks(2, "cpu", sp_size=2, tp_size=2)
    assert (grid.world, grid.local, grid.dp, grid.sp, grid.tp) == (8, 8, 2, 2, 2)
    for dp, hosts in ((2, 4), (-1, 2)):  # one rank a host: no room for sp=2 in one
        with pytest.raises(ValueError, match="inside one host"):
            plan_ranks(dp, "cpu", sp_size=2, num_processes=hosts, address="h:1")
    with pytest.raises(ValueError, match="multiple of sp"):
        plan_ranks(-1, "cpu", sp_size=2)
    with pytest.raises(ValueError, match="NCCL"):
        plan_ranks(2, "cuda:0", backend="nccl")
    shared = plan_ranks(2, "cuda:0", backend="gloo")
    assert shared.devices == [torch.device("cuda", 0)] * 2


# -- data-parallel inference --------------------------------------------------


CLI_PEPTIDES = ("ACDE", "FGHI", "KLMN")


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """``sim_inference`` (3 peptides in one batch) and ``tps_inference`` (3
    paths a batch) with dopri5, on one rank and on two gloo ranks (each
    batch padded to 4 rows)."""
    work = tmp_path_factory.mktemp("dp_infer")
    # one thread a rank (the spawned ranks read OMP_NUM_THREADS), as the
    # grid's subprocesses run: the suite's other workers share the cores
    threads, omp = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        return work, _cli_runs(work)
    finally:
        torch.set_num_threads(threads)
        if omp is None:
            os.environ.pop("OMP_NUM_THREADS")
        else:
            os.environ["OMP_NUM_THREADS"] = omp


def _cli_runs(work):
    import shutil

    from mdgen_tpu_torch import sim_inference, tps_inference
    from mdgen_tpu_torch.data import synthetic_rotamer_trajectory

    for i, s in enumerate(CLI_PEPTIDES):
        np.save(work / f"{s}.npy", synthetic_trajectory(s, 4, seed=i))
    (work / "split.csv").write_text("name,seqres\n" + "".join(f"{s},{s}\n" for s in CLI_PEPTIDES))
    np.save(work / "md_ACDE.npy", synthetic_rotamer_trajectory("ACDE", 600, seed=0))
    (work / "tps.csv").write_text("name,seqres\nmd_ACDE,ACDE\n")
    kw = dict(TINY, sampling_method="dopri5")
    for name, cfg in (("sim", MDGenConfig(**kw, **SIM)),
                      ("tps", MDGenConfig(**kw, tps_condition=True, prepend_ipa=True,
                                          abs_pos_emb=True, abs_time_emb=True))):
        checkpoint.save_checkpoint(str(work / name), cfg, _start(cfg))
    out = {}
    for ranks in (1, 2):
        dp = ["--dp_size", "2"] if ranks == 2 else []
        sim_out = work / f"sim_out{ranks}"
        out[("sim", ranks)] = sim_inference.main(
            ["--sim_ckpt", str(work / "sim"), "--data_dir", str(work), "--split",
             str(work / "split.csv"), "--out_dir", str(sim_out), "--num_rollouts", "2",
             "--batch_size", "3", "--fused_block", "--device", "cpu", *dp],
            keep_trajectories=True)
        tps_out = work / f"tps_out{ranks}"
        if ranks == 2:  # the one-rank run's MSM cache
            tps_out.mkdir()
            shutil.copy(work / "tps_out1" / "md_ACDE_metadata.pkl", tps_out)
        out[("tps", ranks)] = tps_inference.main(
            ["--sim_ckpt", str(work / "tps"), "--data_dir", str(work), "--split",
             str(work / "tps.csv"), "--out_dir", str(tps_out), "--num_batches", "1",
             "--batch_size", "3", "--tica_lag", "10", "--msm_lag", "2", "--device", "cpu",
             *dp], keep_trajectories=True)
    return out


def test_two_rank_sim_inference_samples_the_one_rank_rollouts(cli_runs):
    """The first rollout within 1e-5 A, the second (chained from the first's
    last frame) within 1e-3 A, as ``tests/test_torch_rollout.py`` holds
    dopri5 rollouts; the same solver counts; rank 0 wrote the files."""
    from mdgen_tpu_torch.protein import load_trajectory

    work, out = cli_runs
    (one,), (two,) = out[("sim", 1)], out[("sim", 2)]
    assert two["names"] == one["names"] == list(CLI_PEPTIDES)
    assert two["traj"].shape == one["traj"].shape == (3, 2 * TINY["num_frames"], 4, 14, 3)
    T = TINY["num_frames"]
    np.testing.assert_allclose(two["traj"][:, :T], one["traj"][:, :T], atol=1e-5, rtol=0)
    np.testing.assert_allclose(two["traj"], one["traj"], atol=1e-3, rtol=0)
    assert [s["evals"] for s in two["solves"]] == [s["evals"] for s in one["solves"]]
    assert all(s["evals"] > 7 for s in one["solves"])  # not one trivial step
    for name in CLI_PEPTIDES:
        a, _ = load_trajectory(str(work / "sim_out1" / f"{name}.pdb"))
        b, _ = load_trajectory(str(work / "sim_out2" / f"{name}.pdb"))
        np.testing.assert_allclose(b, a, atol=2e-3)


def test_two_rank_tps_inference_samples_the_one_rank_paths(cli_runs):
    """The same endpoint frames and paths within 1e-5 A, the same dopri5
    evaluation counts, and rank 0's files and metadata."""
    work, out = cli_runs
    (one,), (two,) = out[("tps", 1)], out[("tps", 2)]
    assert np.array_equal(one["start_idx"], two["start_idx"])
    assert np.array_equal(one["end_idx"], two["end_idx"])
    assert two["traj"].shape == one["traj"].shape == (3, TINY["num_frames"], 4, 14, 3)
    np.testing.assert_allclose(two["traj"], one["traj"], atol=1e-5, rtol=0)
    assert two["solves"][0]["evals"] == one["solves"][0]["evals"] > 7
    a = json.loads((work / "tps_out1" / "md_ACDE_metadata.json").read_text())
    b = json.loads((work / "tps_out2" / "md_ACDE_metadata.json").read_text())
    assert [m["start_idx"] for m in a] == [m["start_idx"] for m in b]
    assert sorted(p.name for p in (work / "tps_out2").glob("*.pdb")) == \
        [f"md_ACDE_{i}.pdb" for i in range(3)]
