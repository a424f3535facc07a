"""Data-parallel training of the port (``mdgen_tpu_torch/parallel``,
``TrainRuntime``, ``train.py``) against its one-process step, on the CPU
with the gloo backend.

The JAX trainer's dp step is one jitted step over the global batch, so a dp
run equals a one-device run for the same key
(``tests/test_parallel.py::test_two_process_distributed_matches_single_process``).
The port keeps that property: two ranks in subprocesses, each with its half
of a global batch of 4, draw t, x0, the design simplex point and the dropout
masks for the global batch and average their gradients. Each step's loss
and grad norm equal the one-process step's within 1e-6 relative on the
first step and 1e-5 after (the two sides sum the same products over
batches of another size), and so do the parameters after 3 steps, each
within 1e-5 of its tensor's largest entry.

The steps start from seeded weights with noise on every entry, as
``tests/test_torch_model.py`` does: the adaLN-zero gates and zero output
projections would otherwise give whole towers an exact zero gradient on the
first step, and Adam turns a gradient of rounding noise (1e-12, another on
each side) into a step of noise / eps, 1e-4 of a step, in tensors that hold
nothing but such steps. The IPA's key bias (the k slots of
``ipa.linear_qkv.bias``) has such a gradient at every step: q.b_k is the
same for every key of a query, and the softmax cancels it. Adam moves those
entries by up to a step, lr, in directions of rounding noise, so they are
held only to 2 lr a step.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from mdgen_tpu_torch import train
from mdgen_tpu_torch.config import MDGenConfig
from mdgen_tpu_torch.data import Loader, MDGenDataset, synthetic_trajectory
from mdgen_tpu_torch.geometry import constants as rc
from mdgen_tpu_torch.parallel import free_port, local_batch_slice
from mdgen_tpu_torch.runtime import TrainRuntime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIM = dict(sim_condition=True, prepend_ipa=True, abs_pos_emb=True, abs_time_emb=True)
TINY = dict(num_layers=2, embed_dim=32, mha_heads=4, ipa_heads=2, ipa_head_dim=8, ipa_qk=2,
            ipa_v=2, num_frames=6, crop=4)
CASES = {
    "sim": dict(TINY, **SIM),
    "sim_dropout": dict(TINY, dropout=0.1, **SIM),
    "design": dict(TINY, inpainting=True, design=True, no_aa_emb=True, no_torsion=True,
                   prepend_ipa=True),
}
SEQS = ("ACDE", "FGHI", "KLMN", "PQRS")
STEPS, WORLD = 3, 2


def _global_batch(cfg):
    atom14 = np.stack([synthetic_trajectory(s, cfg.num_frames, seed=i)
                       for i, s in enumerate(SEQS)]).astype(np.float32)
    return {"atom14": torch.from_numpy(atom14),
            "seqres": torch.from_numpy(np.stack([rc.str_sequence_to_aatype(s) for s in SEQS])
                                       ).long(),
            "mask": torch.ones(len(SEQS), cfg.crop)}


def _steps(cfg, batch):
    """STEPS train steps on ``batch`` from the seeded state and generator:
    (losses, grad norms, the parameters after)."""
    rt = TrainRuntime(cfg, "cpu")
    state = rt.init(torch.Generator().manual_seed(0))
    noise = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(0.03 * torch.randn(p.shape, generator=noise))
    gen = torch.Generator().manual_seed(1)
    losses, norms = [], []
    for _ in range(STEPS):
        state, m = rt.train_step(state, batch, gen)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, {k: v.detach().numpy() for k, v in state.model.state_dict().items()}


_WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    sys.path.insert(0, sys.argv[1])
    import test_torch_parallel as tp
    from mdgen_tpu_torch.config import MDGenConfig
    from mdgen_tpu_torch.parallel import init_distributed, local_batch_slice, shutdown

    case, addr, rank, out = sys.argv[2], sys.argv[3], int(sys.argv[4]), sys.argv[5]
    torch.set_num_threads(1)
    init_distributed(addr, tp.WORLD, rank, "gloo")
    cfg = MDGenConfig(**tp.CASES[case])
    lo, hi = local_batch_slice(tp.WORLD, rank, len(tp.SEQS))
    batch = {k: v[lo:hi] for k, v in tp._global_batch(cfg).items()}
    losses, norms, params = tp._steps(cfg, batch)
    shutdown()
    np.savez(out, **params)
    with open(out + ".json", "w") as fh:
        json.dump({"losses": losses, "grad_norms": norms}, fh)
""")


def _run_ranks(argvs, cwd, timeout=300):
    """Start one subprocess per argv and wait for all; a failure kills the rest."""
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(a, cwd=cwd, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for a in argvs]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
            assert p.returncode == 0, out[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


@pytest.mark.parametrize("case", list(CASES))
def test_two_gloo_ranks_reproduce_the_one_process_step(case, tmp_path):
    cfg = MDGenConfig(**CASES[case])
    want_losses, want_norms, want_params = _steps(cfg, _global_batch(cfg))
    addr = f"127.0.0.1:{free_port()}"
    here = os.path.dirname(os.path.abspath(__file__))
    _run_ranks([[sys.executable, "-c", _WORKER, here, case, addr, str(r),
                 str(tmp_path / f"rank{r}")] for r in range(WORLD)], tmp_path)
    for r in range(WORLD):
        with open(tmp_path / f"rank{r}.json") as fh:
            got = json.load(fh)
        for i in range(STEPS):
            tol = 1e-6 if i == 0 else 1e-5
            np.testing.assert_allclose(got["losses"][i], want_losses[i], rtol=tol, err_msg=i)
            np.testing.assert_allclose(got["grad_norms"][i], want_norms[i], rtol=tol, err_msg=i)
        params = np.load(tmp_path / f"rank{r}.npz")
        assert set(params.files) == set(want_params)
        for k, ref in want_params.items():
            diff = np.abs(params[k] - ref)
            if k.endswith("ipa.linear_qkv.bias"):
                key_bias = _ipa_key_slots(cfg, ref.shape[0])
                assert diff[key_bias].max() <= 2 * cfg.lr * STEPS, (r, k)
                diff[key_bias] = 0.0
            assert diff.max() <= 1e-5 * np.abs(ref).max(), (r, k)
    # the ranks hold identical parameters
    a, b = np.load(tmp_path / "rank0.npz"), np.load(tmp_path / "rank1.npz")
    assert all(np.array_equal(a[k], b[k]) for k in a.files)


def _ipa_key_slots(cfg, n):
    """The k entries of the fused IPA projection's bias: per head [q | k | v]."""
    ch = cfg.ipa_head_dim
    slots = np.zeros(n, bool)
    for h in range(cfg.ipa_heads):
        slots[h * 3 * ch + ch:h * 3 * ch + 2 * ch] = True
    return slots


def _dataset(work, frames=TINY["num_frames"], atlas=False):
    """Four tetrapeptides of ``frames`` frames (exactly num_frames: no window
    is drawn); with ``atlas``, four hexapeptides (longer than the crop of 4)
    of three replicas each."""
    seqs = ATLAS_SEQS if atlas else SEQS
    for i, s in enumerate(seqs):
        for name in [f"{s}_R{r}" for r in (1, 2, 3)] if atlas else [s]:
            np.save(work / f"{name}.npy", synthetic_trajectory(s, frames, seed=len(name) * i))
    split = work / "split.csv"
    split.write_text("name,seqres\n" + "".join(f"{s},{s}\n" for s in seqs))
    return split


ATLAS_SEQS = ("ACDEFG", "HIKLMN", "PQRSTV", "WYACDE")


@pytest.mark.parametrize("atlas", [False, True], ids=["windows", "atlas"])
def test_sharded_loaders_draw_the_one_rank_items(atlas, tmp_path):
    """Trajectories of 5 num_frames, so each item draws its window (and,
    with ATLAS, its replica and crop) from the dataset's one generator:
    the two shards' rows of every global batch, side by side, are the
    one-shard batch, so each rank trains on the rows one device would."""
    cfg = MDGenConfig(**dict(TINY, atlas=atlas))
    split = _dataset(tmp_path, 5 * cfg.num_frames, atlas)

    def batches(shards, shard):
        ds = MDGenDataset(cfg, str(split), str(tmp_path), repeat=3, seed=5)
        return list(Loader(ds, 4, seed=1, num_shards=shards, shard_id=shard))

    one, parts = batches(1, 0), [batches(2, r) for r in range(2)]
    assert len(one) == 3 and all(len(p) == 3 for p in parts)
    for b, want in enumerate(one):
        assert parts[0][b]["name"] + parts[1][b]["name"] == want["name"]
        for k in ("atom14", "seqres", "mask"):
            np.testing.assert_array_equal(np.concatenate([p[b][k] for p in parts]), want[k])


def test_two_rank_cli_draws_the_one_rank_windows(tmp_path):
    """``--dp_size 2 --atlas`` on trajectories longer than num_frames (a
    window, a replica and a crop drawn for every item) logs the one-rank
    run's losses and grad norms."""
    split = _dataset(tmp_path, 5 * TINY["num_frames"], atlas=True)
    extra = ["--atlas", "--no_validate"]
    _run_ranks([[sys.executable, *_train_argv(tmp_path, split, "one", extra)],
                [sys.executable, *_train_argv(tmp_path, split, "two", [*extra, "--dp_size", "2"])]],
               tmp_path)
    one = json.loads((tmp_path / "one.0.json").read_text())
    assert len(one["losses"]) == STEPS and np.isfinite(one["losses"]).all()
    for r in range(2):
        two = json.loads((tmp_path / f"two.{r}.json").read_text())
        np.testing.assert_allclose(two["losses"], one["losses"], rtol=1e-5)
        np.testing.assert_allclose(two["grad_norms"], one["grad_norms"], rtol=1e-5)


def _train_argv(work, split, run, extra=()):
    return ["-m", "mdgen_tpu_torch.train", "--device", "cpu", *[f"--{k}" for k in SIM],
            "--crop", "4", "--num_frames", str(TINY["num_frames"]), "--num_layers", "2",
            "--embed_dim", "32", "--mha_heads", "4", "--ipa_head_dim", "8", "--batch_size", "4",
            "--epochs", str(STEPS), "--ckpt_freq", "100", "--val_batches", "1",
            "--train_split", str(split), "--val_split", str(split), "--data_dir", str(work),
            "--workdir", str(work / "workdir"), "--run_name", run,
            "--record", str(work / f"{run}.{{rank}}.json"), *extra]


def test_two_rank_cli_logs_the_one_rank_run_and_stops_on_stop(tmp_path):
    """``--dp_size 2`` on the CPU (two ranks started by the one command) logs
    the one-rank run's losses, grad norms and validation means, and only
    rank 0 writes the checkpoint; a queued STOP sentinel stops both ranks at
    the first poll, each with a checkpoint on disk and exit code 0."""
    split = _dataset(tmp_path)
    py = sys.executable
    stop_run = tmp_path / "workdir" / "stop"
    stop_run.mkdir(parents=True)
    (stop_run / "STOP").write_text("")
    _run_ranks([[py, *_train_argv(tmp_path, split, "one")],
                [py, *_train_argv(tmp_path, split, "two", ["--dp_size", "2"])],
                [py, *_train_argv(tmp_path, split, "stop", ["--dp_size", "2",
                                                            "--stop_check_freq", "1"])]],
               tmp_path)
    one = json.loads((tmp_path / "one.0.json").read_text())
    assert len(one["losses"]) == STEPS and np.isfinite(one["losses"]).all()
    for r in range(2):
        two = json.loads((tmp_path / f"two.{r}.json").read_text())
        np.testing.assert_allclose(two["losses"], one["losses"], rtol=1e-5)
        np.testing.assert_allclose(two["grad_norms"], one["grad_norms"], rtol=1e-5)
        assert [v["step"] for v in two["val"]] == [v["step"] for v in one["val"]]
        np.testing.assert_allclose([v["val_loss"] for v in two["val"]],
                                   [v["val_loss"] for v in one["val"]], rtol=1e-5)
        stop = json.loads((tmp_path / f"stop.{r}.json").read_text())
        assert stop["step"] == 1 and len(stop["losses"]) == 1, stop
    run = tmp_path / "workdir" / "two"
    assert sorted(p.name for p in run.iterdir() if p.name.startswith("step_")) == \
        [f"step_{STEPS}"]
    assert (run / "log.out").exists() and (run / "train_0.csv").exists()
    assert sorted(p.name for p in stop_run.iterdir() if p.name.startswith("step_")) == \
        ["step_1"]


def test_rank_plan():
    """--dp_size, --num_processes and --process_id -> ranks and devices, as
    JAX's mesh lays them out: process p holds ranks p * local + i."""
    from mdgen_tpu_torch.config import config_from_args
    from mdgen_tpu_torch.parallel import plan_ranks

    def plan(*flags):
        args = train.parse_args(["--train_split", "s", "--val_split", "s", "--data_dir", "d",
                                 *flags])
        cfg = config_from_args(args)
        return plan_ranks(cfg.dp_size, args.device, cfg.sp_size, cfg.tp_size,
                          args.num_processes, args.process_id, args.coordinator_address,
                          args.dist_backend)

    one = plan("--device", "cpu")
    assert (one.world, one.local, one.base, one.address) == (1, 1, 0, None)
    two = plan("--device", "cpu", "--dp_size", "2")
    assert (two.world, two.local, two.base, two.backend) == (2, 2, 0, "gloo")
    assert two.address.startswith("localhost:") and two.devices == [torch.device("cpu")] * 2
    hosts = plan("--device", "cpu", "--dp_size", "4", "--num_processes", "2", "--process_id",
                 "1", "--coordinator_address", "h:1234", "--dist_backend", "gloo")
    assert (hosts.world, hosts.local, hosts.base, hosts.address) == (4, 2, 2, "h:1234")
    auto = plan("--device", "cpu", "--num_processes", "2", "--process_id", "0",
                "--coordinator_address", "h:1")
    assert (auto.world, auto.local) == (2, 1)
    cuda = plan("--device", "cuda", "--dp_size", "2", "--num_processes", "2",
                "--coordinator_address", "h:1")
    assert cuda.devices == [torch.device("cuda", 0)] and cuda.backend == "nccl"
    with pytest.raises(ValueError, match="multiple"):
        plan("--device", "cpu", "--dp_size", "3", "--num_processes", "2",
             "--coordinator_address", "h:1")
    with pytest.raises(ValueError, match="coordinator_address"):
        plan("--device", "cpu", "--num_processes", "2")
    assert local_batch_slice(2, 1, 8) == (4, 8)
