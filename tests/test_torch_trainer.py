"""The port's trainer around the train step: checkpoints (save, resume,
``keep_last_n`` by mtime), the STOP sentinel, and the CLI
``python -m mdgen_tpu_torch.train`` at a tiny size on the CPU, in a process
that cannot import jax, followed by the port's ``sim_inference`` restoring
the run directory."""
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from mdgen_tpu_torch import train
from mdgen_tpu_torch.config import MDGenConfig
from mdgen_tpu_torch.data import synthetic_trajectory
from mdgen_tpu_torch.runtime import TrainRuntime, batch_to_device, checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(num_layers=1, embed_dim=32, mha_heads=4, ipa_heads=2, ipa_head_dim=8, ipa_qk=2,
            ipa_v=2, num_frames=6, crop=4, batch_size=2, sim_condition=True,
            prepend_ipa=True, abs_pos_emb=True, abs_time_emb=True)
TINY_FLAGS = ["--sim_condition", "--prepend_ipa", "--abs_pos_emb", "--abs_time_emb",
              "--crop", "4", "--num_frames", "6", "--num_layers", "1", "--embed_dim", "32",
              "--mha_heads", "4", "--ipa_heads", "2", "--ipa_head_dim", "8", "--ipa_qk", "2",
              "--ipa_v", "2", "--batch_size", "2"]
SEQS = ("ACDE", "KLMW", "GHIP", "QRST")


def _data(d, n=4, frames=10):
    for i, s in enumerate(SEQS[:n]):
        np.save(os.path.join(d, f"{s}.npy"), synthetic_trajectory(s, frames, seed=i))
    split = os.path.join(d, "split.csv")
    with open(split, "w") as fh:
        fh.write("name,seqres\n" + "".join(f"{s},{s}\n" for s in SEQS[:n]))
    return split


def _batch(seed):
    from mdgen_tpu_torch.geometry import constants as rc

    atom14 = np.stack([synthetic_trajectory(s, 6, seed=seed + i) for i, s in enumerate(SEQS[:2])])
    return batch_to_device({"atom14": atom14.astype(np.float32),
                            "seqres": np.stack([rc.str_sequence_to_aatype(s) for s in SEQS[:2]]),
                            "mask": np.ones((2, 4), np.float32)}, "cpu")


def test_checkpoint_resume_and_rotation(tmp_path):
    """keep_last_n prunes by write time: a stale step_99 left by an older
    run goes first. A resumed state (model, EMA, optimizer with its
    accumulation buffers, step) continues exactly as the original."""
    cfg = MDGenConfig(**TINY, ema=True, accumulate_grad=2)
    run = str(tmp_path / "run")
    os.makedirs(os.path.join(run, "step_99"))
    old = time.time() - 3600
    os.utime(os.path.join(run, "step_99"), (old, old))
    rt = TrainRuntime(cfg)
    state = rt.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    for i in range(3):
        state, _ = rt.train_step(state, _batch(i), generator=g)
        checkpoint.save_train_checkpoint(run, cfg, state, keep_last_n=2)
    assert sorted(os.listdir(run)) == ["config.json", "step_2", "step_3"]
    assert checkpoint.latest_step(run) == 3

    resumed, step = checkpoint.load_train_checkpoint(
        run, rt.init(torch.Generator().manual_seed(5)))
    assert step == resumed.step == 3
    assert resumed.opt_state["mini_step"] == 1  # mid-accumulation
    for a, b in ((state.model, resumed.model), (state.ema, resumed.ema)):
        for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
            torch.testing.assert_close(v, w, rtol=0, atol=0, msg=k)
    t, x0 = torch.tensor([0.2, 0.7]), torch.randn(2, 6, 4, 21, generator=g)
    for s in (state, resumed):
        rt.train_step(s, _batch(9), t=t, x0=x0)
    for (k, v), w in zip(state.model.state_dict().items(), resumed.model.state_dict().values()):
        torch.testing.assert_close(v, w, rtol=0, atol=0, msg=k)

    model, step = checkpoint.load_model(run)  # the run's newest step, EMA weights
    assert step == 3
    torch.testing.assert_close(model.state_dict()["trunk_adaln.weight"],
                               checkpoint._load(os.path.join(run, "step_3", "model.pt"))["ema"]
                               ["trunk_adaln.weight"], rtol=0, atol=0)


def _train_argv(d, split, run, *extra):
    return [*TINY_FLAGS, "--train_split", split, "--val_split", split, "--data_dir", d,
            "--workdir", os.path.dirname(run), "--run_name", os.path.basename(run),
            "--device", "cpu", *extra]


def test_stop_sentinel_checkpoints_and_resume_clears_it(tmp_path):
    """A STOP file queued before the run ends it at the first poll with a
    checkpoint; the resumed run removes the consumed sentinel and finishes
    its epochs."""
    d = str(tmp_path)
    split = _data(d)
    run = os.path.join(d, "work", "run")
    os.makedirs(run)
    open(os.path.join(run, "STOP"), "w").close()
    argv = _train_argv(d, split, run, "--epochs", "3", "--stop_check_freq", "1", "--ema")
    rec = train.main(argv)
    assert rec["step"] == 1 and os.path.isdir(os.path.join(run, "step_1"))
    assert os.path.exists(os.path.join(run, "STOP"))
    time.sleep(0.01)
    # 2 steps per epoch: step 1 resumes at the start of epoch 0, as in JAX
    rec = train.main(argv + ["--ckpt", run])
    assert not os.path.exists(os.path.join(run, "STOP"))
    assert rec["step"] == 7 and len(rec["losses"]) == 6
    assert all(np.isfinite(rec["losses"]))
    assert checkpoint.latest_step(run) == 7


def test_too_few_items_for_a_batch_is_an_error(tmp_path):
    d = str(tmp_path)
    split = _data(d, n=1)
    with pytest.raises(ValueError, match="make no batch"):
        train.main(_train_argv(d, split, os.path.join(d, "work", "run")))


_NO_JAX_SCRIPT = textwrap.dedent("""
    import sys
    for m in ("jax", "flax", "optax", "orbax", "pandas"):
        sys.modules[m] = None  # any import of these now raises ImportError
    import os, runpy
    import numpy as np
    from mdgen_tpu_torch.data import synthetic_trajectory
    from mdgen_tpu_torch import sim_inference

    d = os.getcwd()
    for i, s in enumerate(("ACDE", "KLMW")):
        np.save(os.path.join(d, s + ".npy"), synthetic_trajectory(s, 10, seed=i))
    with open("split.csv", "w") as fh:
        fh.write("name,seqres\\nACDE,ACDE\\nKLMW,KLMW\\n")
    sys.argv = ["train"] + FLAGS + [
        "--train_split", "split.csv", "--val_split", "split.csv", "--data_dir", d,
        "--run_name", "run", "--device", "cpu", "--epochs", "2", "--ema",
        "--sampling_method", "euler", "--inference_steps", "3"]
    runpy.run_module("mdgen_tpu_torch.train", run_name="__main__")
    run = os.path.join("workdir", "run")
    assert sorted(p for p in os.listdir(run) if p.startswith("step_")) == ["step_1", "step_2"]
    rec = sim_inference.main(["--sim_ckpt", run, "--data_dir", d, "--split", "split.csv",
                              "--out_dir", "out", "--num_rollouts", "2", "--fused_block",
                              "--device", "cpu"])
    text = open(rec[0]["paths"][0]).read()
    assert text.count("MODEL") == 12, text.count("MODEL")
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "optax", "orbax", "pandas")
           and sys.modules[m] is not None]
    assert not bad, bad
    print("NO_JAX_OK")
""")


def _env():
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = REPO
    return env


def test_cli_trains_and_samples_without_jax(tmp_path):
    """python -m mdgen_tpu_torch.train --device cpu for two epochs of one
    batch (2 peptides, batch 2), then sim_inference restores the run
    directory (its newest step) and rolls out."""
    script = f"FLAGS = {TINY_FLAGS!r}\n" + _NO_JAX_SCRIPT
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, env=_env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NO_JAX_OK" in proc.stdout


def test_cli_needs_cuda_unless_cpu_is_asked_for(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    split = _data(str(tmp_path), n=2)
    proc = subprocess.run(
        [sys.executable, "-m", "mdgen_tpu_torch.train", *TINY_FLAGS, "--train_split", split,
         "--val_split", split, "--data_dir", str(tmp_path)],
        cwd=tmp_path, env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
