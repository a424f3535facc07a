"""The port's forward-simulation rollout against the JAX runtime's, and the
port's no-jax guarantee.

Rollout parity: the same weights, the same start frame and the JAX
runtime's own Gaussian draws (regenerated here from the key splits of
``MDGenRuntime._rollout_impl`` / ``_inference_impl`` and passed in as
``noise=``), 2 rollouts of 4 Euler or Heun steps or one adaptive dopri5
solve each, both in f32 on the CPU (JAX at full matmul precision). Both
must make the same number of drift evaluations: a ``jax.debug.callback`` in
the JAX drift counts them inside the jitted rollout.

Tolerance, Euler and Heun: 1e-4 Angstrom, f32 rounding (~1e-6 A measured)
through the solver's steps, the quaternion normalisation and the side-chain
frame chain, with margin. dopri5: 1e-3 A, each port rollout started from
JAX's start. The adaptive solver amplifies f32 rounding: its error estimate
is the difference of two nearly equal f32 states, so a last-digit change in
one drift evaluation moves every later step size. JAX's own jitted and eager
rollouts of this model differ by 6.8e-4 A (one dopri5 rollout, 91
evaluations); the port is 7.6e-5 A from the jitted one, and scaling the
port's weights by 1 + 1e-7 moves its rollout by 1.4e-4 A (Euler: 2.9e-6)
(``tools/dopri5_conditioning.py``).

One input is ill-conditioned in both packages and is switched off: the
first residue's omega and phi torsions are undefined (their atoms come from
zero padding), so tokenization returns sin/cos made of rounding noise
normalised to O(1), and ``x_cond`` feeds them to the model. JAX's own jitted
and eager evaluations of one inference then differ by 1.3e-3 A at frame 0,
and a second rollout amplifies that to 0.1 A. The test zeroes the
``cond_to_emb`` rows of those four channels.
"""
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from mdgen_tpu.config import MDGenConfig
from mdgen_tpu.data import synthetic_trajectory
from mdgen_tpu.geometry import constants as rc
from mdgen_tpu.runtime import MDGenRuntime as JaxRuntime
from mdgen_tpu_torch.interop import jax_params_to_state_dict
from mdgen_tpu_torch.models import LatentMDGenModel
from mdgen_tpu_torch.runtime import MDGenRuntime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ = "ACDE"
CFG = dict(num_layers=2, embed_dim=64, mha_heads=4, ipa_heads=2, ipa_head_dim=8,
           ipa_qk=2, ipa_v=2, num_frames=6, crop=4, sim_condition=True,
           prepend_ipa=True, abs_pos_emb=True, abs_time_emb=True, inference_steps=4)


def _count_drift_calls(rt):
    """Makes each drift evaluation of ``rt``'s sampler append to the returned
    list, also inside jit (the callback has no operand: the math is as is)."""
    calls, sample_ode = [], rt.sampler.sample_ode

    def counting(model_fn, **kw):
        def counted(x, t, **model_kwargs):
            jax.debug.callback(lambda: calls.append(1))
            return model_fn(x, t, **model_kwargs)

        return sample_ode(counted, **kw)

    rt.sampler.sample_ode = counting
    return calls


@pytest.mark.parametrize("sampling_method", ["euler", "heun", "dopri5"])
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_rollout_matches_jax_with_jax_noise(fused, sampling_method):
    cfg = MDGenConfig(**CFG, fused_block=fused, sampling_method=sampling_method)
    R, T = 2, cfg.num_frames
    traj = synthetic_trajectory(SEQ, T, seed=0)[None].astype(np.float32)
    seqres = rc.str_sequence_to_aatype(SEQ)[None].astype(np.int32)
    mask = np.ones(seqres.shape, np.float32)
    start = traj[:, 0]

    rt = JaxRuntime(cfg)
    state = rt.init(jax.random.PRNGKey(0), {"atom14": traj, "seqres": seqres, "mask": mask})
    noise_rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map(  # break adaLN-zero so the trunk matters
        lambda p: np.asarray(p) + 0.05 * noise_rng.normal(size=p.shape).astype(np.float32),
        state.params,
    )
    params["cond_to_emb"]["kernel"][7:11] = 0.0  # omega/phi sin-cos channels
    key = jax.random.PRNGKey(11)
    jax_calls = _count_drift_calls(rt)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(rt.rollout(params, start, seqres, mask, key, R))
    jax.effects_barrier()
    draws = np.stack([
        np.asarray(jax.random.normal(jax.random.split(k)[0], (1, T, len(SEQ), cfg.latent_dim)))
        for k in jax.random.split(key, R)
    ])  # [R, B, T, L, 21]

    model = LatentMDGenModel(cfg, cfg.latent_dim)
    model.load_state_dict(jax_params_to_state_dict(params))
    solves, port = [], MDGenRuntime(cfg, model)
    args = (torch.from_numpy(seqres).long(), torch.from_numpy(mask))
    if sampling_method == "dopri5":  # each rollout from JAX's start
        starts = [start] + [np.array(ref[:, r * T - 1]) for r in range(1, R)]
        out = np.concatenate([
            port.rollout(torch.from_numpy(s), *args, 1, noise=torch.from_numpy(draws[r:r + 1]),
                         stats=solves).numpy() for r, s in enumerate(starts)], axis=1)
    else:
        out = port.rollout(torch.from_numpy(start), *args, R, noise=torch.from_numpy(draws),
                           stats=solves).numpy()
    assert out.shape == ref.shape == (1, R * T, len(SEQ), 14, 3)
    assert np.isfinite(out).all()
    tol = 1e-3 if sampling_method == "dopri5" else 1e-4
    assert np.abs(out - ref).max() < tol, np.abs(out - ref).max()
    assert len(solves) == R and all(s["reached_t1"] for s in solves), solves
    assert sum(s["evals"] for s in solves) == len(jax_calls), (solves, len(jax_calls))
    if sampling_method != "dopri5":
        assert len(jax_calls) == R * {"euler": 3, "heun": 6}[sampling_method]


_NO_JAX_SCRIPT = textwrap.dedent("""
    import sys
    for m in ("jax", "flax", "optax", "orbax", "pandas"):
        sys.modules[m] = None  # any import of these now raises ImportError
    import os, tempfile
    import numpy as np, torch
    from mdgen_tpu_torch.config import MDGenConfig
    from mdgen_tpu_torch.data import synthetic_trajectory
    from mdgen_tpu_torch.models import LatentMDGenModel
    from mdgen_tpu_torch.runtime import checkpoint
    from mdgen_tpu_torch import sim_inference

    cfg = MDGenConfig(num_layers=1, embed_dim=32, mha_heads=4, ipa_heads=2,
                      ipa_head_dim=8, ipa_qk=2, ipa_v=2, num_frames=4, crop=4,
                      sim_condition=True, prepend_ipa=True, abs_pos_emb=True,
                      abs_time_emb=True, sampling_method="euler", inference_steps=3)
    model = LatentMDGenModel(cfg, cfg.latent_dim).reset_parameters(torch.Generator().manual_seed(0))
    d = tempfile.mkdtemp()
    checkpoint.save_checkpoint(os.path.join(d, "ckpt"), cfg, model.state_dict())
    np.save(os.path.join(d, "pep.npy"), synthetic_trajectory("ACDE", 4, seed=0))
    with open(os.path.join(d, "split.csv"), "w") as fh:
        fh.write("name,seqres\\npep,ACDE\\n")
    rec = sim_inference.main(["--sim_ckpt", os.path.join(d, "ckpt"), "--data_dir", d,
                              "--split", os.path.join(d, "split.csv"), "--out_dir", d,
                              "--num_rollouts", "2", "--fused_block", "--device", "cpu"])
    text = open(rec[0]["paths"][0]).read()
    assert text.count("MODEL") == 8, text.count("MODEL")
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "optax", "orbax", "pandas")
           and sys.modules[m] is not None]
    assert not bad, bad
    print("NO_JAX_OK")
""")


def test_port_runs_without_jax(tmp_path):
    """Import the port, run a tiny forward simulation through the CLI entry
    point on the CPU and write a PDB, in a process where jax, flax, optax,
    orbax and pandas cannot be imported."""
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_SCRIPT], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NO_JAX_OK" in proc.stdout


def test_cuda_device_is_required_unless_cpu_is_asked_for(tmp_path):
    from mdgen_tpu_torch import sim_inference

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sim_inference.main(["--sim_ckpt", str(tmp_path), "--data_dir", str(tmp_path)])
