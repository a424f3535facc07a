#!/usr/bin/env python3
"""How sensitive a dopri5 rollout is to f32 rounding, against Euler.

    JAX_PLATFORMS=cpu python tools/dopri5_conditioning.py [--design]

On the CPU, at the tiny model of ``tests/test_torch_rollout.py`` (2 x 64, T=6,
its seeded weights and start), one rollout per sampler:
  - dopri5: the JAX rollout jitted, the same rollout eager (under
    ``jax.disable_jit()``) and the port's, max |atoms| difference of each
    pair in Angstrom;
  - euler (4 steps) and dopri5: the port's rollout against itself with every
    weight scaled by (1 + 1e-7), and with the noise scaled by (1 + 1e-6).
The adaptive solver's error estimate is a difference of two nearly equal f32
states, so a last-digit change moves its later step sizes: this is why
``test_rollout_matches_jax_with_jax_noise`` holds dopri5 to 1e-3 A and Euler
and Heun to 1e-4 A. Needs jax (the JAX package is the reference); about two
minutes, most of it the eager JAX rollout.

``--design``: the design inference of ``tests/test_torch_design.py`` (the
recipe's inpainting + design, 1 and 2 layers x 32, T=8, its seeded weights,
windows and JAX noise), dopri5: JAX jitted vs eager, and the port vs each.
The Dirichlet flow's factor grows without bound near the simplex's edges,
which makes these solves more sensitive than the sim rollout at 1 layer.
About 16 minutes on one CPU core, most of it the eager JAX solves.
"""
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))


def design():
    import jax
    import jax.numpy as jnp
    import torch

    import test_torch_design as D
    from mdgen_tpu.runtime import MDGenRuntime as JaxRuntime
    from mdgen_tpu.tasks import prep_batch as jax_prep
    from mdgen_tpu_torch.interop import jax_params_to_state_dict
    from mdgen_tpu_torch.models import LatentMDGenModel
    from mdgen_tpu_torch.runtime import MDGenRuntime, batch_to_device

    for layers in (1, 2):
        cfg = D._cfg("design", sampling_method="dopri5", num_layers=layers)
        raw = D._windows(cfg.num_frames)
        rt = JaxRuntime(cfg)
        prep = jax_prep(cfg, rt._tokenize({k: jnp.asarray(v) for k, v in raw.items()}))
        params = D._params(cfg, prep.model_kwargs)
        key = jax.random.PRNGKey(5)
        with jax.default_matmul_precision("highest"):
            jit = np.asarray(rt.inference(params, raw, key)[0])
            with jax.disable_jit():
                eager = np.asarray(rt._inference_impl(
                    params, {k: jnp.asarray(v) for k, v in raw.items()}, key)[0])
        B, T, L = jit.shape[:3]
        k_cont, k_disc = jax.random.split(key)
        noise = np.concatenate([
            np.asarray(jax.random.normal(k_cont, (B, T, L, cfg.latent_dim - 20))),
            np.broadcast_to(np.asarray(jax.random.dirichlet(k_disc, jnp.ones((B, L, 20))))[:, None],
                            (B, T, L, 20))], axis=-1)
        model = LatentMDGenModel(cfg, cfg.latent_dim)
        model.load_state_dict(jax_params_to_state_dict(params))
        st = {}
        out = MDGenRuntime(cfg, model).inference(batch_to_device(raw, "cpu"),
                                                 noise=torch.from_numpy(noise.copy()),
                                                 stats=st)[0].numpy()
        print(f"design dopri5, {layers} layer(s) ({st['evals']} evaluations): JAX jitted vs eager "
              f"{np.abs(jit - eager).max():.3e} A; port vs jitted {np.abs(out - jit).max():.3e} A; "
              f"port vs eager {np.abs(out - eager).max():.3e} A", flush=True)


def main():
    if "--design" in sys.argv[1:]:
        return design()
    import jax
    import torch

    from mdgen_tpu.config import MDGenConfig
    from mdgen_tpu.data import synthetic_trajectory
    from mdgen_tpu.geometry import constants as rc
    from mdgen_tpu.runtime import MDGenRuntime as JaxRuntime
    from mdgen_tpu_torch.interop import jax_params_to_state_dict
    from mdgen_tpu_torch.models import LatentMDGenModel
    from mdgen_tpu_torch.runtime import MDGenRuntime
    from test_torch_rollout import CFG, SEQ

    for method in ("euler", "dopri5"):
        cfg = MDGenConfig(**CFG, fused_block=False, sampling_method=method)
        T = cfg.num_frames
        traj = synthetic_trajectory(SEQ, T, seed=0)[None].astype(np.float32)
        seqres = rc.str_sequence_to_aatype(SEQ)[None].astype(np.int32)
        mask = np.ones(seqres.shape, np.float32)
        rt = JaxRuntime(cfg)
        state = rt.init(jax.random.PRNGKey(0), {"atom14": traj, "seqres": seqres, "mask": mask})
        noise_rng = np.random.default_rng(5)  # as the test: break adaLN-zero
        params = jax.tree_util.tree_map(
            lambda p: np.asarray(p) + 0.05 * noise_rng.normal(size=p.shape).astype(np.float32),
            state.params)
        params["cond_to_emb"]["kernel"][7:11] = 0.0
        key = jax.random.PRNGKey(11)
        start = traj[:, 0]
        draws = np.array(jax.random.normal(jax.random.split(jax.random.split(key, 1)[0])[0],
                                           (1, T, len(SEQ), cfg.latent_dim)))[None]
        model = LatentMDGenModel(cfg, cfg.latent_dim)
        model.load_state_dict(jax_params_to_state_dict(params))
        port = MDGenRuntime(cfg, model)
        args = (torch.from_numpy(start), torch.from_numpy(seqres).long(), torch.from_numpy(mask), 1)
        solves = []
        out = port.rollout(*args, noise=torch.from_numpy(draws), stats=solves).numpy()
        evals = solves[0]["evals"]
        if method == "dopri5":
            with jax.default_matmul_precision("highest"):
                jit = np.asarray(rt.rollout(params, start, seqres, mask, key, 1))
                with jax.disable_jit():
                    eager = np.asarray(rt._rollout_impl(params, start, seqres, mask, key, 1))
            print(f"dopri5 ({evals} evaluations): JAX jitted vs eager "
                  f"{np.abs(jit - eager).max():.3e} A; port vs jitted {np.abs(out - jit).max():.3e}"
                  f" A; port vs eager {np.abs(out - eager).max():.3e} A", flush=True)
        noisy = port.rollout(*args, noise=torch.from_numpy(draws) * (1 + 1e-6)).numpy()
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1 + 1e-7)
        scaled = port.rollout(*args, noise=torch.from_numpy(draws)).numpy()
        print(f"{method} ({evals} evaluations), the port against itself: weights x (1 + 1e-7) "
              f"{np.abs(scaled - out).max():.3e} A; noise x (1 + 1e-6) "
              f"{np.abs(noisy - out).max():.3e} A", flush=True)


if __name__ == "__main__":
    main()
