"""Micro-benchmark: one denoiser forward at the 4AA sampling shape.

The port of ``scripts/micro_fwd.py``: the bench configuration (4AA forward
simulation, T = 100, crop 4, bf16-mixed serving cast of seeded weights,
``seeded_model``),
``--steps`` chained forwards ``x <- x + 0.01 * model(x, t)`` over t in
[0, 1], as the Euler sampler calls the model, without the tokenize and
decode around a rollout. Timed with CUDA events eagerly (what the host
loop costs) and as replays of a CUDA graph of one forward (the device time
alone); on the CPU, eagerly with the host clock.

    python -m mdgen_tpu_torch.micro_fwd --batch 8 [--fused_block] [--attn_impl dense] \\
        [--trace DIR]
    python -m mdgen_tpu_torch.micro_fwd --device cpu --num_layers 2 --embed_dim 32 \\
        --mha_heads 4 --steps 3 --batch 2

Prints the first call's seconds, ms per denoiser step (eager and graph) and
the kernel launches of the eager steps.
"""
from __future__ import annotations

import argparse
import os
import time


def seeded_model(cfg, seed: int = 0):
    """Seeded weights; the zero-init adaLN producers and output head get
    N(0, 0.05) noise, so that every trunk sublayer and the head contribute
    (with their zero init the model's output is 0)."""
    import torch

    from .models import LatentMDGenModel

    g = torch.Generator().manual_seed(seed)
    model = LatentMDGenModel(cfg, cfg.latent_dim).reset_parameters(g)
    lins = [model.trunk_adaln] + ([model.ipa_adaln] if cfg.prepend_ipa else [])
    if hasattr(model, "emb_to_latent"):  # the mpnn modes have no latent head
        lins += [model.emb_to_latent.dense_0, model.emb_to_latent.dense_1]
    with torch.no_grad():
        for lin in lins:
            lin.weight.add_(torch.randn(lin.weight.shape, generator=g) * 0.05)
    return model


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--trace", type=str, default=None,
                   help="write a torch.profiler trace of one timed run into DIR")
    p.add_argument("--fused_block", action="store_true",
                   help="the fused sublayer kernels (1-3)")
    p.add_argument("--attn_impl", default="auto", choices=("auto", "dense", "chunked", "flash"),
                   help="the unfused attentions' inner loop (config.attn_impl)")
    p.add_argument("--num_layers", type=int, default=5)
    p.add_argument("--embed_dim", type=int, default=384)
    p.add_argument("--mha_heads", type=int, default=16)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Returns {"out" (the last x, on the CPU), "drift" (out - x0, the
    forwards' own sum 0.01 * sum_i model(x_i, t_i)), "eager_ms", "graph_ms"
    (None on the CPU), "launches" (of the eager steps)}."""
    args = parse_args(argv)
    import numpy as np
    import torch

    from .config import MDGenConfig
    from .data import synthetic_trajectory
    from .geometry import constants as rc
    from .ops import launch_counts, reset_launch_counts
    from .runtime import MDGenRuntime, tokenize_atom14
    from .tasks import prep_batch

    device = torch.device(args.device)
    B = args.batch
    cfg = MDGenConfig(
        sim_condition=True, prepend_ipa=True, abs_pos_emb=True, abs_time_emb=True, crop=4,
        num_frames=100, sampling_method="euler", inference_steps=100,
        precision="bf16-mixed", batch_size=B, fused_block=args.fused_block,
        attn_impl=args.attn_impl,
        num_layers=args.num_layers, embed_dim=args.embed_dim, mha_heads=args.mha_heads,
    )
    rt = MDGenRuntime(cfg, seeded_model(cfg).to(device))  # the bf16 serving cast
    traj = synthetic_trajectory("ACDE", cfg.num_frames, seed=0)[None]
    batch = {
        "atom14": torch.from_numpy(np.broadcast_to(traj, (B, *traj.shape[1:])).astype(np.float32)),
        "seqres": torch.from_numpy(np.broadcast_to(rc.str_sequence_to_aatype("ACDE")[None], (B, 4))
                                   .copy()).long(),
        "mask": torch.ones(B, 4),
    }
    prep = prep_batch(cfg, tokenize_atom14({k: v.to(device) for k, v in batch.items()}))
    kw = prep.model_kwargs
    T, L = cfg.num_frames, 4
    x0 = torch.randn(B, T, L, cfg.latent_dim, generator=torch.Generator().manual_seed(1)).to(device)
    ts = torch.linspace(0.0, 1.0, args.steps, device=device)
    fwd = rt.model_inf.forward_inference
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    @torch.inference_mode()
    def run():
        x = x0
        for i in range(args.steps):
            x = x + 0.01 * fwd(x, ts[i].expand(B), **kw).float()
        return x

    t0 = time.perf_counter()
    out = run()
    sync()
    first_s = time.perf_counter() - t0
    print(f"first call: {first_s:.1f}s  out_mean={float(out.mean()):.4f}", flush=True)

    if args.trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=acts) as prof:
            run()
            sync()
        os.makedirs(args.trace, exist_ok=True)
        path = os.path.join(args.trace, "micro_fwd_trace.json")
        prof.export_chrome_trace(path)
        print(f"trace -> {path}", flush=True)

    reset_launch_counts()
    if cuda:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        eager = []
        for _ in range(3):
            start.record()
            out = run()
            end.record()
            sync()
            eager.append(start.elapsed_time(end))
    else:
        eager = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = run()
            eager.append((time.perf_counter() - t0) * 1e3)
    launches = {k: v // 3 for k, v in launch_counts().items()}
    eager_ms = min(eager) / args.steps

    graph_ms = None
    if cuda:
        x_in, t_in = x0.clone(), ts[:1].expand(B).clone()
        with torch.inference_mode():
            stream = torch.cuda.Stream(device)
            stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(stream):
                for _ in range(2):
                    fwd(x_in, t_in, **kw)
            torch.cuda.current_stream(device).wait_stream(stream)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                y = fwd(x_in, t_in, **kw)
            graph.replay()
            sync()
            reps = []
            for _ in range(3):
                start.record()
                for _ in range(args.steps):
                    graph.replay()
                end.record()
                sync()
                reps.append(start.elapsed_time(end))
            assert torch.isfinite(y).all()
        graph_ms = min(reps) / args.steps

    fps = B * T / (eager_ms * 1e-3 * 100)
    graph = f", CUDA graph {graph_ms:.3f} ms" if graph_ms is not None else ""
    print(f"per denoiser step: eager {eager_ms:.3f} ms{graph} (B={B}; {fps:.0f} frames/s-equiv "
          f"eagerly at 100 steps); launches per run of {args.steps} steps {launches}", flush=True)
    return {"out": out.float().cpu(), "drift": (out.float() - x0).cpu(), "eager_ms": eager_ms,
            "graph_ms": graph_ms, "launches": launches}


if __name__ == "__main__":
    main()
