#!/usr/bin/env python3
"""The fused serving kernels (1-3) and the main-path rollout of several
checkouts, in turns.

    python3 tools/fused_ab.py ROOT [ROOT ...]

Each ROOT is a checkout of this repository (a commit to compare with is
unpacked by `git archive` into a directory that .gitignore lists). Each runs
in a fresh process, in the order given, so that two trees compare on one card
when listed in turns (A B B A). A process builds its own kernels, then, with
its own `chip_smoke.py`'s seeded inputs at the main shape (B=1, T=100, L=4,
C=384, 16 heads, bf16 operands, a masked residue), times each fused kernel:
the wrapper's host µs per call (the median and the least of REPEATS runs of
200 calls, no sync inside a run: noise on the host only adds), once as
`chip_smoke.py` times it (a kernel faster than its wrapper leaves the device
idle between calls) and once with the device held busy through the run by a
sleep kernel queued first (every launch then queues behind it, whatever the
kernel's device time), and the part of it spent inside the C entry point
(the launches; the rest is the wrapper's Python); eagerly through the
wrapper (CUDA events around 20 calls) and as device time (CUDA events
around a CUDA graph of 20 calls).
Then ROLLOUTS rollouts of the main path (the bench configuration with
`chip_smoke.py`'s seeded weights through `MDGenRuntime.rollout`: 100 frames,
99 Euler evaluations, bf16-mixed), each timed on the host clock and ended by
a device sync. Prints one JSON line per process, with the card's name and
power limit. Needs a CUDA device and the CUDA toolkit.
"""
import json
import os
import statistics
import subprocess
import sys
import time

REPEATS = 15
ROLLOUTS = 5
CALLS = 200
SLEEP_CYCLES = 200_000_000  # about 0.1 s of device time, past any run of CALLS calls


def _host_us_busy(torch, fn):
    """Host µs per call with the device busy from before the first call to
    after the last: (µs, whether the device was still busy at the end)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    t0 = time.perf_counter()
    for _ in range(CALLS):
        fn()
    host = (time.perf_counter() - t0) / CALLS * 1e6
    held = not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    return host, held


def _entry_us(torch, fn):
    """Host µs per call spent inside the C entry point (`_build.call`: the
    kernels' launches); the rest of a call is the wrapper's Python."""
    from mdgen_tpu_torch.ops import _build

    inner, spent = _build.call, [0.0]

    def timed(*a):
        t0 = time.perf_counter()
        inner(*a)
        spent[0] += time.perf_counter() - t0

    fn()
    torch.cuda.synchronize()
    _build.call = timed  # the wrappers look it up at each call
    try:
        for _ in range(CALLS):
            fn()
    finally:
        _build.call = inner
    torch.cuda.synchronize()
    return spent[0] / CALLS * 1e6


def _kernels(torch, cs):
    base, mask = cs._sublayer_inputs(torch, cs.B, cs.T, cs.L, seed=0)
    out = {}
    for name, (kern, _, names, is_attn) in cs._fused_fns().items():
        args, kw = cs._fused_args(base, mask, names, is_attn, torch.bfloat16)
        call = lambda: kern(*args, **kw)  # noqa: E731
        host = [cs._host_us(torch, call, CALLS) for _ in range(REPEATS)]
        busy = [_host_us_busy(torch, call) for _ in range(REPEATS)]
        if not all(held for _, held in busy):
            raise RuntimeError("the sleep kernel ended before the calls did: raise SLEEP_CYCLES")
        busy = [us for us, _ in busy]
        entry = [_entry_us(torch, call) for _ in range(REPEATS)]
        out[name] = {"host_us": statistics.median(host), "host_us_min": min(host),
                     "host_us_busy": statistics.median(busy), "host_us_busy_min": min(busy),
                     "entry_us": statistics.median(entry), "entry_us_min": min(entry),
                     "ms": cs._time_ms(torch, call), "device_ms": cs._graph_ms(torch, call)}
    return out


def _rollouts(torch, cs):
    import numpy as np

    from mdgen_tpu_torch.data import synthetic_trajectory
    from mdgen_tpu_torch.geometry import constants as rc
    from mdgen_tpu_torch.models import LatentMDGenModel
    from mdgen_tpu_torch.runtime import MDGenRuntime

    cfg = cs.bench_config(fused_block=True)
    model = LatentMDGenModel(cfg, cfg.latent_dim)
    model.load_state_dict(cs.seeded_model(torch, cs.bench_config()).state_dict())
    rt = MDGenRuntime(cfg, model.to("cuda").eval())
    start = torch.from_numpy(synthetic_trajectory(cs.SEQ, 1, seed=0)[0].astype(np.float32))
    start = start[None].cuda()
    seqres = torch.from_numpy(rc.str_sequence_to_aatype(cs.SEQ)[None]).long().cuda()
    mask = torch.ones(cs.B, cs.L, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rt.rollout(start, seqres, mask, 1, generator=gen)  # warm-up
    fps = []
    for _ in range(ROLLOUTS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rt.rollout(start, seqres, mask, 1, generator=gen)
        torch.cuda.synchronize()
        fps.append(cs.NUM_FRAMES / (time.perf_counter() - t0))
    return fps


def _one(root):
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from mdgen_tpu_torch.ops import _build

    _, _, smi = cs.phase_device(torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    res = {"root": root, "card": smi, "kernels": _kernels(torch, cs)}
    fps = _rollouts(torch, cs)
    res.update(frames_per_s=fps, frames_per_s_median=statistics.median(fps))
    print("[fused_ab]", json.dumps(res), flush=True)


def main(argv):
    if not argv or argv[0].startswith("-") and argv[0] != "--one":
        raise SystemExit(__doc__)
    if argv[0] == "--one":  # one checkout, in this process
        return _one(os.path.abspath(argv[1]))
    for root in argv:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root], check=True)


if __name__ == "__main__":
    main(sys.argv[1:])
