#!/usr/bin/env python3
"""Where flash attention overtakes dense attention on the card, in keys.

    python3 tools/attn_crossover.py [--out build/attn_crossover.json]

Times ``RoPEAttention``'s two inner routes on the same roped q, k, v and key
mask: ``_dense_attention`` (einsum logits, f32 softmax, P.V) and
``_folded_attention(..., "flash")`` (the fold to [N, S, d] rows and kernels
5-7 under autograd, kernel 4 without). Each route runs forward plus backward
(``torch.autograd.grad`` of a fixed cotangent into q, k and v) and forward
alone under no-grad, eagerly, timed by CUDA events around ITERS calls after a
warm-up; ``host_ms`` is the enqueue alone, on the host's clock. Rows:

  * ATLAS's residue attention: [1, 250, K - 1, 384] over the residue axis,
    16 heads of 24 (N = 4,000 rows), K keys with the bias key, for K in
    KEYS, bf16 and f32; the last tenth of the residues padded (masked);
  * ATLAS's frame attention: [1, 250, 256, 384] over the frame axis (N =
    4,096 rows, 251 keys), bf16;
  * 4AA's residue attention: [8, 1000, 4, 384] (N = 128,000 rows, 5 keys),
    f32.

Each route's output and gradients are also held to the dense route run in
f32 on the same (rounded) operands: the largest difference over the largest
reference entry, per tensor. Prints one JSON line per row and writes all of
them, with the card's name and power limit, to ``--out``. Needs a CUDA
device and the CUDA toolkit (the kernels build at first use).
"""
import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

KEYS = (5, 17, 33, 65, 129, 257, 513)
C, H = 384, 16
ITERS = 20


def _inputs(torch, B, T, L, axis, dt, seed):
    """Roped-like q [B, T, L, H, hd], k and v with the bias key appended on
    ``axis``, and the key mask with it: the last tenth of the residues
    masked (none when fewer than 10)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    hd = C // H
    kshape = [B, T, L, H, hd]
    kshape[axis] += 1
    q = (torch.randn(B, T, L, H, hd, device="cuda", generator=g) * hd**-0.5).to(dt)
    k = torch.randn(*kshape, device="cuda", generator=g).to(dt)
    v = torch.randn(*kshape, device="cuda", generator=g).to(dt)
    mask = torch.ones(B, T, L, device="cuda")
    mask[:, :, L - L // 10:] = 0.0
    mshape = [B, T, L]
    mshape[axis] = 1
    mask = torch.cat([mask, torch.ones(mshape, device="cuda")], dim=axis)
    do = torch.randn(B, T, L, H, hd, device="cuda", generator=g).to(dt)
    return q, k, v, mask, do


def _events_ms(torch, fn):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    host = (time.perf_counter() - t0) * 1e3 / ITERS
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS, host


def _gaps(outs, ref):
    return {name: float((a.float() - b).abs().max() / b.abs().max())
            for name, a, b in zip(("o", "dq", "dk", "dv"), outs, ref)}


def row(torch, name, B, T, L, axis, dt, seed=0):
    from mdgen_tpu_torch import ops
    from mdgen_tpu_torch.models.attention import RoPEAttention

    q, k, v, mask, do = _inputs(torch, B, T, L, axis, dt, seed)
    routes = {"dense": lambda a, b, c: RoPEAttention._dense_attention(a, b, c, mask, axis),
              "flash": lambda a, b, c: RoPEAttention._folded_attention(a, b, c, mask, axis,
                                                                       "flash")}

    def fwd_bwd(route, a, b, c):
        leaves = [t.detach().requires_grad_(True) for t in (a, b, c)]
        out = routes[route](*leaves)
        return (out, *torch.autograd.grad(out, leaves, do.to(out.dtype)))

    ref = fwd_bwd("dense", q.float(), k.float(), v.float())
    res = {"row": name, "dtype": str(dt).split(".")[-1], "shape": [B, T, L], "axis": axis,
           "keys": [B, T, L][axis] + 1, "rows": B * H * [B, T, L][3 - axis]}
    for route in routes:
        ops.reset_launch_counts()
        outs = fwd_bwd(route, q, k, v)
        torch.cuda.synchronize()
        res[f"{route}_launches"] = {n: c for n, c in ops.launch_counts().items() if c}
        res[f"{route}_gap"] = _gaps(outs, ref)
        del outs
        res[f"{route}_fwd_bwd_ms"], res[f"{route}_fwd_bwd_host_ms"] = _events_ms(
            torch, lambda: fwd_bwd(route, q, k, v))
        with torch.no_grad():
            res[f"{route}_fwd_ms"], res[f"{route}_fwd_host_ms"] = _events_ms(
                torch, lambda: routes[route](q, k, v))
        torch.cuda.reset_peak_memory_stats()
        fwd_bwd(route, q, k, v)
        torch.cuda.synchronize()
        res[f"{route}_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    res["flash_over_dense_fwd_bwd"] = res["flash_fwd_bwd_ms"] / res["dense_fwd_bwd_ms"]
    res["flash_over_dense_fwd"] = res["flash_fwd_ms"] / res["dense_fwd_ms"]
    del q, k, v, mask, do, ref
    torch.cuda.empty_cache()
    print("[attn_crossover]", json.dumps(res), flush=True)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join("build", "attn_crossover.json"))
    args = ap.parse_args(argv)
    import torch

    from mdgen_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    print(f"[attn_crossover] {card}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    rows = []
    for dt in (torch.bfloat16, torch.float32):
        for K in KEYS:
            rows.append(row(torch, "atlas_residue", 1, 250, K - 1, 2, dt))
    rows.append(row(torch, "atlas_frame", 1, 250, 256, 1, torch.bfloat16))
    rows.append(row(torch, "4aa_residue", 8, 1000, 4, 2, torch.float32))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump({"card": card, "iters": ITERS, "rows": rows}, fh, indent=1)


if __name__ == "__main__":
    main()
