#!/usr/bin/env python3
"""Times the flash forward (kernels 4 and 5) of build variants of the port
against the tree as it is, on one card.

    python3 tools/flash_fwd_variants.py [ROOT]

Copies the port of a checkout (default: the one holding this script) into
temporary directories, once for each variant below, each an edit of one
line of `csrc/`:

  * as_is: no edit (run first and last, so the others fall between two
    readings of it);
  * p_bf16: the bf16 P V product takes P as one bf16 fragment, hi alone,
    as FA2 rounds it (one MMA a step where the hi + lo pair of the JAX
    semantics takes two): what keeping P in f32 costs;
  * blocks_2, blocks_6: the forward's `__launch_bounds__` asks for 2 or 6
    blocks an SM (at most 255 or 80 registers a thread) instead of 4.

Each copy builds its own kernels with `-Xptxas -v` and, in a fresh process,
times kernels 4 and 5 at the training recipe's shape (N = 512, Tq = 1000,
Tk = 1001, d = 24, a masked residue) in f32 and with bf16 operands, as
device time around a CUDA graph of 5 calls (`chip_smoke._graph_ms`), and
reads o against the plain twin. Prints the forward instantiations'
registers and spills and one JSON line per variant, with the card's name
and power limit. Needs a CUDA device and the CUDA toolkit.
"""
import importlib
import json
import os
import shutil
import subprocess
import sys
import tempfile

# variant: [(file under csrc/, line as it is, line in the variant)]
VARIANTS = {
    "as_is": [],
    "p_bf16": [("mma_tile.cuh", "        if constexpr (!ROUND_A) mma_bf16(out[nt], lo, b);\n", "")],
    "blocks_2": [("flash_attention.cu", "constexpr int kFwdMinBlocks = 4;\n",
                  "constexpr int kFwdMinBlocks = 2;\n")],
    "blocks_6": [("flash_attention.cu", "constexpr int kFwdMinBlocks = 4;\n",
                  "constexpr int kFwdMinBlocks = 6;\n")],
}
ORDER = ["as_is", "p_bf16", "blocks_2", "blocks_6", "as_is"]


def _copy(root, dst, variant):
    shutil.copytree(os.path.join(root, "mdgen_tpu_torch"), os.path.join(dst, "mdgen_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(root, "chip_smoke.py"), dst)
    for name, old, new in VARIANTS[variant]:
        path = os.path.join(dst, "mdgen_tpu_torch", "csrc", name)
        with open(path) as fh:
            text = fh.read()
        if text.count(old) != 1:
            raise RuntimeError(f"{variant}: expected one {old.strip()!r} in {path}")
        with open(path, "w") as fh:
            fh.write(text.replace(old, new))


def _fwd_ptxas(log):
    """[(kernel entry, 'Used ...' line, spill line)] of flash_fwd_kernel."""
    out, entry, spill = [], None, ""
    for line in log.splitlines():
        if "Compiling entry" in line:
            entry = line.split("'")[1] if "flash_fwd_kernel" in line else None
        elif entry and "spill" in line:
            spill = line.split(":", 1)[-1].strip()
        elif entry and "Used" in line:
            out.append((entry, line.split(":", 1)[-1].strip(), spill))
            entry = None
    return out


def _one(root, variant):
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from mdgen_tpu_torch.ops import _build

    fa = importlib.import_module("mdgen_tpu_torch.ops.flash_attention")  # not the function

    _, _, smi = cs.phase_device(torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(verbose=True)
    for entry, used, spill in _fwd_ptxas(_build.build_info["log"]):
        print(f"[ptxas] {variant} {entry}: {used}; {spill}", flush=True)
    N, Tq, Tk, d = cs.B_TRAIN * cs.L * cs.H, cs.TRAIN_FRAMES, cs.TRAIN_FRAMES + 1, cs.C // cs.H
    g = torch.Generator().manual_seed(0)
    q = (torch.randn(N, Tq, d, generator=g) * d**-0.5).cuda()
    k, v = torch.randn(N, Tk, d, generator=g).cuda(), torch.randn(N, Tk, d, generator=g).cuda()
    bias = torch.zeros(N, Tk, device="cuda")
    bias[(cs.L - 1) * cs.H:cs.L * cs.H, :-1] = fa.NEG_INF
    res = {"variant": variant, "card": smi}
    for dname, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        qd, kd, vd = (t.to(dt) for t in (q, k, v))
        o_ref = fa.flash_attention_plain(qd, kd, vd, bias)[0]
        res[f"{dname}_o_abs_err"] = cs._abs_err(fa.flash_fwd(qd, kd, vd, bias), o_ref)
        del o_ref
        for name, fn in (("flash_fwd", fa.flash_fwd), ("flash_fwd_lse", fa.flash_fwd_lse)):
            res[f"{name}_{dname}_device_ms"] = cs._graph_ms(torch, lambda: fn(qd, kd, vd, bias),
                                                           iters=5)
        torch.cuda.empty_cache()
    print("[flash_fwd_variants]", json.dumps(res), flush=True)


def main(argv):
    if argv[:1] == ["--one"]:  # one copy, in this process
        return _one(argv[1], argv[2])
    root = os.path.abspath(argv[0] if argv else os.path.join(os.path.dirname(__file__), ".."))
    for variant in ORDER:
        with tempfile.TemporaryDirectory(prefix=f"mdgen_fwd_{variant}_") as dst:
            _copy(root, dst, variant)
            subprocess.run([sys.executable, os.path.abspath(__file__), "--one", dst, variant],
                           check=True)


if __name__ == "__main__":
    main(sys.argv[1:])
