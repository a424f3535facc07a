#!/usr/bin/env python3
"""Shows that chip_smoke.py's f32 tolerance for the flash kernels (4 to 7:
the forward with and without lse, dq, dk/dv) catches a split-TF32 product
that lost a term.

    python3 tools/split_tf32_check.py [ROOT]

Copies the port of a checkout (default: the one holding this script) into
temporary directories: once as it is, and once for each fault below, put
into the f32 warp products of `csrc/mma_tile.cuh` (WarpMma and
WarpMmaAccA):

  * tf32: both correction products dropped, a_big * b_big alone (plain
    TF32, as if the hardware dropped every small half);
  * no_small_a: the a_small * b_big product dropped (one split term lost).

Each copy builds its own kernels and, in a fresh process, holds kernels 4
to 7 in f32 against their plain twins at the training recipe's shape (N =
512, Tq = 1000, Tk = 1001, d = 24) and at chip_smoke.py's edge shapes,
under chip_smoke.py's FLASH_TOL (o and lse absolute, gradients relative),
with its inputs (`_check_flash_edges`). Prints an `[edge]` line per kernel
and shape and one JSON line per build; exits non-zero unless the build as
it is passes everywhere and each faulty build fails each of the four
kernels somewhere. Needs a CUDA device and the CUDA toolkit.
"""
import importlib
import json
import os
import shutil
import subprocess
import sys
import tempfile

# the lines of csrc/mma_tile.cuh that each fault deletes
A_SMALL = ("          mma_tf32(acc[mt][nt], as[mt], bb[nt]);\n",
           "        mma_tf32(out[nt], as, bb);\n")
B_SMALL = ("          mma_tf32(acc[mt][nt], ab[mt], bs[nt]);\n",
           "        mma_tf32(out[nt], ab, bs);\n")
FAULTS = {"as_is": (), "tf32": A_SMALL + B_SMALL, "no_small_a": A_SMALL}
RECIPE = (512, 1000, 1001, 24)


def _copy(root, dst, fault):
    """The port and chip_smoke.py of ``root`` under ``dst``, with ``fault``."""
    shutil.copytree(os.path.join(root, "mdgen_tpu_torch"), os.path.join(dst, "mdgen_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(root, "chip_smoke.py"), dst)
    header = os.path.join(dst, "mdgen_tpu_torch", "csrc", "mma_tile.cuh")
    with open(header) as fh:
        text = fh.read()
    for line in FAULTS[fault]:
        if text.count(line) != 1:
            raise RuntimeError(f"{fault}: expected one {line.strip()!r} in {header}")
        text = text.replace(line, "")
    with open(header, "w") as fh:
        fh.write(text)


def _one(root, fault):
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from mdgen_tpu_torch.ops import _build

    fa = importlib.import_module("mdgen_tpu_torch.ops.flash_attention")  # not the function

    _, _, smi = cs.phase_device(torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    shapes = {"recipe": RECIPE, **cs.FLASH_EDGE_SHAPES}
    rows = cs._check_flash_edges(torch, fa, shapes, dtypes=("f32",), strict=False)
    err, passes = {}, {}
    for name, _, shape, e, _, ok in rows:
        err.setdefault(name, {})[shape] = e
        passes[name] = passes.get(name, True) and ok
    print("[split_tf32_check]", json.dumps({
        "fault": fault, "card": smi, "kernels_from": _build.build_info["path"],
        "tol": cs.FLASH_TOL["f32"], "passes": passes, "err": err}), flush=True)


def main(argv):
    if argv[:1] == ["--one"]:  # one copy, in this process
        return _one(argv[1], argv[2])
    root = os.path.abspath(argv[0] if argv else os.path.join(os.path.dirname(__file__), ".."))
    passes = {}
    for fault in FAULTS:
        with tempfile.TemporaryDirectory(prefix=f"mdgen_split_{fault}_") as dst:
            _copy(root, dst, fault)
            out = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", dst, fault],
                                 check=True, stdout=subprocess.PIPE, text=True).stdout
        print(out, end="", flush=True)
        line = next(x for x in out.splitlines() if x.startswith("[split_tf32_check]"))
        passes[fault] = json.loads(line.split(" ", 1)[1])["passes"]
    if not all(passes["as_is"].values()) or any(
            any(passes[f].values()) for f in FAULTS if f != "as_is"):
        raise SystemExit(f"the tolerance does not separate the builds: passes {passes}")


if __name__ == "__main__":
    main(sys.argv[1:])
