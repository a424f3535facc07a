"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each source is compiled with ``nvcc`` for ``sm_90a`` in its own process,
all at once, and the objects are linked into one shared library with a plain
C interface, at first use, under ``build/mdgen_tpu_torch/`` at the
repository root, and loaded with ``ctypes`` (no PyTorch headers are
compiled, so a build takes seconds). The library's name carries a hash of
the sources and flags, so an edited source is rebuilt and a stale library is
never loaded. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build", "mdgen_tpu_torch")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: every pointer and the stream are c_void_p, so that
# ctypes never truncates a 64-bit address.
SIGNATURES = {
    "mdgen_fused_l_sublayer": [_P] * 15 + [_I] * 6 + [_F, _I, _I, _P],
    "mdgen_fused_t_sublayer": [_P] * 16 + [_I] * 6 + [_F, _I, _I, _P],
    "mdgen_fused_ffn_sublayer": [_P] * 10 + [_I] * 6 + [_P],
    "mdgen_flash_fwd": [_P] * 6 + [_I] * 5 + [_P],
    "mdgen_flash_bwd_dq": [_P] * 8 + [_I] * 5 + [_P],
    "mdgen_flash_bwd_dkv": [_P] * 10 + [_I] * 5 + [_P],
    "mdgen_opt_max_tensors": [],
    "mdgen_sum_squares": [_P, _P, _I, _I, _P, _I, _I, _P, _P, _P],
    "mdgen_fused_adam": [_P, _P, _I, _I, _P, _P, _I, _P],
}

_lock = threading.Lock()
_lib = None
build_info: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit")


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _digest(flags) -> str:
    """Hash of every file under csrc/ (sources and headers) and the flags."""
    h = hashlib.sha256(" ".join(flags).encode())
    for p in sorted(glob.glob(os.path.join(CSRC, "*"))):
        with open(p, "rb") as fh:
            h.update(os.path.basename(p).encode() + fh.read())
    return h.hexdigest()[:16]


def _run(cmds: list[list[str]]) -> str:
    """Run the commands in parallel; raise on the first failure. Returns
    their output, concatenated."""
    logs, procs = [], []
    try:
        for cmd in cmds:
            log = tempfile.TemporaryFile(mode="w+")
            procs.append((cmd, log, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
        for cmd, log, proc in procs:
            rc = proc.wait()
            log.seek(0)
            logs.append(log.read())
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{logs[-1]}")
    finally:
        for _, log, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    return "".join(logs)


def _compile_and_link(flags, out: str) -> str:
    """One nvcc per source, all started together, then one link."""
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o") for src in sources()]
    try:
        log = _run([[_nvcc(), *flags, "-c", "-o", obj, src]
                    for src, obj in zip(sources(), objs)])
        tmp = f"{out}.{tag}"
        log += _run([[_nvcc(), "-shared", "-o", tmp, *objs]])
        os.replace(tmp, out)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    return log


def build(verbose: bool = False) -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library. ``verbose`` adds
    ``-Xptxas -v`` and keeps the compiler's report (registers, shared memory,
    spills) in ``build_info["log"]``."""
    global _lib
    with _lock:
        if _lib is not None and not verbose:
            return _lib
        flags = NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else [])
        out = os.path.join(BUILD_DIR, f"libmdgen_kernels_{_digest(NVCC_FLAGS)}.so")
        t0 = time.perf_counter()
        if verbose or not os.path.exists(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            build_info["log"] = _compile_and_link(flags, out)
            build_info["built"] = True
        else:
            build_info["built"] = False
        build_info["seconds"] = time.perf_counter() - t0
        build_info["path"] = out
        lib = ctypes.CDLL(out)
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def call(fn_name: str, *args) -> None:
    """Call a C entry point; raise on a non-zero cudaError_t."""
    rc = getattr(build(), fn_name)(*args)
    if rc != 0:
        raise RuntimeError(f"{fn_name} failed: cudaError_t {rc}")
