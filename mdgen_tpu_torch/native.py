"""ctypes bindings of the port's C++ trajectory writers (``native/*.cpp``).

The multi-MODEL PDB writer and the XTC encoder write the same bytes as the
Python writers of ``protein.py`` and ``xtc.py``, in a fraction of the time
(a long trajectory is millions of ATOM records). The library is built with
``g++`` at first use, under ``build/mdgen_tpu_torch/`` at the repository
root, and its name carries a hash of the sources and flags, so an edited
source is rebuilt and a stale library is never loaded. A build that fails
raises with the compiler's output: nothing falls back to the Python writers
behind the caller's back (they are chosen with ``use_native=False``).
Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_HERE, "native")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build", "mdgen_tpu_torch")
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall"]

_lock = threading.Lock()
_lib = None


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(SRC_DIR, "*.cpp")))


def _digest(flags) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for p in sources():
        with open(p, "rb") as fh:
            h.update(os.path.basename(p).encode() + fh.read())
    return h.hexdigest()[:16]


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.mdgen_write_xtc.restype = ctypes.c_int64
    lib.mdgen_write_xtc.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_float,
        ctypes.c_char_p,
    ]
    lib.mdgen_write_pdb_models.restype = ctypes.c_int64
    lib.mdgen_write_pdb_models.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_char_p,
        ctypes.c_int64,
    ]
    return lib


def build(cxx: str = "g++", build_dir: str = BUILD_DIR) -> ctypes.CDLL:
    """Compile (if the library for these sources and flags is missing) and
    load the writers. Raises RuntimeError with the compiler's output when
    the build fails."""
    out = os.path.join(build_dir, f"libmdgen_native_{_digest(CXX_FLAGS)}.so")
    if not os.path.exists(out):
        os.makedirs(build_dir, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [cxx, *CXX_FLAGS, "-o", tmp, *sources()]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except OSError as e:
            raise RuntimeError(f"building the native writers failed: {' '.join(cmd)}: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"building the native writers failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return _bind(ctypes.CDLL(out))


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            _lib = build()
        return _lib


def available() -> bool:
    """True when the library builds and loads (False, not an error, when it
    cannot: the writers themselves raise)."""
    try:
        _load()
        return True
    except RuntimeError:
        return False


def write_pdb_models(
    positions: np.ndarray,  # [T, L, 37, 3] float32
    mask: np.ndarray,  # [L, 37]
    names4: bytes,  # 37 * 4 chars
    elems: bytes,  # 37 chars
    res3: bytes,  # L * 3 chars
    res_index: np.ndarray,  # [L] int32
) -> str:
    """Returns the PDB text of every frame as a MODEL."""
    lib = _load()
    positions = np.ascontiguousarray(positions, dtype=np.float32)
    mask = np.ascontiguousarray(mask, dtype=np.float32)
    res_index = np.ascontiguousarray(res_index, dtype=np.int32)
    T, L = positions.shape[:2]
    n_atoms = int((mask > 0.5).sum())
    # an ATOM record is 79 bytes while every coordinate fits "%8.3f"; a
    # coordinate of 10^4 A or more widens its field (the writer refuses to
    # start a record with fewer than 96 bytes left)
    finite = np.abs(positions[np.isfinite(positions)])
    width = len(f"{-float(finite.max()):.3f}") if finite.size else 8
    cap = T * (n_atoms * (80 + 3 * max(width - 8, 0)) + 32) + 128
    buf = ctypes.create_string_buffer(cap)
    n = lib.mdgen_write_pdb_models(
        positions.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        names4,
        elems,
        res3,
        res_index.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        T,
        L,
        buf,
        cap,
    )
    if n < 0:
        raise RuntimeError(f"mdgen_write_pdb_models failed ({n}): {T} frames x {L} residues")
    return buf.raw[:n].decode("ascii")


def write_xtc(
    coords_nm: np.ndarray,  # [T, N, 3] float32, nanometers
    steps,  # [T] int32 or None
    times,  # [T] float32 or None
    precision: float,
    path: str,
) -> None:
    """Write an XTC trajectory with the native encoder."""
    lib = _load()
    coords_nm = np.ascontiguousarray(coords_nm, dtype=np.float32)
    T, N = coords_nm.shape[:2]
    steps_p = None
    times_p = None
    if steps is not None:
        steps = np.ascontiguousarray(steps, dtype=np.int32)
        steps_p = steps.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    if times is not None:
        times = np.ascontiguousarray(times, dtype=np.float32)
        times_p = times.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    rc = lib.mdgen_write_xtc(
        coords_nm.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        T,
        N,
        steps_p,
        times_p,
        ctypes.c_float(precision),
        path.encode(),
    )
    if rc != 0:
        raise RuntimeError(f"mdgen_write_xtc failed ({rc}): {T} frames x {N} atoms -> {path}")
