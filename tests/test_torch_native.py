"""The port's C++ trajectory writers (``mdgen_tpu_torch/native.py``) against
its Python writers and the JAX package's writers, byte for byte.

Three writers of each file: the port's native writer, the port's Python
writer (``use_native=False``), and the JAX package's
``mdgen_tpu.protein.atom14_to_pdb`` / ``mdgen_tpu.xtc.write_xtc`` (its native
writer, its default, and its Python one: ``use_native=False``, or for the
PDB the fallback it takes when its library is unavailable). The port's
native writer is held to the JAX package's default everywhere; the two
Python writers to each other. Where the JAX package's own two paths differ,
the port's do too, and the test shows the case:

* PDB: an atom whose coordinates are zero in some frames only. The native
  writers keep the residue type's atoms that are nonzero in any frame (and
  write the zero atom), the Python writers each frame's nonzero atoms.
* XTC: a coordinate whose product with the precision rounds to another
  integer in float32 (the C++ encoder) than in float64 (the Python one).

A build with a compiler that does not exist, or that fails, raises.
"""
import numpy as np
import pytest

from mdgen_tpu import native as jax_native
from mdgen_tpu import protein as jax_protein
from mdgen_tpu import xtc as jax_xtc
from mdgen_tpu_torch import native, protein, xtc
from mdgen_tpu_torch.data import synthetic_trajectory
from mdgen_tpu_torch.geometry import constants as rc


def _traj(seq, frames, seed):
    return synthetic_trajectory(seq, frames, seed=seed).astype(np.float32)


def _pdb_case(case):
    """(atom14 [T, L, 14, 3], aatype [L], whether the two paths agree)."""
    aatype = rc.str_sequence_to_aatype("ACDE")
    if case == "one_frame":
        return _traj("ACDE", 1, 0), aatype, True
    if case == "100x4":
        return _traj("ACDE", 100, 1), aatype, True
    if case == "padded_residue":  # a padding residue: all zero in every frame
        t = _traj("ACDE", 5, 2)
        t[:, 2] = 0.0
        return t, aatype, True
    if case == "unk_residue":  # aatype 20: no atom37 atoms
        aatype = aatype.copy()
        aatype[1] = 20
        return _traj("ACDE", 5, 3), aatype, True
    if case == "zero_in_one_frame":  # residue 3's atoms absent in frame 1 only
        t = _traj("ACDE", 4, 4)
        t[1, 3] = 0.0
        return t, aatype, False
    if case == "huge_coordinates":  # fields wider than "%8.3f" (10^4 A and more)
        return _traj("ACDE", 8, 6) * 3e5, aatype, True
    if case == "wide":  # 12 residues, every residue type's atoms
        seq = "WYNKFHMTRQIP"
        return _traj(seq, 6, 5), rc.str_sequence_to_aatype(seq), True
    raise ValueError(case)


PDB_CASES = ["one_frame", "100x4", "padded_residue", "unk_residue", "zero_in_one_frame",
             "huge_coordinates", "wide"]


@pytest.mark.parametrize("case", PDB_CASES)
def test_pdb_writers_write_the_same_bytes(case, tmp_path, monkeypatch):
    atom14, aatype, agree = _pdb_case(case)
    files = {}
    for name, write in (
            ("port_native", lambda p: protein.atom14_to_pdb(atom14, aatype, p)),
            ("port_python", lambda p: protein.atom14_to_pdb(atom14, aatype, p, use_native=False)),
            ("jax", lambda p: jax_protein.atom14_to_pdb(atom14, aatype, p))):
        path = str(tmp_path / f"{name}.pdb")
        write(path)
        files[name] = open(path, "rb").read()
    assert jax_native.available()  # the JAX default above is its native writer (or,
    # where its buffer is too small, as for huge coordinates, its Python one)
    monkeypatch.setattr(jax_native, "available", lambda: False)
    jax_protein.atom14_to_pdb(atom14, aatype, str(tmp_path / "jax_python.pdb"))
    files["jax_python"] = open(tmp_path / "jax_python.pdb", "rb").read()

    assert files["port_native"] == files["jax"]
    assert files["port_python"] == files["jax_python"]
    assert (files["port_native"] == files["port_python"]) == agree
    text = files["port_native"].decode()
    assert text.count("MODEL") == text.count("ENDMDL") == len(atom14)
    if case == "unk_residue":
        assert " UNK " not in text  # an UNK residue has no atoms to write
    if case == "zero_in_one_frame":
        models = text.split("ENDMDL")
        n_atoms = [m.count("ATOM") for m in models[:-1]]
        assert n_atoms[0] == n_atoms[1] == n_atoms[2]  # native: every frame the same atoms
        py = files["port_python"].decode().split("ENDMDL")
        assert py[1].count("ATOM") < py[0].count("ATOM")  # Python: frame 1 drops them
    # what the native writer wrote reads back within PDB precision (a residue
    # with no atom written is not read back; fields wider than the PDB's
    # columns are not read back either)
    if case not in ("unk_residue", "padded_residue", "huge_coordinates"):
        back, back_aat = protein.load_pdb_trajectory(str(tmp_path / "port_native.pdb"))
        assert np.array_equal(back_aat, aatype)
        assert np.abs(back - atom14).max() <= 5e-4 + 1e-6


def _quantize(coords_nm, precision, dtype):
    """The encoders' integer grid: round half away from zero in ``dtype``."""
    lf = coords_nm.astype(dtype) * dtype(precision)
    return np.where(lf >= 0, lf + dtype(0.5), lf - dtype(0.5)).astype(np.int64)


def _xtc_case(case):
    rng = np.random.default_rng(0)
    if case == "small_n":  # 5 atoms: the uncompressed path
        return (rng.normal(size=(7, 5, 3)) * 2).astype(np.float32)
    if case == "large_n":  # 3000 atoms, runs of nearby atoms
        c = (rng.normal(size=(3, 3000, 3)) * 3).astype(np.float32)
        c[1, 10:20] = c[1, 9] + 1e-3
        return c
    if case == "rounding":  # frame 17 of this draw holds a float32/float64 tie
        return rng.normal(size=(20, 300, 3)).astype(np.float32)
    raise ValueError(case)


@pytest.mark.parametrize("case", ["small_n", "large_n", "rounding"])
def test_xtc_writers_write_the_same_bytes(case, tmp_path):
    coords = _xtc_case(case)
    steps, times = np.arange(len(coords)) * 10, np.arange(len(coords)) * 0.5
    files = {}
    for name, write in (
            ("port_native", lambda p: xtc.write_xtc(p, coords, steps, times)),
            ("port_python", lambda p: xtc.write_xtc(p, coords, steps, times, use_native=False)),
            ("jax", lambda p: jax_xtc.write_xtc(p, coords, steps, times)),
            ("jax_python", lambda p: jax_xtc.write_xtc(p, coords, steps, times,
                                                       use_native=False))):
        path = str(tmp_path / f"{name}.xtc")
        write(path)
        files[name] = open(path, "rb").read()
    assert files["port_native"] == files["jax"]
    assert files["port_python"] == files["jax_python"]

    q32, q64 = _quantize(coords, 1000.0, np.float32), _quantize(coords, 1000.0, np.float64)
    ties = int((q32 != q64).sum())
    assert (files["port_native"] == files["port_python"]) == (ties == 0)
    assert (ties > 0) == (case == "rounding"), ties
    for name, q in (("port_native", q32), ("port_python", q64)):
        got, got_steps, got_times = xtc.read_xtc(str(tmp_path / f"{name}.xtc"))
        assert np.array_equal(np.rint(got.astype(np.float64) * 1000).astype(np.int64), q), name
        assert np.array_equal(got_steps, steps) and np.array_equal(got_times, times)
        assert np.abs(got - coords).max() <= 0.5e-3 + 1e-6
    if ties:  # one quantum apart, where the two roundings differ
        assert np.abs(q32 - q64).max() == 1


def test_save_trajectory_native_and_python(tmp_path):
    """The frame-0 PDB + XTC pair, both writers: equal on this trajectory
    (no rounding tie), and read back the same."""
    atom14 = _traj("WYNK", 50, 6)
    aatype = rc.str_sequence_to_aatype("WYNK")
    for use_native in (True, False):
        d = tmp_path / str(use_native)
        d.mkdir()
        protein.save_trajectory(atom14, aatype, str(d / "x.pdb"), str(d / "x.xtc"),
                                use_native=use_native)
    for f in ("x.pdb", "x.xtc"):
        assert (tmp_path / "True" / f).read_bytes() == (tmp_path / "False" / f).read_bytes(), f
    got, _ = protein.load_trajectory(str(tmp_path / "True" / "x.pdb"))
    assert got.shape == atom14.shape


@pytest.mark.parametrize("cxx", ["/nonexistent/g++", "false"], ids=["missing", "failing"])
def test_a_failed_build_raises(cxx, tmp_path):
    with pytest.raises(RuntimeError, match="building the native writers failed"):
        native.build(cxx=cxx, build_dir=str(tmp_path))
    assert not list(tmp_path.glob("*.so"))


def test_the_library_is_built_from_the_port_sources(tmp_path):
    lib = native.build(build_dir=str(tmp_path))
    built = list(tmp_path.glob("libmdgen_native_*.so"))
    assert len(built) == 1 and lib._name == str(built[0])
    assert [p.rsplit("/", 1)[1] for p in native.sources()] == ["pdb_writer.cpp", "xtc_writer.cpp"]
    assert all("/mdgen_tpu_torch/native/" in p for p in native.sources())
    assert native.available()
