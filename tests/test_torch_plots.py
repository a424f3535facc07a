"""``--plot`` of the port's three analysis CLIs against the scripts'
``make_plot`` (loaded from source as ``tests/test_plots.py`` loads them).

Each side's figure is captured as it is saved (``Figure.savefig`` patched;
the PDF is still written) and compared axes by axes: every line's data,
every patch's vertices in data coordinates (histogram steps, bars), every
image's array (free-energy surfaces, transition matrices), every
collection's offsets and sizes (scatter points), the titles, scales, tick
labels and annotations. Pixels are not compared. The TPS figure
featurizes the reference MD itself; both sides take the port's featurizer
there (the two featurizers differ in the last bits of f32, which moves the
state centroids by as much; the featurizer is held to JAX's in
``test_torch_analysis.py``). The sim CLI writes its
PDF end to end; the TPS and upsampling CLIs' are checked in
``test_torch_tps.py`` and ``test_torch_upsampling.py``.
"""
import numpy as np
import pytest
from matplotlib.figure import Figure
from test_plots import _load_script_ns

from mdgen_tpu_torch import analyze_peptide_sim, analyze_peptide_tps, analyze_upsampling
from mdgen_tpu_torch.analysis import featurize_torsions, get_state_probs
from mdgen_tpu_torch.analysis.featurize import describe_features
from mdgen_tpu_torch.analysis.reference_msm import build_reference_msm, lowest_flux_states
from mdgen_tpu_torch.data import synthetic_rotamer_trajectory
from mdgen_tpu_torch.geometry import constants as rc
from mdgen_tpu_torch.protein import save_trajectory

SEQ = "ACDE"


@pytest.fixture
def saved(monkeypatch):
    """The figures saved while the fixture is active, in order."""
    figs = []
    save = Figure.savefig

    def capture(self, *args, **kwargs):
        figs.append(self)
        return save(self, *args, **kwargs)

    monkeypatch.setattr(Figure, "savefig", capture)
    return figs


def _axes_content(fig):
    out = []
    for ax in fig.axes:
        out.append({
            "lines": [ln.get_xydata() for ln in ax.get_lines()],
            "patches": [p.get_patch_transform().transform(p.get_path().vertices)
                        for p in ax.patches],
            "images": [np.ma.filled(np.ma.asarray(im.get_array(), float), np.nan)
                       for im in ax.get_images()],
            "collections": [np.asarray(c.get_offsets()) for c in ax.collections]
            + [np.asarray(c.get_sizes()) for c in ax.collections],
            "labels": [ax.get_title(), ax.get_xscale(), ax.get_xlabel(), ax.get_ylabel(),
                       [t.get_text() for t in ax.get_yticklabels()], ax.axison],
            "texts": [(t.get_text(), tuple(np.ravel(getattr(t, "xy", ())))) for t in ax.texts],
        })
    return out


def _assert_same_figure(got, want):
    assert len(got.axes) == len(want.axes) > 0
    n = 0
    for i, (g, w) in enumerate(zip(_axes_content(got), _axes_content(want))):
        assert g["labels"] == w["labels"], i
        assert g["texts"] == w["texts"], i
        for kind in ("lines", "patches", "images", "collections"):
            assert len(g[kind]) == len(w[kind]), (i, kind)
            for a, b in zip(g[kind], w[kind]):
                assert a.shape == b.shape and np.array_equal(a, b, equal_nan=True), (i, kind)
                n += 1
    return n


def _sim_inputs(rng):
    aatype = rc.str_sequence_to_aatype(SEQ)
    feats = describe_features(aatype, sidechains=True)
    F = len(feats)
    ref_ang = rng.uniform(-np.pi, np.pi, (400, F))
    traj_ang = rng.vonmises(0.3, 2.0, (120, F))
    ref_tica, traj_tica = rng.normal(size=(400, 3)), rng.normal(0.2, 1.1, (120, 3))
    curve = lambda tau: np.exp(-np.arange(60) / tau).astype(np.float16)  # noqa: E731
    out = {
        "features": feats,
        "JSD": {f: float(v) for f, v in zip(feats + ["TICA-0"], rng.uniform(0, 1, F + 1))},
        "md_decorrelation": {**{f: curve(20 + i) for i, f in enumerate(feats)}, "tica": curve(9)},
        "our_decorrelation": {**{f: curve(15 + i) for i, f in enumerate(feats)},
                              "tica": curve(7)},
        "ref_metastable_probs": rng.dirichlet(np.ones(10)),
        "traj_metastable_probs": rng.dirichlet(np.ones(10)),
        "msm_transition_matrix": rng.dirichlet(np.ones(10), 10),
        "traj_transition_matrix": rng.dirichlet(np.ones(10), 10),
    }
    return out, feats, ref_ang, traj_ang, ref_tica, traj_tica


def test_sim_plot_matches_script(saved, tmp_path):
    out, feats, ref_ang, traj_ang, ref_tica, traj_tica = _sim_inputs(np.random.default_rng(0))
    ns = _load_script_ns("analyze_peptide_sim.py",
                         ["x", "--mddir", "/nonexistent", "--pdbdir", str(tmp_path), "--plot"])
    ns["make_plot"](SEQ, out, feats, ref_ang, traj_ang, ref_tica, traj_tica)
    port = tmp_path / "port"
    port.mkdir()
    analyze_peptide_sim.make_plot(SEQ, out, feats, ref_ang, traj_ang, ref_tica, traj_tica,
                                  str(port))
    assert len(saved) == 2 and (port / f"{SEQ}.pdf").stat().st_size > 0
    assert _assert_same_figure(saved[1], saved[0]) > 50


def test_tps_plot_matches_script(saved, tmp_path):
    arr = synthetic_rotamer_trajectory(SEQ, 800, seed=0).astype(np.float32)
    np.save(tmp_path / f"{SEQ}.npy", arr)
    aatype = np.asarray(rc.str_sequence_to_aatype(SEQ))
    meta = build_reference_msm(arr, aatype, tica_lag=50, msm_lag=10, kmeans_k=20,
                               n_metastable=4)
    start, end = lowest_flux_states(meta["cmsm"])
    gen_ys, paths = [], []
    for s in range(0, 500, 100):  # 5 paths: one overlay row, partly empty
        y = meta["tica"].transform(featurize_torsions(arr[s:s + 100], aatype, sidechains=True,
                                                      cossin=True))
        gen_ys.append(y)
        paths.append(meta["msm"].metastable_assignments[meta["kmeans"].transform(y)])
    paths = np.stack(paths)
    gen_tp = np.concatenate([paths[:, ::10], paths[:, -1:]], 1)
    ref_sp, gen_sp = get_state_probs(gen_tp[:2]), get_state_probs(gen_tp)
    ns = _load_script_ns("analyze_peptide_tps.py",
                         ["x", "--mddir", str(tmp_path), "--pdbdir", str(tmp_path), "--plot"])
    ns["_AATYPE_CACHE"][SEQ] = aatype
    ns["featurize_torsions"] = featurize_torsions
    ns["make_plot"](SEQ, meta, gen_ys, gen_tp, start, end, ref_sp, gen_sp)
    out = tmp_path / "port"
    out.mkdir()
    analyze_peptide_tps.make_plot(SEQ, meta, gen_ys, gen_tp, start, end, ref_sp, gen_sp, aatype,
                                  str(tmp_path), str(out))
    assert len(saved) == 2 and (out / f"{SEQ}_tps.pdf").stat().st_size > 0
    assert _assert_same_figure(saved[1], saved[0]) > 20


def test_upsampling_plot_matches_script(saved, tmp_path):
    rng = np.random.default_rng(1)
    out = {"backbone": {}, "sidechain": {}}
    for sec in out:
        for i in range(3):
            tau = rng.uniform(5, 40)
            out[sec][f"res{i}_tor{3 + i}"] = {
                "truth": np.exp(-np.arange(80) / tau).astype(np.float16),
                "gen": np.exp(-np.arange(70) / (tau * 0.8)).astype(np.float16),
                "naive": np.exp(-np.arange(8) * 10 / tau).astype(np.float16),
            }
    ns = _load_script_ns("analyze_upsampling.py",
                         ["x", "--mddir", "/nonexistent", "--pdbdir", str(tmp_path),
                          "--cond_interval", "10", "--plot"])
    ns["make_plot"](SEQ, out)
    port = tmp_path / "port"
    port.mkdir()
    analyze_upsampling.make_plot(SEQ, out, 10, str(port))
    assert len(saved) == 2 and (port / f"{SEQ}_decorr.pdf").stat().st_size > 0
    assert _assert_same_figure(saved[1], saved[0]) > 20


def test_sim_cli_writes_the_plot(saved, tmp_path):
    aatype = rc.str_sequence_to_aatype(SEQ)
    np.save(tmp_path / f"{SEQ}.npy", synthetic_rotamer_trajectory(SEQ, 300, seed=0))
    gen = synthetic_rotamer_trajectory(SEQ, 100, seed=0, path_seed=7).astype(np.float32)
    save_trajectory(gen, aatype, str(tmp_path / f"{SEQ}.pdb"))
    res = analyze_peptide_sim.main(["--mddir", str(tmp_path), "--pdbdir", str(tmp_path),
                                    "--no_msm", "--tica_lag", "10", "--plot"])
    assert set(res) == {SEQ} and (tmp_path / f"{SEQ}.pdf").stat().st_size > 0
    assert len(saved) == 1 and len(saved[0].axes) == 16
