"""Reference-MD MSM construction for endpoint-state selection (port of
``mdgen_tpu/analysis/reference_msm.py`` onto the port's featurizer).

Builds the TICA -> k-means -> MSM -> PCCA+ -> coarse MSM pipeline the TPS and
design inference scripts use to pick metastable endpoint states (reference
`tps_inference.py:84-118`, `design_inference.py:77-116`), from atom14 ``.npy``
trajectories with our NumPy toolkit instead of PyEMMA + XTC round-trips.
"""
from __future__ import annotations

import os
import pickle

import numpy as np

from .featurize import featurize_torsions
from .msm import KMeans, TICA, estimate_markov_model


def build_reference_msm(
    arr: np.ndarray,
    aatype: np.ndarray,
    tica_lag: int = 1000,
    kmeans_k: int = 100,
    msm_lag: int = 1000,
    n_metastable: int = 10,
    seed: int = 137,
    chunk: int = 20000,
) -> dict:
    """arr: [T, L, 14, 3] reference MD; returns the msm metadata dict."""
    feats = np.concatenate(
        [
            featurize_torsions(
                np.asarray(arr[i : i + chunk], np.float32), aatype, sidechains=True
            )
            for i in range(0, len(arr), chunk)
        ],
        axis=0,
    )
    tica = TICA(lag=tica_lag).fit(feats)
    Y = tica.transform(feats)
    kmeans = KMeans(k=min(kmeans_k, len(Y)), seed=seed).fit(Y)
    ref_kmeans = kmeans.transform(Y)
    msm = estimate_markov_model(ref_kmeans, lag=msm_lag, n_states=kmeans.k)
    msm.pcca(n_metastable)
    ref_discrete = msm.metastable_assignments[ref_kmeans]
    cmsm = estimate_markov_model(
        ref_discrete, lag=msm_lag, n_states=n_metastable
    )
    return {
        "tica": tica,
        "kmeans": kmeans,
        "ref_kmeans": ref_kmeans,
        "msm": msm,
        "cmsm": cmsm,
        "ref_discrete": ref_discrete,
    }


class JaxCacheError(ValueError):
    """An MSM cache written by the JAX package, which the port does not load."""


class _PortUnpickler(pickle.Unpickler):
    """Refuses a class of the JAX package: a cache written by
    ``mdgen_tpu``'s CLIs names ``mdgen_tpu.analysis.msm``, and loading it
    would import jax."""

    def __init__(self, fh, path: str):
        super().__init__(fh)
        self.path = path

    def find_class(self, module, name):
        if module == "mdgen_tpu" or module.startswith("mdgen_tpu."):
            raise JaxCacheError(
                f"{self.path} was written by the JAX package (it pickles {module}.{name}); "
                "the port does not load it: delete it, or use another --out_dir, to rebuild "
                "the MSM with mdgen_tpu_torch")
        return super().find_class(module, name)


def load_msm_cache(path: str) -> dict:
    """The metadata pickle that :func:`load_or_build_msm` wrote; raises
    :class:`JaxCacheError` (a ValueError) for one written by the JAX
    package."""
    with open(path, "rb") as fh:
        return _PortUnpickler(fh, path).load()


def load_or_build_msm(cache_path: str, arr, aatype, **kw) -> dict:
    """The cached MSM at ``cache_path`` (one the port wrote), else a new one,
    written there."""
    if os.path.exists(cache_path):
        return load_msm_cache(cache_path)
    meta = build_reference_msm(arr, aatype, **kw)
    with open(cache_path, "wb") as fh:
        pickle.dump(meta, fh)
    return meta


def lowest_flux_states(cmsm) -> tuple[int, int]:
    """argmin of nonzero flux T_ij * pi_j (reference `tps_inference.py:110-112`),
    mapped from active-set indices back to metastable labels (the reference
    implicitly assumes the active set covers all states)."""
    flux = cmsm.transition_matrix * cmsm.pi[None, :]
    flux[flux < 1e-7] = np.inf
    i, j = np.unravel_index(np.argmin(flux), flux.shape)
    return int(cmsm.active_set[i]), int(cmsm.active_set[j])


def highest_flux_states(cmsm) -> tuple[int, int]:
    """argmax off-diagonal flux (reference `design_inference.py:102-104`),
    mapped to metastable labels via the active set."""
    flux = cmsm.transition_matrix * cmsm.pi[None, :]
    np.fill_diagonal(flux, 0)
    i, j = np.unravel_index(np.argmax(flux), flux.shape)
    return int(cmsm.active_set[i]), int(cmsm.active_set[j])
