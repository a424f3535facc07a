"""Distribution / kinetics metrics used by the evaluation scripts (a copy
of ``mdgen_tpu/analysis/metrics.py``: numpy and scipy only).

Ports of the metric definitions in the reference analysis scripts
(reference `scripts/analyze_peptide_sim.py:51-150`): torsion-marginal and
Ramachandran JSDs, autocovariance-based decorrelation curves.
"""
from __future__ import annotations

import numpy as np
from scipy.spatial.distance import jensenshannon as _scipy_jensenshannon


def jensen_shannon(p: np.ndarray, q: np.ndarray) -> float:
    """Jensen-Shannon *distance*, exactly scipy's definition: the square
    root of the JS divergence with natural-log KL terms. The reference's
    headline quality numbers are ``scipy.spatial.distance.jensenshannon``
    on histogram counts (reference `scripts/analyze_peptide_sim.py:21,54,59`),
    so this must be byte-comparable — do not substitute a base-2 or
    non-sqrt variant."""
    p = np.asarray(p, np.float64)
    q = np.asarray(q, np.float64)
    return float(_scipy_jensenshannon(p, q))


def hist_jsd(a: np.ndarray, b: np.ndarray, bins: int = 100,
             range_=(-np.pi, np.pi)) -> float:
    """JSD between 1D histograms (reference uses 100 bins over [-pi, pi])."""
    pa, _ = np.histogram(a, bins=bins, range=range_)
    pb, _ = np.histogram(b, bins=bins, range=range_)
    return jensen_shannon(pa, pb)


def hist_jsd_2d(a1, a2, b1, b2, bins: int = 50, range_=(-np.pi, np.pi)) -> float:
    """JSD between 2D (Ramachandran) histograms (reference uses 50 bins)."""
    pa, _, _ = np.histogram2d(a1, a2, bins=bins, range=[range_, range_])
    pb, _, _ = np.histogram2d(b1, b2, bins=bins, range=[range_, range_])
    return jensen_shannon(pa.ravel(), pb.ravel())


def acovf(x: np.ndarray, nlag: int, adjusted: bool = False,
          demean: bool = True) -> np.ndarray:
    """statsmodels.tsa.stattools.acovf equivalent (fft path): lags 0..nlag,
    ``adjusted`` divides lag k by (n-k) instead of n, ``demean`` subtracts
    the mean first. The reference analysis calls this with
    adjusted=True, demean=False (reference `scripts/analyze_peptide_sim.py:68`).
    """
    x = np.asarray(x, np.float64)
    n = len(x)
    nlag = min(nlag, n - 1)
    xc = x - x.mean() if demean else x
    f = np.fft.fft(xc, n=2 * n)
    acov = np.fft.ifft(f * np.conj(f))[: nlag + 1].real
    if adjusted:
        acov = acov / (n - np.arange(nlag + 1))
    else:
        acov = acov / n
    return acov


def autocovariance(x: np.ndarray, nlags: int) -> np.ndarray:
    return acovf(x, nlags, adjusted=False, demean=True)


def autocorrelation(x: np.ndarray, nlags: int) -> np.ndarray:
    acov = autocovariance(x, nlags)
    return acov / acov[0] if acov[0] != 0 else acov


def torsion_decorrelation_curve(angles: np.ndarray, nlag: int) -> np.ndarray:
    """The reference's normalized sin/cos decorrelation:
    (acovf(sin) + acovf(cos) - baseline) / (1 - baseline) with
    baseline = E[sin]^2 + E[cos]^2 (reference
    `scripts/analyze_peptide_sim.py:68-77`)."""
    s = acovf(np.sin(angles), nlag, adjusted=True, demean=False)
    c = acovf(np.cos(angles), nlag, adjusted=True, demean=False)
    baseline = np.sin(angles).mean() ** 2 + np.cos(angles).mean() ** 2
    return (s + c - baseline) / (1 - baseline)


def torsion_decorrelation(angles: np.ndarray, nlags: int) -> np.ndarray:
    """Mean normalized autocorrelation of (sin, cos) components of a torsion
    time series [T] (reference `scripts/analyze_peptide_sim.py:65-101`)."""
    s = autocovariance(np.sin(angles), nlags)
    c = autocovariance(np.cos(angles), nlags)
    denom = s[0] + c[0]
    return (s + c) / denom if denom != 0 else s + c
