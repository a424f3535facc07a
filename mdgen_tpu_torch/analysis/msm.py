"""TICA, k-means, Markov state models, PCCA+ — pure NumPy (a copy of
``mdgen_tpu/analysis/msm.py``).

Drop-in capability replacement for the PyEMMA calls in the reference
analysis layer (reference `mdgen/analysis.py:31-48`) plus straight ports of
its discrete transition-path math (reference `mdgen/analysis.py:61-100`).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# ---------------------------------------------------------------------------
# TICA
# ---------------------------------------------------------------------------


@dataclass
class TICA:
    """Time-lagged independent component analysis with the symmetric
    (reversible) estimator and kinetic-map scaling, matching
    ``pyemma.coordinates.tica(lag, kinetic_map=True)`` semantics."""

    lag: int = 1000
    dim: int | None = None
    kinetic_map: bool = True
    epsilon: float = 1e-6
    mean_: np.ndarray = field(default=None, repr=False)
    eigenvalues: np.ndarray = field(default=None, repr=False)
    components_: np.ndarray = field(default=None, repr=False)

    def fit(self, trajs):
        if isinstance(trajs, np.ndarray):
            trajs = [trajs]
        lag = self.lag
        pairs0, pairs1 = [], []
        for X in trajs:
            if len(X) > lag:
                pairs0.append(X[:-lag])
                pairs1.append(X[lag:])
        if not pairs0:
            raise ValueError(
                f"TICA lag {lag} >= every trajectory length "
                f"({[len(X) for X in trajs]}); lower --tica_lag"
            )
        X0 = np.concatenate(pairs0, 0).astype(np.float64)
        X1 = np.concatenate(pairs1, 0).astype(np.float64)
        # symmetrized mean (reversible estimate)
        mean = 0.5 * (X0.mean(0) + X1.mean(0))
        self.mean_ = mean
        X0c, X1c = X0 - mean, X1 - mean
        n = len(X0c)
        C0 = (X0c.T @ X0c + X1c.T @ X1c) / (2 * n)
        Ct = (X0c.T @ X1c + X1c.T @ X0c) / (2 * n)

        # whiten by C0^(-1/2) with rank truncation
        s, U = np.linalg.eigh(C0)
        keep = s > self.epsilon * s.max()
        L = U[:, keep] / np.sqrt(s[keep])
        M = L.T @ Ct @ L
        ev, V = np.linalg.eigh(M)
        order = np.argsort(ev)[::-1]
        ev, V = ev[order], V[:, order]
        comps = L @ V  # columns are tica eigenvectors in feature space
        if self.dim is not None:
            ev, comps = ev[: self.dim], comps[:, : self.dim]
        self.eigenvalues = ev
        self.components_ = comps
        return self

    def transform(self, X):
        Y = (np.asarray(X, np.float64) - self.mean_) @ self.components_
        if self.kinetic_map:
            Y = Y * self.eigenvalues
        return Y


def get_tica(traj, lag: int = 1000):
    """Parity helper (reference `mdgen/analysis.py:31-34`)."""
    t = TICA(lag=lag).fit(traj)
    return t, t.transform(traj)


# ---------------------------------------------------------------------------
# k-means
# ---------------------------------------------------------------------------


@dataclass
class KMeans:
    k: int = 100
    max_iter: int = 100
    seed: int = 137
    centers: np.ndarray = field(default=None, repr=False)

    def fit(self, X):
        X = np.asarray(X, np.float64)
        rng = np.random.default_rng(self.seed)
        n = len(X)
        # k-means++ seeding
        centers = [X[rng.integers(n)]]
        d2 = np.sum((X - centers[0]) ** 2, -1)
        for _ in range(1, self.k):
            p = d2 / d2.sum()
            centers.append(X[rng.choice(n, p=p)])
            d2 = np.minimum(d2, np.sum((X - centers[-1]) ** 2, -1))
        C = np.stack(centers)
        for _ in range(self.max_iter):
            assign = self._assign(X, C)
            newC = np.stack(
                [
                    X[assign == j].mean(0) if (assign == j).any() else C[j]
                    for j in range(self.k)
                ]
            )
            if np.allclose(newC, C):
                break
            C = newC
        self.centers = C
        return self

    @staticmethod
    def _assign(X, C):
        # chunked distance computation to bound memory
        out = np.empty(len(X), dtype=np.int64)
        step = 65536
        for i in range(0, len(X), step):
            d = (
                np.sum(X[i : i + step] ** 2, -1)[:, None]
                - 2 * X[i : i + step] @ C.T
                + np.sum(C**2, -1)[None]
            )
            out[i : i + step] = np.argmin(d, -1)
        return out

    def transform(self, X):
        return self._assign(np.asarray(X, np.float64), self.centers)


def get_kmeans(traj, k: int = 100):
    km = KMeans(k=k).fit(traj)
    return km, km.transform(traj)


# ---------------------------------------------------------------------------
# Markov state models
# ---------------------------------------------------------------------------


def _count_matrix(dtraj, lag, n):
    C = np.zeros((n, n))
    for d in dtraj if isinstance(dtraj, list) else [dtraj]:
        d = np.asarray(d)
        np.add.at(C, (d[:-lag], d[lag:]), 1.0)
    return C


def _largest_connected_set(C):
    """Strongly connected component containing the most counts."""
    n = len(C)
    adj = C > 0
    # Tarjan-free approach: iterative reachability both ways from each node
    unvisited = set(range(n))
    best, best_weight = None, -1.0
    while unvisited:
        seed = next(iter(unvisited))
        fwd = _reach(adj, seed)
        bwd = _reach(adj.T, seed)
        scc = fwd & bwd
        unvisited -= scc if scc else {seed}
        w = C[np.ix_(sorted(scc), sorted(scc))].sum() if scc else 0
        if w > best_weight:
            best, best_weight = sorted(scc), w
    return np.asarray(best if best else [0])


def _reach(adj, seed):
    seen = {seed}
    stack = [seed]
    while stack:
        i = stack.pop()
        for j in np.nonzero(adj[i])[0]:
            if j not in seen:
                seen.add(int(j))
                stack.append(int(j))
    return seen


def _reversible_mle(C, n_iter=1000, tol=1e-10):
    """Standard fixed-point iteration for the reversible transition matrix
    (Bowman et al.); rows normalize x_ij / sum_j."""
    C = np.asarray(C, np.float64)
    Csym = C + C.T
    X = Csym / Csym.sum()
    c_i = C.sum(1)
    for _ in range(n_iter):
        x_i = X.sum(1)
        denom = c_i[:, None] / np.maximum(x_i[:, None], 1e-300) + c_i[None, :] / np.maximum(
            x_i[None, :], 1e-300
        )
        X_new = Csym / np.maximum(denom, 1e-300)
        X_new = X_new / X_new.sum()
        if np.abs(X_new - X).max() < tol:
            X = X_new
            break
        X = X_new
    T = X / np.maximum(X.sum(1, keepdims=True), 1e-300)
    return T


@dataclass
class MarkovStateModel:
    transition_matrix: np.ndarray
    active_set: np.ndarray
    lag: int
    pi: np.ndarray = None
    metastable_assignments: np.ndarray = None  # filled by pcca()
    n_full_states: int = 0

    @property
    def stationary_distribution(self):
        return self.pi

    def pcca(self, n_metastable: int):
        assign_active = pcca_assignments(self.transition_matrix, n_metastable)
        # map to the FULL state alphabet; inactive states -> nearest metastable 0
        full = np.zeros(self.n_full_states, dtype=int)
        full[self.active_set] = assign_active
        self.metastable_assignments = full
        return self


def estimate_markov_model(
    dtraj, lag: int, reversible: bool = True, n_states: int | None = None
) -> MarkovStateModel:
    """Count at ``lag``, restrict to the largest connected set, reversible MLE
    (pyemma.msm.estimate_markov_model parity, reference
    `mdgen/analysis.py:40-45`)."""
    ds = dtraj if isinstance(dtraj, list) else [dtraj]
    n = n_states or (max(int(np.max(d)) for d in ds) + 1)
    C = _count_matrix(ds, lag, n)
    active = _largest_connected_set(C)
    Ca = C[np.ix_(active, active)]
    T = _reversible_mle(Ca) if reversible else Ca / np.maximum(
        Ca.sum(1, keepdims=True), 1e-300
    )
    # stationary distribution: leading left eigenvector
    ev, V = np.linalg.eig(T.T)
    i = np.argmin(np.abs(ev - 1.0))
    pi = np.real(V[:, i])
    pi = np.abs(pi) / np.abs(pi).sum()
    return MarkovStateModel(
        transition_matrix=T, active_set=active, lag=lag, pi=pi, n_full_states=n
    )


# ---------------------------------------------------------------------------
# PCCA+ (inner simplex algorithm)
# ---------------------------------------------------------------------------


def pcca_assignments(T: np.ndarray, n: int) -> np.ndarray:
    """Crisp metastable assignments via PCCA+ on a reversible transition
    matrix: spectral embedding into the top-n eigenvectors, simplex-vertex
    identification, membership by linear transform, argmax."""
    n_states = len(T)
    n = min(n, n_states)
    if n <= 1:
        return np.zeros(n_states, dtype=int)

    # right eigenvectors in the pi-weighted inner product
    ev, V = np.linalg.eig(T)
    order = np.argsort(-np.real(ev))
    chi = np.real(V[:, order[:n]])
    # normalize first eigenvector to constant 1
    chi[:, 0] = 1.0

    # inner simplex algorithm: pick the n most spread-out rows as vertices
    idx = np.zeros(n, dtype=int)
    # first vertex: farthest row from the mean
    d = np.linalg.norm(chi - chi.mean(0), axis=1)
    idx[0] = np.argmax(d)
    ortho = chi - chi[idx[0]]
    for k in range(1, n):
        # project out directions already chosen, take farthest remaining row
        if k > 1:
            prev = ortho[idx[k - 1]]
            denom = prev @ prev
            if denom > 1e-12:
                ortho = ortho - np.outer(ortho @ prev, prev / denom)
        idx[k] = np.argmax(np.linalg.norm(ortho, axis=1))

    A = chi[idx]  # n x n vertex matrix
    try:
        memb = chi @ np.linalg.inv(A)
    except np.linalg.LinAlgError:
        memb = chi @ np.linalg.pinv(A)
    return np.argmax(memb, axis=1)


# ---------------------------------------------------------------------------
# Discrete transition-path math (ports of reference `mdgen/analysis.py:61-100`)
# ---------------------------------------------------------------------------


def sample_tp(trans, start_state, end_state, traj_len, n_samples, rng=None):
    """Bridge sampling of discrete transition paths via matrix powers."""
    rng = rng or np.random.default_rng()
    N = traj_len
    n_states = len(trans)
    powers = [np.linalg.matrix_power(trans, k) for k in range(N + 1)]

    s_t = np.full(n_samples, start_state, dtype=int)
    states = [s_t]
    for t in range(1, N - 1):
        numerator = powers[N - t - 1][:, end_state] * trans[s_t, :]
        denom = powers[N - t][s_t, end_state][:, None]
        probs = numerator / np.maximum(denom, 1e-300)
        probs = probs / probs.sum(1, keepdims=True)
        u = rng.random(n_samples)[:, None]
        s_t = (probs.cumsum(1) < u).sum(1).clip(0, n_states - 1)
        states.append(s_t)
    states.append(np.full(n_samples, end_state, dtype=int))
    return np.stack(states, axis=1)


def get_tp_likelihood(tp, trans):
    """Stepwise bridge likelihoods of given paths under a transition matrix."""
    N = tp.shape[1]
    n_samples = tp.shape[0]
    s_N = tp[0, -1]
    powers = [np.linalg.matrix_power(trans, k) for k in range(N + 1)]
    out = []
    for i in range(N - 1):
        t = i + 1
        s_t = tp[:, i]
        numerator = powers[N - t - 1][:, s_N] * trans[s_t, :]
        denom = powers[N - t][s_t, s_N][:, None]
        probs = numerator / np.maximum(denom, 1e-300)
        out.append(probs[np.arange(n_samples), tp[:, i + 1]])
    probs = np.stack(out, axis=1)
    probs[np.isnan(probs)] = 0
    return probs


def get_state_probs(tp, num_states: int = 10):
    stationary = np.bincount(tp.reshape(-1), minlength=num_states)
    return stationary / stationary.sum()


# ---------------------------------------------------------------------------
# Reference TPS metric contract (reference `scripts/analyze_peptide_tps.py`)
# ---------------------------------------------------------------------------


def map_to_active(tp, cmsm):
    """Map metastable labels -> cMSM active-set indices, with labels outside
    the active set falling back to the highest-stationary-probability state
    — including the reference's quirk that the fallback is that state's
    LABEL, not its active index (identical when the active set is the full
    label range, which holds for every published run)
    (reference `scripts/analyze_peptide_tps.py:69-70,77`)."""
    highest_prob_state = int(np.asarray(cmsm.active_set)[int(np.argmax(cmsm.pi))])
    label_to_active = {int(v): i for i, v in enumerate(np.asarray(cmsm.active_set))}
    flat = np.asarray(
        [label_to_active.get(int(s), highest_prob_state)
         for s in np.asarray(tp).reshape(-1)],
        dtype=int,
    )
    return flat.reshape(np.shape(tp))


def reference_tps_metrics(
    gen_paths,
    cmsm,
    start_state: int,
    end_state: int,
    n_bridge_samples: int = 1000,
    subsample: int = 10,
    rng=None,
):
    """The reference's generated-path TPS metrics, definition-identical
    (reference `scripts/analyze_peptide_tps.py:63-83`):

      * paths are subsampled ``[:, ::10]`` with the final frame appended
        (11-state paths at T=100)
      * labels are mapped through the cMSM active set (highest-pi fallback)
      * stepwise bridge likelihoods are taken under ``cmsm.transition_matrix``
        (the ACTIVE-set matrix, not an identity-padded full matrix)
      * gen_prob  = mean over paths of the product of stepwise likelihoods
        gen_valid_prob = that mean over paths with prob > 0 (nan if none)
        gen_valid_rate = fraction of paths with prob > 0
        gen_JSD = Jensen-Shannon distance of visited-state histograms vs
        1000 exact bridge samples from the cMSM

    ``gen_paths``: [S, T] metastable labels of the full generated paths.
    Returns (metrics dict, ref_stateprobs, gen_tp).
    """
    gen_paths = np.asarray(gen_paths)
    gen_tp = np.concatenate(
        [gen_paths[:, ::subsample], gen_paths[:, -1:]], axis=1
    )
    traj_len = gen_tp.shape[1]

    # reference bridges: the reference passes the metastable LABELS straight
    # into the active-set matrix (`analyze_peptide_tps.py:63-65`) — identical
    # to sampling in active-index space and mapping back to labels whenever
    # the active set is the full label range (every published run); for a
    # partial active set the reference would crash, so the index-space form
    # is the well-defined extension
    active = np.asarray(cmsm.active_set)
    label_to_active = {int(v): i for i, v in enumerate(active)}
    ref_tp_idx = sample_tp(
        cmsm.transition_matrix,
        label_to_active[int(start_state)],
        label_to_active[int(end_state)],
        traj_len,
        n_bridge_samples,
        rng=rng,
    )
    ref_tp = active[ref_tp_idx]
    ref_stateprobs = get_state_probs(ref_tp)
    gen_stateprobs = get_state_probs(gen_tp)

    probs = get_tp_likelihood(map_to_active(gen_tp, cmsm), cmsm.transition_matrix)
    gen_prob = probs.prod(-1)
    with np.errstate(invalid="ignore"):
        valid_prob = (
            float(gen_prob[gen_prob > 0].mean())
            if (gen_prob > 0).any() else float("nan")
        )
    from .metrics import jensen_shannon

    out = {
        "gen_prob": float(gen_prob.mean()),
        "gen_valid_prob": valid_prob,
        "gen_valid_rate": float((gen_prob > 0).mean()),
        "gen_JSD": jensen_shannon(ref_stateprobs, gen_stateprobs),
    }
    return out, ref_stateprobs, gen_tp


def reference_replica_metrics(
    rep_discrete,
    cmsm,
    start_state: int,
    end_state: int,
    ref_stateprobs,
    rep_lens,
    rep_names,
    msm_lag: int = 1000,
    traj_len: int = 11,
    n_samples: int = 1000,
    rng=None,
):
    """Replica-MD baselines: how much plain MD at 2-100ns buys, scored with
    the same bridge metrics (reference `scripts/analyze_peptide_tps.py:86-131`).

    ``rep_discrete``: metastable labels of the full replica trajectory
    (discretized with the REFERENCE tica/kmeans/msm). For each truncated
    length an MSM is re-estimated and 1000 bridges are sampled from it, then
    scored under the reference cMSM. Absent start/end states give the
    reference's sentinel values (prob 0, JSD 1, cheat-variant nan).
    """
    from .metrics import jensen_shannon

    rep_discrete = np.asarray(rep_discrete)
    out = {}
    stateprobs_list = []
    for ln, nm in zip(rep_lens, rep_names):
        rep_small = rep_discrete[:ln]
        try:
            rep_msm = estimate_markov_model(rep_small, lag=msm_lag)
        except Exception:
            rep_msm = None
        active = (
            [] if rep_msm is None else [int(s) for s in rep_msm.active_set]
        )
        if start_state not in active or end_state not in active:
            out[f"{nm}_rep_prob"] = 0
            out[f"{nm}_rep_valid_prob"] = 0
            out[f"{nm}_rep_valid_rate"] = 0
            out[f"{nm}_rep_JSD"] = 1
            for k in ("prob", "valid_prob", "valid_rate", "JSD"):
                out[f"{nm}_repcheat_{k}"] = float("nan")
            stateprobs_list.append(np.zeros(10))
            continue

        idx_to_repidx = {int(v): i for i, v in enumerate(rep_msm.active_set)}
        repidx_to_idx = {i: int(v) for i, v in enumerate(rep_msm.active_set)}
        repidx_tp = sample_tp(
            rep_msm.transition_matrix,
            idx_to_repidx[start_state],
            idx_to_repidx[end_state],
            traj_len,
            n_samples,
            rng=rng,
        )
        rep_tp = np.vectorize(repidx_to_idx.get)(repidx_tp)
        assert rep_tp[0, 0] == start_state and rep_tp[0, -1] == end_state
        rep_probs = get_tp_likelihood(
            map_to_active(rep_tp, cmsm), cmsm.transition_matrix
        )
        rep_prob = rep_probs.prod(-1)
        rep_stateprobs = get_state_probs(rep_tp)
        stateprobs_list.append(rep_stateprobs)
        with np.errstate(invalid="ignore"):
            valid_prob = (
                float(rep_prob[rep_prob > 0].mean())
                if (rep_prob > 0).any() else float("nan")
            )
        vals = {
            "prob": float(rep_prob.mean()),
            "valid_prob": valid_prob,
            "valid_rate": float((rep_prob > 0).mean()),
            "JSD": jensen_shannon(ref_stateprobs, rep_stateprobs),
        }
        for k, v in vals.items():
            out[f"{nm}_rep_{k}"] = v
            out[f"{nm}_repcheat_{k}"] = v
    return out, stateprobs_list
