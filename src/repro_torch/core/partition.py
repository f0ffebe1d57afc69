"""Entity partitioners + distributional-similarity diagnostics (paper §2.3/§4.2).

The paper's central requirement: sub-problems must be *distributionally
similar* to the full problem — the mean and covariance of entity attribute
vectors inside each sub-problem should match the global ones.  Random
assignment achieves this at scale (law of large numbers); stratified
assignment enforces it under skew.  :func:`clustered_partition` and the
adversarial :func:`skewed_partition` (the paper's Fig. 6 split) are called
directly and passed as ``partition_idx=``; :func:`make_partition` does not
name them.

All partitioners return a dense assignment
    idx : int32 [k, n_per]   (entity ids per sub-problem, -1 = padding)
so downstream sub-problem construction is a fixed-shape gather — this is
what lets POP's map step be a single batched (vmap/shard_map) solve.
"""

from __future__ import annotations

import numpy as np


def _to_dense(order: np.ndarray, k: int) -> np.ndarray:
    """Deal `order` round-robin into k bins; pad with -1 to equal length."""
    n = order.shape[0]
    n_per = (n + k - 1) // k
    out = np.full((k, n_per), -1, np.int64)
    for i in range(k):
        chunk = order[i::k]
        out[i, : chunk.shape[0]] = chunk
    return out


def random_partition(n: int, k: int, seed: int = 0) -> np.ndarray:
    """Uniform random balanced split — the paper's default (LLN-similar)."""
    rng = np.random.default_rng(seed)
    return _to_dense(rng.permutation(n), k)


def stratified_partition(scores: np.ndarray, k: int) -> np.ndarray:
    """Sort by score, deal round-robin — each sub-problem samples every
    stratum evenly (paper §4.2: stratified sampling on per-dim strata)."""
    return _to_dense(np.argsort(scores, kind="stable"), k)


def stratified_partition_multidim(attrs: np.ndarray, k: int,
                                  seed: int = 0) -> np.ndarray:
    """Multi-dimensional stratification: project attributes onto their first
    principal component, then stratify along it.  Used when no single
    dimension dominates (paper §4.2 'inputs with continuous distribution
    across all dimensions')."""
    a = attrs - attrs.mean(axis=0, keepdims=True)
    std = a.std(axis=0); std[std == 0] = 1.0
    a = a / std
    # power iteration for the top PC (cheap, deterministic)
    rng = np.random.default_rng(seed)
    v = rng.normal(size=a.shape[1]); v /= np.linalg.norm(v)
    for _ in range(50):
        v = a.T @ (a @ v)
        v /= np.linalg.norm(v) + 1e-30
    return stratified_partition(a @ v, k)


def clustered_partition(labels: np.ndarray, k: int, seed: int = 0) -> np.ndarray:
    """Deal each cluster/type evenly across sub-problems (paper §4.2:
    'inputs can also be clustered by key properties such as job type')."""
    rng = np.random.default_rng(seed)
    order_parts = []
    for lab in np.unique(labels):
        members = np.flatnonzero(labels == lab)
        order_parts.append(rng.permutation(members))
    order = np.concatenate(order_parts)
    return _to_dense(order, k)


def skewed_partition(group_of: np.ndarray, k: int) -> np.ndarray:
    """Adversarial split for Fig. 6: entities sharing a group (e.g. all
    commodities originating at one node) land in the SAME sub-problem."""
    groups = np.unique(group_of)
    gk = {g: i % k for i, g in enumerate(groups)}
    bins = [[] for _ in range(k)]
    for e, g in enumerate(group_of):
        bins[gk[g]].append(e)
    n_per = max(len(b) for b in bins)
    out = np.full((k, n_per), -1, np.int64)
    for i, b in enumerate(bins):
        out[i, : len(b)] = b
    return out


# --------------------------------------------------------------------------
# diagnostics — "is this split self-similar?" (paper §2.3)
# --------------------------------------------------------------------------

def similarity_report(attrs: np.ndarray, idx: np.ndarray) -> dict:
    """Mean/covariance distance of each sub-problem's attribute distribution
    from the global one, normalised by global scales.  Small values (≲0.1)
    indicate a self-similar split."""
    mu = attrs.mean(axis=0)
    sd = attrs.std(axis=0) + 1e-12
    cov = np.cov(((attrs - mu) / sd).T) if attrs.shape[1] > 1 else np.ones((1, 1))
    mean_d, cov_d = [], []
    for i in range(idx.shape[0]):
        ids = idx[i][idx[i] >= 0]
        if ids.size < 2:
            continue
        sub = attrs[ids]
        mean_d.append(np.linalg.norm((sub.mean(axis=0) - mu) / sd) /
                      np.sqrt(attrs.shape[1]))
        sub_cov = (np.cov(((sub - mu) / sd).T) if attrs.shape[1] > 1
                   else np.ones((1, 1)))
        cov_d.append(np.linalg.norm(sub_cov - cov) /
                     (np.linalg.norm(cov) + 1e-12))
    if not mean_d:
        # every lane holds < 2 entities (tiny or departure-gutted plans):
        # no within-lane statistics exist, report a trivially-similar split
        return {"max_mean_dist": 0.0, "avg_mean_dist": 0.0,
                "max_cov_dist": 0.0, "avg_cov_dist": 0.0}
    return {
        "max_mean_dist": float(np.max(mean_d)),
        "avg_mean_dist": float(np.mean(mean_d)),
        "max_cov_dist": float(np.max(cov_d)),
        "avg_cov_dist": float(np.mean(cov_d)),
    }


# the strategy names make_partition dispatches — what SolveConfig validates
STRATEGIES = ("random", "stratified", "stratified_multidim")


def make_partition(strategy: str, attrs: np.ndarray, scores: np.ndarray,
                   n: int, k: int, seed: int = 0) -> np.ndarray:
    """Strategy-name dispatch for the planning stage (``core/plan.py``).

    The returned idx rows ARE the partition's entity provenance: slot
    ``(i, s)`` holds the original entity id placed there (-1 = padding),
    which is what churn-aware warm-start remapping matches on.
    """
    if strategy == "random":
        return random_partition(n, k, seed)
    if strategy == "stratified":
        return stratified_partition(scores, k)
    if strategy == "stratified_multidim":
        return stratified_partition_multidim(attrs, k, seed)
    raise ValueError(f"unknown strategy {strategy!r}; expected one of "
                     "'random', 'stratified', 'stratified_multidim' "
                     "(or pass an explicit partition_idx)")
