"""POP reduce step: coalesce sub-problem allocations into a global one.

Because the straightforward POP split assigns disjoint entity subsets and
disjoint resource slices, the reduce step is a *concatenation* (scatter by
entity id).  With hot-entity replication (paper §4.3) an entity owns several
replicas across sub-problems and its final allocation is the SUM of replica
sub-allocations.
"""

from __future__ import annotations

import numpy as np

from .replicate import ReplicationPlan


def coalesce_concat(sub_alloc: np.ndarray, idx: np.ndarray, n: int) -> np.ndarray:
    """Scatter per-sub allocations back to global entity order.

    sub_alloc : [k, n_per, ...] allocation rows per sub-problem slot
    idx       : [k, n_per] entity id per slot (-1 = padding)
    returns   : [n, ...]
    """
    out = np.zeros((n,) + sub_alloc.shape[2:], sub_alloc.dtype)
    valid = idx >= 0
    out[idx[valid]] = sub_alloc[valid]
    return out


def coalesce_replicated(sub_alloc: np.ndarray, idx: np.ndarray,
                        plan: ReplicationPlan) -> np.ndarray:
    """Sum replica allocations into original-entity allocations."""
    out = np.zeros((plan.n_original,) + sub_alloc.shape[2:], sub_alloc.dtype)
    valid = idx >= 0
    replica_ids = idx[valid]
    np.add.at(out, plan.replica_entity[replica_ids], sub_alloc[valid])
    return out
