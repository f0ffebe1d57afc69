"""Hot-entity replication (paper §4.3).

Skewed workloads have heavy tails ("Taylor Swift shards"): a single entity
can demand more than one sub-problem's 1/k resource slice, so no
entity-to-sub-problem assignment is self-similar.  The paper's fix:
*replicate* such entities into several sub-problems, splitting their demand
evenly; the reduce step then SUMS the replica sub-allocations.

This module decides which entities to replicate and produces the expanded
entity table + a mapping used by ``reduce.coalesce_replicated``.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ReplicationPlan:
    # expanded entity table: replica r of entity e carries demand[e]/n_rep[e]
    replica_entity: np.ndarray   # [n_expanded] original entity id per replica
    replica_scale: np.ndarray    # [n_expanded] demand scale (1/n_rep)
    n_original: int

    @property
    def n_expanded(self) -> int:
        return self.replica_entity.shape[0]

    def entity_of(self, replica_ids: np.ndarray) -> np.ndarray:
        """Original entity id per replica id, preserving -1 padding — the
        provenance map plans carry so warm-start remapping can follow an
        entity across partition changes."""
        replica_ids = np.asarray(replica_ids)
        return np.where(replica_ids >= 0,
                        self.replica_entity[np.maximum(replica_ids, 0)], -1)


def plan_replication(demands: np.ndarray, k: int,
                     threshold: float = 0.5) -> ReplicationPlan:
    """Replicate entity e into ceil(demand_e / (threshold * slice)) replicas,
    where slice = total_demand / k is one sub-problem's fair share.  Entities
    below the threshold keep a single replica (the common case)."""
    total = float(demands.sum())
    slice_cap = max(total / k, 1e-12)
    n_rep = np.maximum(1, np.ceil(demands / (threshold * slice_cap)).astype(np.int64))
    n_rep = np.minimum(n_rep, k)   # at most one replica per sub-problem
    replica_entity = np.repeat(np.arange(demands.shape[0]), n_rep)
    replica_scale = np.repeat(1.0 / n_rep, n_rep)
    return ReplicationPlan(replica_entity=replica_entity,
                           replica_scale=replica_scale,
                           n_original=demands.shape[0])


def replicated_partition(plan: ReplicationPlan, scores: np.ndarray, k: int,
                         seed: int = 0) -> np.ndarray:
    """Partition the *expanded* replica table so that

      * replicas of one entity land on DISTINCT sub-problems, and
      * bins stay balanced and stratified by ``scores`` (per original entity).

    Strategy: visit entities in stratified order (sort by score, so heavy
    and light entities interleave across bins), placing each entity's r
    replicas on the r currently least-loaded bins.  Returns idx [k, n_per]
    over replica ids, -1 padded."""
    rng = np.random.default_rng(seed)
    n = plan.n_original
    # replica ids grouped per entity
    replicas_of = [[] for _ in range(n)]
    for r, e in enumerate(plan.replica_entity):
        replicas_of[e].append(r)
    # stratified entity order with random tie-break
    order = np.argsort(scores + 1e-9 * rng.standard_normal(n), kind="stable")[::-1]
    bins = [[] for _ in range(k)]
    load = np.zeros(k)
    for e in order:
        reps = replicas_of[e]
        # r least-loaded bins (stable) — guarantees distinctness since r <= k
        target_bins = np.argsort(load, kind="stable")[: len(reps)]
        for r_id, b in zip(reps, target_bins):
            bins[b].append(r_id)
            load[b] += scores[e] * plan.replica_scale[r_id]
    n_per = max(len(b) for b in bins)
    out = np.full((k, n_per), -1, np.int64)
    for i, b in enumerate(bins):
        out[i, : len(b)] = b
    return out
