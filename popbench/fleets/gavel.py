"""Gavel jobs on three accelerator generations (a frozen copy of the
archetype draw of ``make_cluster_workload``, taking a numpy Generator).

A fleet is a dict of numpy arrays: ``T`` [n, 3] raw throughputs, ``w``
priorities, ``z`` workers requested, ``interference``, ``job_type``,
``ids`` (stable job ids) and ``num_workers`` [3]."""

from __future__ import annotations

import numpy as np

# relative throughput on [v100, p100, k80]
ARCHETYPES = np.array([
    [1.00, 0.45, 0.25],   # attention-heavy
    [1.00, 0.60, 0.35],   # conv-heavy
    [1.00, 0.80, 0.60],   # small model / input-bound
    [1.00, 0.35, 0.10],   # tensor-core-dependent
])


def jobs(n: int, rng: np.random.Generator) -> dict:
    """``n`` fresh jobs, in the order of the archetype draw."""
    jt = rng.integers(0, len(ARCHETYPES), n)
    base = rng.lognormal(0.0, 0.5, n)[:, None]
    T = ARCHETYPES[jt] * base * rng.uniform(0.9, 1.1, (n, 3))
    w = rng.choice([1.0, 2.0, 4.0], n, p=[0.7, 0.2, 0.1])
    return dict(T=T, w=w, z=np.ones(n),
                interference=rng.uniform(0.55, 0.95, n), job_type=jt)


def initial(config: dict, rng: np.random.Generator) -> dict:
    n = int(config["n_jobs"])
    fleet = jobs(n, rng)
    fleet["ids"] = np.arange(n)
    fleet["num_workers"] = np.asarray(config["num_workers"], np.float64)
    return fleet


def drift(fleet: dict, config: dict, rng: np.random.Generator) -> dict:
    """Every throughput x U(drift): Gavel's re-profiling between rounds."""
    lo, hi = config["drift"]
    return dict(fleet, T=fleet["T"] * rng.uniform(lo, hi, fleet["T"].shape))


def churn(fleet: dict, config: dict, share: float,
          rng: np.random.Generator, next_id: int) -> dict:
    """``share`` of the jobs leave, as many arrive under new ids from
    ``next_id`` on (appended after the survivors)."""
    n = fleet["ids"].shape[0]
    n_out = max(1, int(round(share * n)))
    keep = np.sort(rng.choice(n, n - n_out, replace=False))
    fresh = jobs(n_out, rng)
    out = {key: np.concatenate([fleet[key][keep], fresh[key]])
           for key in fresh}
    out["ids"] = np.concatenate([fleet["ids"][keep],
                                 next_id + np.arange(n_out)])
    out["num_workers"] = fleet["num_workers"]
    return out
