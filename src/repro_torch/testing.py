"""Seeded inputs for holding the port against its plain versions and
against the reference package: one copy, used by ``tests/test_torch_*.py``
and by ``chip_smoke.py``.

* :func:`skewed_coo` / :func:`skewed_operator`: a stacked skewed K (one
  full row, one full column), the skewed shapes of the reference's kernel
  tests;
* :func:`step_operands` / :func:`step_tensors`: the vectors of one PDHG
  half-step pair, numpy f32 or tensors on a device;
* :func:`session_workloads` / :func:`session_instances`: a three-step Gavel
  session (cold, a +-3% throughput drift, then job churn under stable ids).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def skewed_coo(k: int, M: int, N: int, density: float, sparse: bool,
               seed: int = 0):
    """Per-lane ``(rows, cols, vals)`` of a stacked skewed K [k, M, N]:
    random entries at ``density`` plus one full row and one full column.
    Dense packing stores every entry, zeros included, so every segment is
    as wide as K and no bucket is wide; ``sparse`` stores only the
    nonzeros, which sends the full row and column to the wide buckets."""
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(k, M, N)) * (rng.random((k, M, N)) < density)
    G[:, M // 2, :] = rng.normal(size=(k, N))
    G[:, :, N // 3] = rng.normal(size=(k, M))
    coo = []
    for g in G:
        r, c = np.nonzero(g) if sparse else np.indices(g.shape).reshape(2, -1)
        coo.append((r, c, g[r, c]))
    return coo


def skewed_operator(k: int, M: int, N: int, density: float, sparse: bool,
                    seed: int = 0):
    """The port's stacked :class:`StructuredOperator` (CPU) of
    :func:`skewed_coo`."""
    from .core import pdhg
    lanes = [pdhg.OperatorLP(
        c=torch.zeros(N), q=torch.zeros(M), l=torch.zeros(N),
        u=torch.zeros(N), ineq_mask=torch.ones(M, dtype=torch.bool), data=(),
        structured=pdhg.structured_from_coo(r, c, v, M, N))
        for r, c, v in skewed_coo(k, M, N, density, sparse, seed)]
    return pdhg.stack_ops(lanes).structured


def step_operands(k: int, M: int, N: int, seed: int = 1) -> dict:
    """The operands of one forward and one backward half-step on a [k, M, N]
    stack, numpy f32 (``mask`` bool): iterates, costs and bounds with
    ``l < u``, step sizes in [0.01, 0.2]."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)
    x, c, kty = f(k, N), f(k, N), f(k, N)
    l = f(k, N) - 2.0
    u = l + rng.uniform(0.5, 3.0, (k, N)).astype(np.float32)
    tau = rng.uniform(0.01, 0.2, k).astype(np.float32)
    y, q, kxn, kxp = f(k, M), f(k, M), f(k, M), f(k, M)
    sigma = rng.uniform(0.01, 0.2, k).astype(np.float32)
    mask = rng.random((k, M)) < 0.6
    return dict(x=x, c=c, l=l, u=u, tau=tau, kty=kty, y=y, q=q, sigma=sigma,
                mask=mask, kxn=kxn, kxp=kxp)


def step_tensors(s, device, seed: int = 1) -> dict:
    """:func:`step_operands` for the stacked operator ``s``, as tensors on
    ``device``."""
    k, _, M = s.row_idx.shape
    return {name: torch.as_tensor(v, device=device) for name, v in
            step_operands(k, M, s.col_idx.shape[-1], seed).items()}


def session_workloads(n_jobs: int, num_workers, churn: float,
                      make_workload=None):
    """``[(workload, job_ids)]`` for three steps of one Gavel session: cold,
    a +-3% throughput drift on the same jobs, then ``churn`` of the jobs
    replaced by fresh ones under new ids (the rest keep theirs).

    ``make_workload`` defaults to the port's ``make_cluster_workload``; the
    parity tests pass the reference's, which draws the same arrays."""
    if make_workload is None:
        from .problems.cluster_scheduling import make_cluster_workload
        make_workload = make_cluster_workload
    wl = make_workload(n_jobs, num_workers=num_workers, seed=0)
    ids = np.arange(n_jobs)
    rng = np.random.default_rng(1)
    wl2 = dataclasses.replace(wl, T=wl.T * rng.uniform(0.97, 1.03,
                                                      wl.T.shape))
    n_out = max(1, int(round(churn * n_jobs)))
    fresh = make_workload(n_out, num_workers=num_workers, seed=2)
    keep = np.arange(n_out, n_jobs)

    def cat(a, b):
        return np.concatenate([a[keep], b])

    wl3 = dataclasses.replace(
        wl2, T=cat(wl2.T, fresh.T), w=cat(wl2.w, fresh.w),
        z=cat(wl2.z, fresh.z),
        interference=cat(wl2.interference, fresh.interference),
        job_type=cat(wl2.job_type, fresh.job_type))
    ids3 = np.concatenate([ids[keep], n_jobs + np.arange(n_out)])
    return [(wl, ids), (wl2, ids), (wl3, ids3)]


def session_instances(n_jobs: int, num_workers, churn: float):
    """:func:`session_workloads` as the port's ``GavelInstance`` list."""
    from .domains import GavelInstance
    return [GavelInstance(wl, job_ids=ids)
            for wl, ids in session_workloads(n_jobs, num_workers, churn)]
