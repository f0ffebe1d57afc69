"""Gavel cluster scheduling as a registered domain (paper §3.1) — the port
of ``repro/domains/gavel.py``, with the reference's defaults: k=8,
stratified, ``min_per_sub=8``, ``equilibrate=True``, ``max_iters=20_000``,
tolerances 1e-4."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..core.config import ExecConfig, SolveConfig
from ..problems.cluster_scheduling import ClusterWorkload, GavelProblem
from .base import DomainSpec
from .registry import register


@dataclasses.dataclass
class GavelInstance:
    """One scheduling round's input: the fleet as measured right now."""

    wl: ClusterWorkload
    space_sharing: bool = False
    # stable external job ids (None = positional): what warm-start
    # remapping matches on when jobs are submitted/removed between rounds
    job_ids: Optional[np.ndarray] = None

    @property
    def n_jobs(self) -> int:
        return self.wl.T.shape[0]


def _problem(inst: GavelInstance) -> GavelProblem:
    return GavelProblem(inst.wl, space_sharing=inst.space_sharing)


def _evaluate(inst: GavelInstance, rho: np.ndarray) -> dict:
    rho = np.atleast_1d(rho)
    return {
        "mean_norm_throughput": float(rho.mean()),
        "min_norm_throughput": float(rho.min()),
        "p10_norm_throughput": float(np.percentile(rho, 10)),
    }


SPEC = register(DomainSpec(
    name="gavel",
    instance_types=(GavelInstance,),
    describe="max-min fair cluster scheduling (jobs onto accelerator types)",
    problem=_problem,
    entity_ids=lambda inst: inst.job_ids,
    evaluate=_evaluate,
    # the SLO tuner's quality scalar (repro_torch.tuning): the paper's
    # headline objective for this domain
    quality=lambda m: m["mean_norm_throughput"],
    default_solve=SolveConfig(k=8, strategy="stratified", min_per_sub=8),
    default_exec=ExecConfig(solver_kw=dict(
        max_iters=20_000, tol_primal=1e-4, tol_gap=1e-4, equilibrate=True)),
))
