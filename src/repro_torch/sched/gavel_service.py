"""Cluster scheduler service: POP-accelerated Gavel for the training fleet —
the port of ``repro/sched/gavel_service.py``.

DEPRECATED surface: :class:`GavelScheduler` is a thin forwarder onto the
one public API — a :class:`repro_torch.service.PopService` session over
the registered ``gavel`` domain (``repro_torch.domains.gavel``), on the
scheduler's device (default: the CUDA device).  It keeps the
job-book-keeping conveniences (submit/remove/heartbeats -> stable entity
ids) and produces bit-identical allocations to the pre-session scheduler,
but new code should drive the session directly:

    service = PopService()
    session = service.session("fleet", GavelInstance(wl, job_ids=eids))
    alloc = session.step(GavelInstance(wl, job_ids=eids))   # per round

Flow per scheduling round (unchanged):
    observe() -> jobs + measured throughputs     (from job heartbeats)
    allocate() -> POP-k Gavel solve              (one session.step)
    to_assignments() -> per-job (resource type, time fraction) leases
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Dict, Optional

import numpy as np

from ..core.config import ExecConfig, SolveConfig
from ..domains.gavel import GavelInstance
from ..problems.cluster_scheduling import ClusterWorkload
from ..service import PopService


@dataclasses.dataclass
class JobSpec:
    job_id: str
    arch: str                   # one of repro_torch.configs.ARCH_IDS
    priority: float = 1.0
    n_workers: int = 1
    # measured tokens/sec per accelerator type (filled by heartbeats)
    throughputs: Optional[np.ndarray] = None


@dataclasses.dataclass
class SchedulerConfig:
    resource_types: tuple = ("tpu_v5e", "tpu_v4", "gpu_h100")
    num_workers: tuple = (256, 256, 256)
    pop_k: int = 8
    space_sharing: bool = False
    round_seconds: float = 300.0
    # map-step execution backend (core/backends.py registry)
    map_backend: str = "auto"
    # equilibrate: probe-based operator scaling
    solver_kw: dict = dataclasses.field(default_factory=lambda: dict(
        max_iters=20_000, tol_primal=1e-4, tol_gap=1e-4, equilibrate=True))


class GavelScheduler:
    """DEPRECATED: drive ``PopService.session(...,
    GavelInstance(...))`` directly; this class forwards onto exactly that
    session (same solves, bit-identical allocations) and only adds the
    job-dict plumbing."""

    def __init__(self, cfg: SchedulerConfig, *, device=None):
        warnings.warn(
            "GavelScheduler is deprecated: use repro_torch.service.PopService"
            ".session(tenant, repro_torch.domains.GavelInstance(...)) — this "
            "class forwards onto that session (results are identical)",
            DeprecationWarning, stacklevel=2)
        self.cfg = cfg
        self.jobs: Dict[str, JobSpec] = {}
        self.last_alloc: Optional[np.ndarray] = None
        self.last_round_time: float = 0.0
        # the one public API: a per-fleet session.  Warm-start state (plan
        # reuse, churn repair, id-matched warm remaps) lives INSIDE it —
        # successive rounds see EMA-drifted throughputs and job churn, and
        # the session chains warm state through both.
        self._session = PopService(device=device).session(
            "gavel-fleet", domain="gavel",
            solve=SolveConfig(k=cfg.pop_k, strategy="stratified",
                              min_per_sub=8),
            exec=ExecConfig(backend=cfg.map_backend,
                            solver_kw=dict(cfg.solver_kw)))
        self._eids: Dict[str, int] = {}
        self._next_eid: int = 0
        self.last_warm_fraction: Optional[float] = None

    # ------------------------------------------------------------- job API --
    def submit(self, job: JobSpec):
        if job.throughputs is None:
            # cold-start prior: arch-family default speedup profile
            job.throughputs = np.array([1.0, 0.6, 0.8]) * (
                0.5 + abs(hash(job.arch)) % 1000 / 1000.0)
        if job.job_id not in self._eids:
            self._eids[job.job_id] = self._next_eid
            self._next_eid += 1
        self.jobs[job.job_id] = job

    def remove(self, job_id: str):
        self.jobs.pop(job_id, None)
        self._eids.pop(job_id, None)

    def report_throughput(self, job_id: str, measured: np.ndarray):
        """Heartbeat path: refine T with live measurements (EMA)."""
        j = self.jobs[job_id]
        j.throughputs = 0.7 * j.throughputs + 0.3 * measured

    # ---------------------------------------------------------- scheduling --
    def _workload(self) -> ClusterWorkload:
        jobs = list(self.jobs.values())
        T = np.stack([j.throughputs for j in jobs])
        return ClusterWorkload(
            T=T,
            w=np.array([j.priority for j in jobs]),
            z=np.array([float(j.n_workers) for j in jobs]),
            num_workers=np.asarray(self.cfg.num_workers, np.float64),
            interference=np.full(len(jobs), 0.8),
            job_type=np.zeros(len(jobs), np.int64),
        )

    def allocate(self) -> Dict[str, np.ndarray]:
        """One scheduling round = one ``session.step``: the session reuses
        or repairs its plan, matches surviving jobs by their stable id and
        continues from their previous iterates (new arrivals start from
        population priors, ``core/plan.py``); only a POP <-> full-problem
        mode flip drops the warm state.  ``warm_fraction`` (matched share,
        via :meth:`fairness_report`) is logged per round."""
        if not self.jobs:
            return {}
        t0 = time.perf_counter()
        eids = np.array([self._eids[j] for j in self.jobs], np.int64)
        inst = GavelInstance(self._workload(),
                             space_sharing=self.cfg.space_sharing,
                             job_ids=eids)
        result = self._session.step(inst)
        rho = result.alloc
        self.last_warm_fraction = result.warm_fraction
        self.last_round_time = time.perf_counter() - t0
        self.last_alloc = rho
        return {j.job_id: rho[i] for i, j in enumerate(self.jobs.values())}

    def fairness_report(self) -> dict:
        if self.last_alloc is None:
            return {}
        rho = np.atleast_1d(self.last_alloc)
        return {
            "min_norm_throughput": float(rho.min()),
            "mean_norm_throughput": float(rho.mean()),
            "round_time_s": self.last_round_time,
            "n_jobs": len(self.jobs),
            "warm_fraction": self.last_warm_fraction,
        }
