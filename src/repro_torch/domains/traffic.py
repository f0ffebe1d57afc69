"""WAN traffic engineering as a registered domain (paper §3.2) — the port
of ``repro/domains/traffic.py``, with the reference's defaults: k=8,
stratified, ``max_iters=8_000``, tolerances 1e-4, no equilibration.

The domain instance IS the problem object
(:class:`~repro_torch.problems.traffic_engineering.TrafficProblem`): it
bundles topology, demands and precomputed paths, and rebuilding it per
tick is how demand drift enters.
"""

from __future__ import annotations

from ..core.config import ExecConfig, SolveConfig
from ..problems.traffic_engineering import TrafficProblem
from .base import DomainSpec
from .registry import register

SPEC = register(DomainSpec(
    name="traffic",
    instance_types=(TrafficProblem,),
    describe="max-total-flow WAN TE (commodities onto k-shortest paths)",
    problem=lambda inst: inst,
    # the SLO tuner's quality scalar (repro_torch.tuning)
    quality=lambda m: m["total_flow"],
    default_solve=SolveConfig(k=8, strategy="stratified"),
    default_exec=ExecConfig(solver_kw=dict(
        max_iters=8_000, tol_primal=1e-4, tol_gap=1e-4)),
))
