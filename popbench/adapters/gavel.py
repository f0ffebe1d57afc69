"""A Gavel round through ``repro_torch.service.PopService``."""

from __future__ import annotations

import numpy as np


def instance(config: dict, fleet: dict):
    from repro_torch.domains import GavelInstance
    from repro_torch.problems.cluster_scheduling import ClusterWorkload
    wl = ClusterWorkload(T=fleet["T"], w=fleet["w"], z=fleet["z"],
                         num_workers=fleet["num_workers"],
                         interference=fleet["interference"],
                         job_type=fleet["job_type"])
    return GavelInstance(wl, space_sharing=bool(config["space_sharing"]),
                         job_ids=fleet["ids"])


def configs(config: dict):
    from repro_torch.core.config import ExecConfig, SolveConfig
    s = config["solver"]
    return (SolveConfig(k=s["k"], strategy=s["strategy"],
                        min_per_sub=s["min_per_sub"]),
            ExecConfig(solver_kw=dict(
                max_iters=s["max_iters"], tol_primal=s["tol_primal"],
                tol_gap=s["tol_gap"], equilibrate=s["equilibrate"])))


def record(alloc, solves: list) -> dict:
    """What the reference judges: the answer, its metrics, the plan's
    split and every lane's iterates and objective."""
    res = alloc.raw
    out = dict(status=alloc.status, plan_cache=alloc.plan_cache,
               alloc=np.asarray(alloc.alloc), metrics=dict(alloc.metrics))
    if res is None or getattr(res, "x", None) is None:
        return out
    out.update(split=np.asarray(res.plan.idx), x=np.asarray(res.x),
               y=np.asarray(res.y),
               primal_obj=np.asarray(res.sub_objectives),
               lane_iters=np.asarray(res.iterations),
               converged=np.asarray(res.converged))
    return out
