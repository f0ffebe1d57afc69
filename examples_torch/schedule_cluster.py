"""Fleet scheduling driver on the PyTorch port: a PopService session over
the registered ``gavel`` domain allocating accelerator time to training
jobs drawn from the 10 assigned architectures — the one-door API for the
scheduler (the legacy ``GavelScheduler`` class forwards onto exactly
this).  The twin of ``examples/schedule_cluster.py``.

    PYTHONPATH=src python examples_torch/schedule_cluster.py [--fast]
        [--device cpu]

Runs on the CUDA device unless ``--device`` names another (with no card
the default refuses).
"""

import argparse

import numpy as np

from repro_torch.configs import ARCH_IDS
from repro_torch.core.config import ExecConfig, SolveConfig
from repro_torch.domains import GavelInstance
from repro_torch.problems.cluster_scheduling import ClusterWorkload
from repro_torch.service import PopService


def fleet_workload(throughputs, priorities, workers=(256, 256, 256)):
    T = np.stack(throughputs)
    n = T.shape[0]
    return ClusterWorkload(
        T=T, w=np.asarray(priorities), z=np.ones(n),
        num_workers=np.asarray(workers, np.float64),
        interference=np.full(n, 0.8), job_type=np.zeros(n, np.int64))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true",
                    help="tiny fleet (smoke-test mode)")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device (refused without one)")
    args = ap.parse_args(argv)
    n_jobs = 48 if args.fast else 240
    iters = 2_000 if args.fast else 10_000

    print("== POP-Gavel cluster scheduler (PopService session) ==")
    rng = np.random.default_rng(0)
    names = [f"{ARCH_IDS[i % len(ARCH_IDS)]}-{i:03d}" for i in range(n_jobs)]
    thpt = [np.abs(rng.normal([1.0, 0.6, 0.8], 0.2)) + 0.05
            for _ in range(n_jobs)]
    prio = [float(rng.choice([1.0, 2.0, 4.0], p=[0.7, 0.2, 0.1]))
            for _ in range(n_jobs)]
    eids = np.arange(n_jobs)

    service = PopService(device=args.device)
    session = service.session(
        "training-fleet", domain="gavel",
        solve=SolveConfig(k=8, strategy="stratified", min_per_sub=8),
        exec=ExecConfig(solver_kw=dict(max_iters=iters, tol_primal=1e-4,
                                       tol_gap=1e-4, equilibrate=True)))

    # round 1: cold
    r = session.step(GavelInstance(fleet_workload(thpt, prio), job_ids=eids))
    rho = np.atleast_1d(r.alloc)
    print(f"jobs={n_jobs}  round_time={r.solve_time_s:.2f}s  k={r.k}  "
          f"min_rho={rho.min():.3f}  mean_rho={rho.mean():.3f}  "
          f"(ran backend={r.backend} engine={r.engine})")

    # round 2: a straggling job reports poor measured throughput -> the
    # session re-solves WARM from its own carried state (no result
    # threading by the caller)
    thpt[0] = 0.7 * thpt[0] + 0.3 * np.array([0.2, 0.1, 0.15])
    r2 = session.step(GavelInstance(fleet_workload(thpt, prio),
                                    job_ids=eids))
    rho2 = np.atleast_1d(r2.alloc)
    print(f"after throughput update: min_rho={rho2.min():.3f} "
          f"round_time={r2.solve_time_s:.2f}s plan_cache={r2.plan_cache} "
          f"warm_fraction={r2.warm_fraction:.2f}")

    # round 3: churn — 4 jobs finish, 4 arrive; stable ids keep survivors warm
    keep = np.arange(n_jobs) >= 4
    thpt = [t for t, k in zip(thpt, keep) if k] + [
        np.abs(rng.normal([1.0, 0.6, 0.8], 0.2)) + 0.05 for _ in range(4)]
    prio = [p for p, k in zip(prio, keep) if k] + [1.0] * 4
    eids = np.concatenate([eids[keep], n_jobs + np.arange(4)])
    r3 = session.step(GavelInstance(fleet_workload(thpt, prio),
                                    job_ids=eids))
    print(f"after churn (4 out / 4 in): plan_cache={r3.plan_cache} "
          f"warm_fraction={r3.warm_fraction:.2f}")
    print("sample allocations (job -> time-fraction rho):")
    for i in range(5):
        print(f"  {names[i+4]:28s} rho={float(np.atleast_1d(r3.alloc)[i]):.3f}")
    print(f"service stats: {service.stats()}")
    return names, (r, r2, r3)


if __name__ == "__main__":
    main()
