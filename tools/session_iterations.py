#!/usr/bin/env python3
"""Iteration counts of one three-step Gavel session, reference against port.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/session_iterations.py \
        [--n-jobs 1024] [--churn 0.05] [--probe-keys 7 8 9] [--resolves 2]
        [--k 32]

Runs the session of ``chip_smoke.py``'s main path (cold, a +-3% throughput
drift, then ``--churn`` of the jobs replaced under new ids; the ``gavel``
registry defaults: k=8, equilibrate, tolerances 1e-4) at a CPU-sized fleet
(``--n-jobs`` jobs on ``n_jobs / 4`` accelerators of each of three types)
through the JAX reference and through the port on the CPU: with the
reference's equilibration probes handed to the port (drawn from
``jax.random.PRNGKey(key)`` for each of ``--probe-keys``; the reference
itself uses key 7), and with the port's own.  Prints each step's plan-cache
verdict, lane-max and summed PDHG iterations, the iterations of each lane,
converged lanes and ``mean_norm_throughput``: whether the reference itself
takes more iterations on a repaired warm start than cold, and how far the
iteration counts move with the probe draw.  ``--resolves N`` runs the
drifted instance N more times after the hit, each warm from the step
before (what ``chip_smoke.py``'s ``robust`` phase does between its
faults): how many iterations a warm re-solve of an unchanged instance
takes from its own converged iterates.  ``--k`` replaces the registry's
k=8 in both packages (the tuner's plan in the smoke's ``tune`` phase can
pick another k): whether the reference leaves the same lanes at the
iteration cap as the port.
"""

from __future__ import annotations

import argparse
import functools
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))

from repro.core.config import SolveConfig as RefSolveConfig  # noqa: E402
from repro.domains import GavelInstance as RefGavelInstance  # noqa: E402
from repro.problems.cluster_scheduling import (  # noqa: E402
    make_cluster_workload as ref_make_cluster_workload)
from repro.service import PopService as RefPopService  # noqa: E402
from repro_torch import testing  # noqa: E402
from repro_torch.core import pdhg as tpdhg  # noqa: E402
from repro_torch.core.config import SolveConfig  # noqa: E402
from repro_torch.domains import GavelInstance  # noqa: E402
from repro_torch.service import PopService  # noqa: E402
from test_torch_pdhg import reference_probes  # noqa: E402


def run(name, session, make_instance, workloads):
    t0 = time.perf_counter()
    steps = [session.step(make_instance(wl, job_ids=ids))
             for wl, ids in workloads]
    secs = time.perf_counter() - t0
    for a in steps:
        its = np.asarray(a.raw.iterations)
        print(f"{name:20s} {a.plan_cache:7s} lane max {int(its.max()):6d} "
              f"sum {int(its.sum()):7d} lanes {its.tolist()} converged "
              f"{int(np.asarray(a.raw.converged).sum())}/{its.size} "
              f"mean_norm_throughput {a.metrics['mean_norm_throughput']:.6f}")
    print(f"{name:20s} {secs:.1f} s on the CPU", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-jobs", type=int, default=1024)
    ap.add_argument("--churn", type=float, default=0.05)
    ap.add_argument("--probe-keys", type=int, nargs="*", default=[7])
    ap.add_argument("--resolves", type=int, default=0,
                    help="re-solves of the drifted instance after the hit")
    ap.add_argument("--k", type=int, default=None,
                    help="sub-problems (default: the registry's k=8)")
    args = ap.parse_args()
    ref_solve = None if args.k is None else RefSolveConfig(k=args.k)
    solve = None if args.k is None else SolveConfig(k=args.k)
    cold, drift, churn = testing.session_workloads(
        args.n_jobs, (args.n_jobs // 4,) * 3, args.churn,
        make_workload=ref_make_cluster_workload)
    workloads = [cold, drift] + [drift] * args.resolves + [churn]
    run("reference",
        RefPopService().session("t", domain="gavel", solve=ref_solve),
        RefGavelInstance, workloads)
    own_probes = tpdhg.rademacher_probes
    for key in args.probe_keys:
        tpdhg.rademacher_probes = functools.partial(reference_probes,
                                                    seed=key)
        run(f"port, jax key {key}",
            PopService(device="cpu").session("t", domain="gavel",
                                             solve=solve),
            GavelInstance, workloads)
    tpdhg.rademacher_probes = own_probes
    run("port, own probes",
        PopService(device="cpu").session("t", domain="gavel", solve=solve),
        GavelInstance, workloads)


if __name__ == "__main__":
    main()
