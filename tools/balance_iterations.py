#!/usr/bin/env python3
"""Per-lane iterations of one three-step load-balancing session, reference
against port.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/balance_iterations.py \
        [--n-shards 8192] [--n-servers 256] [--churn 0.05]

Runs the session of ``chip_smoke.py``'s ``balance-session`` phase
(``testing.balance_session``: cold, every load x U(0.95, 1.05) on the
previous placement, then ``--churn`` of the shards replaced under fresh
ids; the ``load_balance`` domain's defaults: k=4, tolerances 1e-4, at most
20,000 iterations, eps_frac 0.15) through the JAX reference and through
the port on the CPU.  Prints each step's plan-cache verdict, warm
fraction, each lane's PDHG iterations and converged flag (read from the
map step, wrapped here), ``max_load_dev`` and ``movement``: whether the
reference itself runs a lane to the cap where the port does, and how the
warm steps' iterations differ.  At 8,192 shards on 256 servers it takes
about 90 s for the reference and 50 s for the port.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro.core import backends as ref_backends
from repro.domains.load_balance import BalanceInstance as RefBalanceInstance
from repro.problems.load_balancing import (
    make_shard_workload as ref_make_shard_workload)
from repro.service import PopService as RefPopService
from repro_torch import testing
from repro_torch.core import backends as port_backends
from repro_torch.service import PopService


def run(name, backends, session, args, **kw):
    """The session through ``session``, the map step of ``backends``
    wrapped to keep each solve's per-lane iterations."""
    lanes = []
    solve_map = backends.solve_map

    def recorded(*a, **k):
        res = solve_map(*a, **k)
        lanes.append((np.asarray(res.iterations), np.asarray(res.converged)))
        return res

    backends.solve_map = recorded
    try:
        t0 = time.perf_counter()
        _, steps = testing.balance_session(
            session.step, args.n_shards, args.n_servers, args.churn,
            eps_frac=args.eps_frac, **kw)
        secs = time.perf_counter() - t0
    finally:
        backends.solve_map = solve_map
    for a, (its, conv) in zip(steps, lanes):
        print(f"{name:10s} {a.plan_cache:7s} warm {a.warm_fraction} "
              f"iterations {its.tolist()} converged "
              f"{int(conv.sum())}/{conv.size} max_load_dev "
              f"{a.metrics['max_load_dev']:.6f} movement "
              f"{a.metrics['movement']:g}")
    print(f"{name:10s} {secs:.1f} s on the CPU", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-shards", type=int, default=8_192)
    ap.add_argument("--n-servers", type=int, default=256)
    ap.add_argument("--churn", type=float, default=0.05)
    ap.add_argument("--eps-frac", type=float, default=0.15)
    args = ap.parse_args()
    run("reference", ref_backends,
        RefPopService().session("lb", domain="load_balance"), args,
        make_workload=ref_make_shard_workload, instance=RefBalanceInstance)
    run("port", port_backends,
        PopService(device="cpu").session("lb", domain="load_balance"), args)


if __name__ == "__main__":
    main()
