#!/usr/bin/env python3
"""The unpartitioned traffic-engineering LP, reference against port, on the
CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/te_full_reference.py \
        [--n-demands 20000] [--fixed-iters 300] [--max-iters 8000] [--skip-port-full]

Draws the instance ``chip_smoke.py``'s ``[full]`` phase solves (the
KDL-like topology of 754 nodes and 1,790 undirected edges, topology seed 0,
demands seed 1, paths seed 2, 4 paths of at most 48 edges) and solves its
full LP with the ``traffic`` domain's exec defaults (tolerances 1e-4, at
most ``--max-iters`` iterations, 8,000 by default) through the JAX
reference's ``pop.solve_full_ex`` and through the port's on the CPU.
Prints for each the engine, the iterations, whether it converged, and
``total_flow``, ``max_edge_util`` and ``overflow``; then both packages at a
fixed budget of ``--fixed-iters`` iterations (tolerance 0) and the largest
difference of their ``x`` and ``y``.  This tells a property of the
algorithm at this size (the reference behaves the same) from a fault of
the port.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro.core import pop as rpop
from repro.core.config import ExecConfig as RefExecConfig
from repro.problems import traffic_engineering as rte
from repro_torch import testing
from repro_torch.core import pop as tpop
from repro_torch.core.config import ExecConfig
from repro_torch.problems import traffic_engineering as tte


def report(name, fr, prob, secs):
    m = prob.evaluate(np.asarray(fr.alloc))
    print(f"{name:10s} engine {fr.engine}, {int(fr.res.iterations)} "
          f"iterations, converged {bool(fr.res.converged)}, total_flow "
          f"{m['total_flow']!r}, max_edge_util {m['max_edge_util']!r}, "
          f"overflow {m['overflow']!r} ({secs:.1f} s on the CPU)",
          flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-demands", type=int, default=20_000)
    ap.add_argument("--max-iters", type=int, default=8_000)
    ap.add_argument("--fixed-iters", type=int, default=300)
    ap.add_argument("--skip-port-full", action="store_true",
                    help="solve only the reference's full LP to tolerance")
    args = ap.parse_args()
    arrays = testing.traffic_arrays(args.n_demands, make=rte)
    ref_prob = rte.TrafficProblem(*arrays)
    port_prob = tte.TrafficProblem(*arrays)
    kw = dict(max_iters=args.max_iters, tol_primal=1e-4, tol_gap=1e-4)

    t0 = time.perf_counter()
    fr = rpop.solve_full_ex(ref_prob, exec_cfg=RefExecConfig(solver_kw=kw))
    report("reference", fr, ref_prob, time.perf_counter() - t0)
    if not args.skip_port_full:
        t0 = time.perf_counter()
        fr = tpop.solve_full_ex(port_prob, exec_cfg=ExecConfig(solver_kw=kw),
                                device="cpu")
        report("port", fr, port_prob, time.perf_counter() - t0)

    fixed = dict(max_iters=args.fixed_iters, tol_primal=0.0, tol_gap=0.0)
    ref = rpop.solve_full_ex(ref_prob,
                             exec_cfg=RefExecConfig(solver_kw=fixed))
    port = tpop.solve_full_ex(port_prob, exec_cfg=ExecConfig(solver_kw=fixed),
                              device="cpu")
    dx = float(np.abs(np.asarray(ref.res.x) - np.asarray(port.res.x)).max())
    dy = float(np.abs(np.asarray(ref.res.y) - np.asarray(port.res.y)).max())
    print(f"fixed budget of {args.fixed_iters} iterations: engines "
          f"{ref.engine} / {port.engine}, iterations "
          f"{int(ref.res.iterations)} / {int(port.res.iterations)}, max |dx| "
          f"{dx!r}, max |dy| {dy!r}", flush=True)


if __name__ == "__main__":
    main()
