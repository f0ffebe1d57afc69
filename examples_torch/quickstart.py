"""POP quickstart on the PyTorch port — the one public API, the twin of
``examples/quickstart.py``.

Split a traffic-engineering LP with a PopService session, solve the parts
in one batched PDHG call, coalesce — and compare against the full solve +
CSPF.  Then the same session warm-starts a drifted re-solve, and the same
service places MoE experts: one door for every scenario.

    PYTHONPATH=src python examples_torch/quickstart.py [--fast]
        [--device cpu]

Runs on the CUDA device unless ``--device`` names another (with no card
the default refuses).  Each line names what ran (backend and engine); on
the card the full-LP line also gives the device memory the full solve
peaked at (``torch.cuda.max_memory_allocated``).
"""

import argparse

import torch

from repro_torch.core import ExecConfig, SolveConfig, pop, skewed_partition
from repro_torch.domains import make_placement_instance
from repro_torch.problems.traffic_engineering import (
    TrafficProblem, cspf_heuristic, k_shortest_paths, make_demands,
    make_topology)
from repro_torch.service import PopService


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true",
                    help="tiny sizes (smoke-test mode)")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device (refused without one)")
    args = ap.parse_args(argv)
    n_nodes, n_edges, n_dem = (60, 140, 600) if args.fast else (120, 280, 4_000)
    iters = 2_000 if args.fast else 8_000

    # the service: one long-lived object; a session per tenant/problem.
    # Made first, so a missing card is refused before any work.
    service = PopService(device=args.device)
    device = service.device

    print("== POP quickstart: WAN traffic engineering ==")
    topo = make_topology(n_nodes=n_nodes, target_edges=n_edges, seed=0)
    pairs, demand = make_demands(topo, n_dem, seed=1)
    paths = k_shortest_paths(topo, pairs, n_paths=4, max_len=32, seed=2)
    prob = TrafficProblem(topo, pairs, demand, paths)

    exec_cfg = ExecConfig(solver_kw=dict(max_iters=iters, tol_primal=1e-4,
                                         tol_gap=1e-4))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    fr = pop.solve_full_ex(prob, exec_cfg=exec_cfg, device=device)
    full, t_full = fr.alloc, fr.solve_time_s
    ev_full = prob.evaluate(full)
    peak = (f"  peak={torch.cuda.max_memory_allocated(device) / 1e9:.3f}GB"
            if device.type == "cuda" else "")
    print(f"full LP     : flow={ev_full['total_flow']:8.1f}  "
          f"t={t_full:6.2f}s  max_util={ev_full['max_edge_util']:.3f}  "
          f"(ran backend={fr.backend} engine={fr.engine}, "
          f"{int(fr.res.iterations)} iterations){peak}")

    for k in (4, 16):
        sess = service.session(f"net-k{k}", prob,
                               solve=SolveConfig(k=k, strategy="random"),
                               exec=exec_cfg)
        r = sess.step(prob)
        ev = r.metrics
        print(f"POP-{k:<2d}      : flow={ev['total_flow']:8.1f}  "
              f"t={r.solve_time_s:6.2f}s  "
              f"({ev['total_flow']/ev_full['total_flow']:6.1%} of optimal, "
              f"{t_full/max(r.solve_time_s, 1e-9):4.1f}x faster; "
              f"ran backend={r.backend} engine={r.engine})")

    # online: demands drift, the SAME session re-solves warm — no result
    # hand-carrying, the session owns the plan and the iterates
    sess = service.session("net-k4")
    drifted = TrafficProblem(topo, pairs, demand * 1.05, paths)
    r = sess.step(drifted)
    print(f"warm re-tick: flow={r.metrics['total_flow']:8.1f}  "
          f"t={r.solve_time_s:6.2f}s  plan_cache={r.plan_cache} "
          f"warm_fraction={r.warm_fraction:.2f}")

    f = cspf_heuristic(prob)
    ev = prob.evaluate(f)
    print(f"CSPF        : flow={ev['total_flow']:8.1f}  "
          f"({ev['total_flow']/ev_full['total_flow']:6.1%} of optimal)")

    # the paper's Fig. 6 failure mode, in three lines (documented
    # internals: the staged pipeline under the service):
    idx = skewed_partition(prob.source_groups(), 16)
    r = pop.solve_instance(prob, SolveConfig(k=16), exec_cfg,
                           partition_idx=idx, device=device)
    ev = prob.evaluate(r.alloc)
    print(f"POP-16 skew : flow={ev['total_flow']:8.1f}  "
          f"({ev['total_flow']/ev_full['total_flow']:6.1%} of optimal) "
          f"<- why splits must be distributionally similar")

    # same service, different scenario: MoE expert placement through the
    # domain registry (experts -> devices, gate load under compute caps)
    inst = make_placement_instance(64, 8, seed=0)
    r = service.session("moe-fleet", inst).step(inst)
    print(f"MoE place   : served={r.metrics['served_fraction']:.1%} of gate "
          f"load, moved {r.metrics['n_moved']} experts "
          f"(k={r.k}, plan_cache={r.plan_cache})")
    service.close()


if __name__ == "__main__":
    main()
