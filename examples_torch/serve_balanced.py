"""End-to-end serving driver on the PyTorch port: batched decode of a small
LM across several replica groups, with a PopService session (the registered
``load_balance`` domain) placing request shards onto replicas — the paper's
technique running in the serving path, through the one public API.  The
twin of ``examples/serve_balanced.py``.

    PYTHONPATH=src python examples_torch/serve_balanced.py [--fast]
        [--device cpu]

Runs on the CUDA device unless ``--device`` names another (with no card
the default refuses).
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_reduced
from repro_torch.core.config import ExecConfig, SolveConfig
from repro_torch.core.problem import resolve_device
from repro_torch.domains import BalanceInstance
from repro_torch.models import init_cache, init_params
from repro_torch.serve.engine import ServeConfig, make_serve_step
from repro_torch.service import PopService


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true",
                    help="fewer groups + decode steps (smoke-test mode)")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device (refused without one)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    n_groups = 24 if args.fast else 64
    decode_cap = 4 if args.fast else 16

    print("== POP-balanced batched serving ==")
    cfg = get_reduced("xlstm_350m")
    params = init_params(torch.Generator(device).manual_seed(0), cfg)
    n_replicas = 4
    rng = np.random.default_rng(0)

    # request groups with heavy-tailed load (tokens to generate).  Stable
    # session ids per group let the balancer session's warm state survive
    # group churn (sessions finishing, sessions arriving).
    load = np.minimum(rng.zipf(1.9, n_groups), 60).astype(np.float64)
    current = rng.integers(0, n_replicas, n_groups)   # sticky sessions
    group_ids = np.arange(n_groups)
    next_id = n_groups

    # the balancer is a long-lived session: request groups = shards,
    # replicas = servers; warm state lives INSIDE it
    service = PopService(device=device)
    balancer = service.session(
        "decode-balancer", domain="load_balance",
        solve=SolveConfig(k=2),
        exec=ExecConfig(solver_kw=dict(max_iters=6_000)))

    res = balancer.step(BalanceInstance(load=load, n_targets=n_replicas,
                                        current=current, eps_frac=0.25,
                                        ids=group_ids))
    print(f"balancer: {n_groups} request groups -> {n_replicas} replicas "
          f"in {res.solve_time_s:.2f}s; moved "
          f"{int((res.alloc != current).sum())} sticky groups; "
          f"max load dev {res.metrics['max_load_dev']:.2f} "
          f"(ran backend={res.backend} engine={res.engine})")

    # tick 2: loads drift a few percent -> warm-started re-solve picks
    # up from the previous PDHG iterates instead of cold
    load2 = load * rng.uniform(0.95, 1.05, n_groups)
    res2 = balancer.step(BalanceInstance(load=load2, n_targets=n_replicas,
                                         current=res.alloc, eps_frac=0.25,
                                         ids=group_ids))
    print(f"warm tick: re-balanced in {res2.solve_time_s:.2f}s; moved "
          f"{int((res2.alloc != res.alloc).sum())} groups; "
          f"plan_cache {res2.plan_cache}; "
          f"warm_fraction {res2.warm_fraction:.2f}")

    # tick 3: CHURN — sessions finish, new ones arrive.  The warm state
    # still chains: surviving groups are matched by id and their iterates
    # remapped onto the new tick's sub-problems.
    n_churn = max(2, n_groups // 8)
    done = rng.choice(n_groups, n_churn, replace=False)
    keep = np.setdiff1d(np.arange(n_groups), done)
    arrivals = np.minimum(rng.zipf(1.9, n_churn), 60).astype(np.float64)
    load3 = np.concatenate([load2[keep], arrivals])
    cur3 = np.concatenate([res2.alloc[keep],
                           rng.integers(0, n_replicas, n_churn)])
    group_ids = np.concatenate([group_ids[keep],
                                next_id + np.arange(n_churn)])
    next_id += n_churn
    res3 = balancer.step(BalanceInstance(load=load3, n_targets=n_replicas,
                                         current=cur3, eps_frac=0.25,
                                         ids=group_ids))
    print(f"churn tick: {n_churn} done / {n_churn} arrived; re-balanced in "
          f"{res3.solve_time_s:.2f}s; plan_cache {res3.plan_cache}; "
          f"warm_fraction {res3.warm_fraction:.2f} "
          f"(survivors warm, arrivals start from priors)")
    placement, load = res3.alloc, load3

    # serve: each replica decodes its assigned groups as one batch
    scfg = ServeConfig(batch=1, max_seq=128)
    step = make_serve_step(cfg, scfg)
    total_tokens = 0
    decoded = {}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for r in range(n_replicas):
        groups = np.flatnonzero(placement == r)
        if groups.size == 0:
            continue
        B = int(groups.size)
        cache = init_cache(cfg, B, 128, device=device)
        tok = torch.zeros((B, 1), dtype=torch.int64, device=device)
        steps = int(load[groups].max())
        out = []
        for _ in range(min(steps, decode_cap)):
            tok, cache = step(params, cache, tok)
            out.append(tok)
            total_tokens += B
        decoded[r] = torch.cat(out, dim=1).cpu()
        print(f"  replica {r}: batch={B:3d} groups, "
              f"load={load[groups].sum():6.0f}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    print(f"decoded {total_tokens} tokens in {dt:.2f}s "
          f"({total_tokens/dt:.0f} tok/s on {device})")
    return {"placement": placement, "load": load, "n_replicas": n_replicas,
            "steps": (res, res2, res3), "tokens": decoded}


if __name__ == "__main__":
    main()
