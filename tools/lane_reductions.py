"""Does a lane's arithmetic depend on how many lanes share its stack?

    python tools/lane_reductions.py [--device cuda] [--domain gavel]
        [--n-jobs 16384] [--lanes 16 24 32 64]

Builds tenants' stacks (``--domain gavel``: k=8 Gavel stacks at the main
path's fleet, seeds 0, 1, ..., ``testing.session_instances``; ``balance``:
k=4 load-balancing stacks of the ``balance-session`` workload, 8,192
shards on 256 servers, ``testing.balance_ops``, the later tenants its
copies with scaled costs), concatenates them as the
serving dispatcher does (``pdhg.concat_stacks``) into each of ``--lanes``
lanes, and compares, bit for bit, tenant 0's lanes of every plain torch
reduction ``pdhg.solve_stacked`` runs outside the half-step kernels
against tenant 0's stack alone: the row and column products
(``smatvec``/``smatvec_t``, summed over the padded ELL width), the
per-lane 2-norm (``_vnorm``), the KKT scores, the power iteration and the
equilibration.  Prints one line per quantity and stack size: equal, or
the largest difference.  On the CPU it runs at a small fleet
(``--n-jobs 512``, or ``--n-jobs 1024`` shards for ``balance``) in a few
seconds.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import testing  # noqa: E402
from repro_torch.core import pdhg, pop  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.problems import load_balancing as lb  # noqa: E402
from repro_torch.problems.cluster_scheduling import GavelProblem  # noqa: E402

# each domain's lanes per tenant (its default k)
LANES = {"gavel": 8, "balance": 4}


def stacks(domain: str, tenants: int, n_jobs: int, device):
    """``tenants`` tenants' prepared stacks of ``domain`` on ``device``."""
    out = []
    for seed in range(tenants):
        if domain == "gavel":
            workers = (4096,) * 3 if n_jobs >= 4096 else (128,) * 3
            inst = testing.session_instances(n_jobs, workers, 0.05,
                                             seed=seed)[0]
            prob = GavelProblem(inst.wl)
            plan = pop.plan(prob, LANES[domain], strategy="stratified",
                            seed=0)
            out.append(pop.build(prob, plan, device))
        elif seed == 0:
            prob = lb.LoadBalanceProblem(lb.make_shard_workload(
                n_jobs, max(n_jobs // 32, 8), eps_frac=0.15, seed=0))
            out.append(testing.balance_ops(prob, LANES[domain], device,
                                           structured=True))
        else:
            # another seed pads its lanes to other widths (another key):
            # tenant 0's stack with its costs scaled
            out.append(out[0]._replace(c=out[0].c * (1.0 + 0.01 * seed)))
    return out


def quantities(op):
    """{name: [lanes, ...] tensor} of the solver's plain reductions on the
    stack ``op``, at inputs made from the stack itself."""
    eng = pdhg.fused_structured_engine()
    opd = eng.prep(op)
    s = opd.data
    k, n, m = op.c.shape[0], op.c.shape[-1], op.q.shape[-1]
    dev = op.c.device
    # a lane's inputs depend on the lane, not on its place in the stack
    x = torch.sin(torch.arange(n, device=dev) * 0.37)[None] * (1 + op.c.abs())
    y = torch.cos(torch.arange(m, device=dev) * 0.11)[None] * (1 + op.q.abs())
    kx, kty = ref.smatvec(s, x), ref.smatvec_t(s, y)
    narrow = torch.sum(s.row_val * ref._bgather(x, s.row_idx), dim=-2)
    pr, gap, p_obj, d_obj = pdhg._kkt_from_products(opd, x, y, kx, kty)
    d_r, d_c = pdhg._equilibrate(eng, opd)
    knorm = pdhg._power_iteration(eng, s, k, n, op.c.device)
    return {"smatvec": kx, "smatvec_t": kty, "smatvec narrow": narrow,
            "_vnorm(x)": pdhg._vnorm(x),
            "primal_res": pr, "gap": gap, "primal_obj": p_obj,
            "power_iteration": knorm, "equilibrate d_r": d_r,
            "equilibrate d_c": d_c}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--domain", choices=sorted(LANES), default="gavel")
    ap.add_argument("--n-jobs", type=int, default=None,
                    help="jobs (gavel, default 16,384) or shards (balance, "
                         "default 8,192; servers are shards / 32)")
    ap.add_argument("--lanes", type=int, nargs="+", default=[16, 24, 32, 64])
    args = ap.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("lane_reductions: no CUDA device", file=sys.stderr)
        return 2
    k = LANES[args.domain]
    n_jobs = args.n_jobs or {"gavel": 16_384, "balance": 8_192}[args.domain]
    if any(lanes % k for lanes in args.lanes):
        ap.error(f"--lanes must be multiples of {k} for {args.domain}")
    ops = stacks(args.domain, max(args.lanes) // k, n_jobs, device)
    if device.type == "cuda":
        print(f"device {torch.cuda.get_device_name(0)}; torch "
              f"{torch.__version__}, CUDA {torch.version.cuda}")
    print(f"{args.domain} at {n_jobs}: {k} lanes a tenant, N="
          f"{ops[0].c.shape[-1]}, M={ops[0].q.shape[-1]}")
    base = {name: v[:k].cpu() for name, v in quantities(ops[0]).items()}
    for lanes in args.lanes:
        merged = pdhg.concat_stacks(ops[: lanes // k])
        got = quantities(merged)
        for name, want in base.items():
            v = got[name][:k].cpu()
            same = torch.equal(v, want)
            diff = float((v - want).abs().max())
            rel = diff / max(float(want.abs().max()), 1e-30)
            print(f"{name:16s} tenant 0's lanes in a {lanes}-lane stack: "
                  + ("bit-identical" if same else
                     f"differ, max |d| {diff:.3g} (relative {rel:.3g})"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
