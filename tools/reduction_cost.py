"""What do the lane-count-independent reductions cost the main path?

    python tools/reduction_cost.py [--rounds 2] [--device cuda]
        [--n-jobs 16384]

Runs ``chip_smoke.py``'s main-path session (the 16,384-job Gavel fleet of
seed 0: cold, a +-3% drift, 5% churn; ``gavel`` defaults, k=8) on fresh
services in one process, with the solver's plain per-lane reductions in
two versions:

- ``row_reduce``: as the package runs them (``kernels/ref.py:
  row_reduce``: at least 16 rows, rows longer than 65,536 in chunks, each
  wide bucket summed along a row of its own);
- ``direct``: one ``torch.linalg.vector_norm`` / ``torch.sum`` over the
  stack's own rows and the bucket sums taken over the ELL width, as
  before they were made independent of the lane count.

Each round runs direct, row_reduce, row_reduce, direct and prints one JSON
line per session with each step's iterations (sum and lane max),
``build_s``, ``solve_s`` and ms per iteration (``solve_s`` over the lane
max).  Both versions share one process, card and host, so their
difference is the reductions' own; the drift and churn steps take other
iteration counts in the two versions (their last bits differ), so compare
ms per iteration there.  ``--device cpu --n-jobs 512`` runs it on the CPU
in about a minute.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import testing  # noqa: E402
from repro_torch.core import pdhg  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.service import PopService  # noqa: E402

CHURN = 0.05


def _gather_side_direct(idx, val, widx, wval, wids, v, n_out):
    """``ref._gather_side`` with the wide-bucket sums over the ELL width."""
    out = torch.sum(val * ref._bgather(v, idx), dim=-2)
    wide = torch.sum(wval * ref._bgather(v, widx), dim=-2)
    k = wids.shape[0]
    lane = torch.arange(k, device=wids.device)[:, None] * n_out
    flat = (wids.long() + lane).reshape(-1)
    return out.reshape(-1).index_add_(0, flat, wide.reshape(-1)).reshape(
        k, n_out)


VERSIONS = {
    "row_reduce": (ref.row_reduce, ref._gather_side),
    "direct": (lambda fn, a: fn(a), _gather_side_direct),
}


def session(version: str, insts, device) -> list:
    """One fresh service's three steps with the reductions of ``version``."""
    reduce_fn, gather = VERSIONS[version]
    pdhg.row_reduce, ref._gather_side = reduce_fn, gather
    try:
        sess = PopService(device=device).session("main", insts[0])
        rows = []
        for inst in insts:
            a = sess.step(inst)
            its = np.asarray(a.raw.iterations)
            rows.append(dict(step=a.plan_cache, iterations=int(its.sum()),
                             lane_max=int(its.max()),
                             build_s=a.build_time_s, solve_s=a.solve_time_s,
                             ms_per_iteration=a.solve_time_s * 1e3
                             / max(int(its.max()), 1)))
        return rows
    finally:
        pdhg.row_reduce, ref._gather_side = VERSIONS["row_reduce"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-jobs", type=int, default=16_384)
    args = ap.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print("reduction_cost: no CUDA device", file=sys.stderr)
            return 2
        print(torch.cuda.get_device_name(0), flush=True)
    workers = (4096,) * 3 if args.n_jobs >= 4096 else (128,) * 3
    insts = testing.session_instances(args.n_jobs, workers, CHURN)
    session("row_reduce", insts, device)          # first-use costs
    for r in range(args.rounds):
        for version in ("direct", "row_reduce", "row_reduce", "direct"):
            print(json.dumps({"round": r, "version": version,
                              "steps": session(version, insts, device)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
