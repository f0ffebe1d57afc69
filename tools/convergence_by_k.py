"""Which lanes of the main path's Gavel session converge, for each k?

    python tools/convergence_by_k.py [--device cuda] [--n-jobs 16384]
        [--ks 1 2 4 8 16 32 64]

Runs ``chip_smoke.py``'s main-path session (cold, a +-3% throughput drift,
5% churn under new ids; ``--n-jobs`` jobs on ``n_jobs / 4`` accelerators
of each of three types; the ``gavel`` registry defaults apart from k:
equilibrate, tolerances 1e-4, 20,000 iterations) through
``PopService`` once for each k of ``--ks``, each in a fresh service, and
prints one JSON line per step: its plan-cache verdict, converged lanes,
the unconverged lanes' indices, each lane's PDHG iterations, the
normalised throughputs and the step's wall.  The tuner's plan for the
smoke's ``tune`` phase picks k from measured timings, so this says which
picks the solver's budget covers on that fleet.  On the CPU run it at a
small fleet (``--device cpu --n-jobs 512``, seconds).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import testing  # noqa: E402
from repro_torch.core.config import SolveConfig  # noqa: E402
from repro_torch.service import PopService  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-jobs", type=int, default=16_384)
    ap.add_argument("--churn", type=float, default=0.05)
    ap.add_argument("--ks", type=int, nargs="*",
                    default=[1, 2, 4, 8, 16, 32, 64])
    args = ap.parse_args()
    device = torch.device(args.device)
    insts = testing.session_instances(args.n_jobs, (args.n_jobs // 4,) * 3,
                                      args.churn)
    for k in args.ks:
        sess = PopService(device=device).session(f"k{k}", insts[0],
                                                 solve=SolveConfig(k=k))
        for inst in insts:
            t0 = time.perf_counter()
            a = sess.step(inst)
            if device.type == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            raw = getattr(a.raw, "res", a.raw)     # k=1: a FullResult
            its = np.atleast_1d(np.asarray(raw.iterations))
            conv = np.atleast_1d(np.asarray(raw.converged))
            print(json.dumps(dict(
                k=a.k, verdict=a.plan_cache, status=a.status,
                converged=f"{int(conv.sum())}/{conv.size}",
                unconverged=np.flatnonzero(~conv).tolist(),
                iterations=its.tolist(),
                mean_norm_throughput=a.metrics["mean_norm_throughput"],
                min_norm_throughput=a.metrics["min_norm_throughput"],
                wall_s=wall)), flush=True)


if __name__ == "__main__":
    main()
