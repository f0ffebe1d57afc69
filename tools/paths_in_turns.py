"""Run the main path and the TE-20k full solve of two checkouts in turns.

    python tools/paths_in_turns.py OLD_CHECKOUT NEW_CHECKOUT [--rounds 1]
        [--main-only]

On one CUDA card: for each round, a fresh process per checkout, in the
order old, new, new, old, runs that checkout's own ``chip_smoke.py``
phases ``main`` twice (the 16,384-job Gavel session: cold, drift, churn;
the first pass pays the process's first-use costs) and ``full`` (the
unpartitioned traffic LP at 20,000 demands, f32 then int8; not with
``--main-only``), and prints one JSON line per process with each step's
iterations (sum and lane max), ``build_s``, ``solve_s``, ms per iteration
(``solve_s`` over the lane max) and quality.  Both checkouts build their own kernels.  The
order cancels a drift of the card or its host over the call; compare a
number only with the other checkout's in the same call.  Exits nonzero
without a CUDA device or when a process fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

# what one process runs inside a checkout: its chip_smoke phases
CHILD = r"""
import io, json, sys, contextlib, warnings
sys.path.insert(0, "src")
sys.path.insert(0, ".")
import numpy as np, torch
import chip_smoke as cs
from repro_torch import testing
warnings.filterwarnings("ignore", message=".*[Ss]parse.*")
dev = torch.device("cuda")
out = io.StringIO()
with contextlib.redirect_stdout(out):
    cs.phase_build()
    mains = [cs.phase_main(dev)[2] for _ in range(2)]
    if "--main-only" not in sys.argv:
        runs, _ = cs.phase_full(dev, testing.traffic_arrays(cs.TE_DEMANDS))
row = {f"main{n}": [dict(step=a.plan_cache,
                         iterations=int(np.asarray(a.raw.iterations).sum()),
                         lane_max=int(np.asarray(a.raw.iterations).max()),
                         build_s=a.build_time_s, solve_s=a.solve_time_s,
                         ms_per_iteration=a.solve_time_s * 1e3 / int(
                             np.asarray(a.raw.iterations).max()),
                         mean_norm_throughput=a.metrics[
                             "mean_norm_throughput"])
                    for a in allocs]
       for n, allocs in enumerate(mains, 1)}
if "--main-only" not in sys.argv:
    row["full"] = {dt: dict(iterations=int(fr.res.iterations),
                            solve_s=fr.solve_time_s,
                            total_flow=m["total_flow"])
                   for dt, (fr, m) in runs.items()}
print(json.dumps(row))
"""


def run(checkout: Path, main_only: bool) -> dict:
    argv = ["--main-only"] if main_only else []
    proc = subprocess.run([sys.executable, "-c", CHILD, *argv], cwd=checkout,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{checkout}: exit {proc.returncode}\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    import torch
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("old", type=Path)
    parser.add_argument("new", type=Path)
    parser.add_argument("--rounds", type=int, default=1)
    parser.add_argument("--main-only", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("paths_in_turns: no CUDA device", file=sys.stderr)
        return 2
    print(torch.cuda.get_device_name(0), flush=True)
    for r in range(args.rounds):
        for tag in ("old", "new", "new", "old"):
            row = run(getattr(args, tag).resolve(), args.main_only)
            print(json.dumps({"round": r, "checkout": tag, **row}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
