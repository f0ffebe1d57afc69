"""Readings that the limits of ``popbench/limits/<cell>.json`` are set
between: the control, and the faults a cell can have, each judged by the
same reference as a run.

    python3 popbench/control.py --workload gavel-16k.drift \\
        --seeds 11 12 13 --rounds 4 --fault-seconds 6

For every seed it prints one JSON line per reading:

* ``control``: the reference put in the program's place
  (``reference/<domain>.py``'s ``Control``) and computed in the precision
  below the configuration's, for the set-up rounds and ``--rounds``
  rounds after them (as many as a run judges);
* ``stale``: the program, with every step after set-up solving as usual
  but handing back the previous step's allocation unchanged;
* ``half``: the program, with the second half of the lanes of every map
  step after set-up left out (their iterates and objective zero, and
  reported unconverged after 0 iterations, as if never solved);
* ``half_capped``: the same lanes left out, but reported as stopped at
  the iteration cap;
* ``half_converged``: the same lanes left out, but reported converged;
* ``altered``: the program, with one entry of every answer after set-up
  changed where it is produced.

A cell on one card has no exchange between cards to leave out.  The run
needs a card; ``popbench/tests/test_popbench_control.py`` calls the same
functions on the host at a small size.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
for _p in (str(HERE.parent / "src"), str(HERE.parent)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from popbench import run as run_mod  # noqa: E402

FAULTS = ("stale", "half", "half_capped", "half_converged", "altered")


def control_reading(workload: str, config: dict, seed: int, rounds: int,
                    device: str) -> dict:
    from popbench.generate import Rounds
    spec = run_mod.load_spec()
    _, _, mix, _ = run_mod.cell_parts(spec, workload)
    reference = importlib.import_module(
        f"popbench.reference.{config['domain']}")
    ctl = reference.Control(config, device)
    check = reference.Check(config)
    gen = Rounds(config, mix, seed)
    for r in range(2 + rounds):
        fleet = gen.next()
        rec = ctl.step(fleet)
        check.observe(fleet, rec, r >= 2)
    return {name: float(check.worst[name]) for name in check.NUMBERS}


def plant(fault: str, max_iters: int):
    """A ``hooks`` callable for :func:`popbench.run.run_cell` that plants
    ``fault`` under the session once set-up's two steps are done."""
    import dataclasses

    import numpy as np

    def hooks(session):
        from repro_torch.core import backends
        state = {"steps": 0, "last": None}
        orig_step = session.step
        orig_map = backends.solve_map

        def step(inst, **kw):
            state["steps"] += 1
            alloc = orig_step(inst, **kw)
            if fault == "stale" and state["steps"] > 2:
                return state["last"]
            if fault == "altered" and state["steps"] > 2:
                a = np.array(alloc.alloc, copy=True)
                a[0] = a[0] + 1e-3
                alloc = dataclasses.replace(alloc, alloc=a)
            state["last"] = alloc
            return alloc

        def solve_map(*args, **kwargs):
            res = orig_map(*args, **kwargs)
            if state["steps"] < 2:
                return res
            k = res.x.shape[0]
            x, y = res.x.copy(), res.y.copy()
            obj = np.array(res.primal_obj, copy=True)
            its = np.array(res.iterations, copy=True)
            conv = np.array(res.converged, copy=True)
            x[k // 2:] = 0.0
            y[k // 2:] = 0.0
            obj[k // 2:] = 0.0
            its[k // 2:] = max_iters if fault == "half_capped" else 0
            conv[k // 2:] = fault == "half_converged"
            return res._replace(x=x, y=y, primal_obj=obj, iterations=its,
                                converged=conv)

        session.step = step
        if fault.startswith("half"):
            backends.solve_map = solve_map
    return hooks


def fault_reading(workload: str, config: dict, seed: int, seconds: float,
                  fault: str, device: str) -> dict:
    from repro_torch.core import backends
    spec = run_mod.load_spec()
    max_iters = int(config["solver"]["max_iters"])
    orig = backends.solve_map
    try:
        out = run_mod.run_cell(spec, workload, seed, seconds, False,
                               device=device, config=config,
                               t0=time.perf_counter(),
                               hooks=plant(fault, max_iters))
    finally:
        backends.solve_map = orig
    return {name: c["value"] for name, c in out["result"]["checks"].items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--fault-seconds", type=float, default=8.0)
    ap.add_argument("--modes", nargs="+", default=("control",) + FAULTS,
                    choices=("control",) + FAULTS)
    args = ap.parse_args(argv)
    run_mod.cache_env()
    spec = run_mod.load_spec()
    _, config, _, limits = run_mod.cell_parts(spec, args.workload)
    import torch
    if not torch.cuda.is_available():
        print("popbench: no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        for mode in args.modes:
            t = time.perf_counter()
            if mode == "control":
                vals = control_reading(args.workload, config, seed,
                                       args.rounds, "cuda")
            else:
                vals = fault_reading(args.workload, config, seed,
                                     args.fault_seconds, mode, "cuda")
            failed = sorted(n for n, v in vals.items() if not v <= limits[n])
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "mode": mode, "readings": vals,
                              "fails": failed,
                              "seconds": time.perf_counter() - t}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
