"""Why do concurrent tenants' Python threads slow each other down?

    python tools/gil_contention.py [--switch 0.0001] [--repeats 2]
        [--device cuda] [--n-jobs 16384] [--modes ...] [--stacks]

On one CUDA card, runs ``chip_smoke.py``'s async tenants (four 16,384-job
Gavel fleets, seeds 0-3) in a fresh process per mode, and in each: held
rounds C (cold) and D (drift) of four tenants and P (three repairs)
through ``PopService(dispatch=DispatchConfig(max_lanes=32))``, then round
D through ``step_async`` on a service without a dispatcher (four solve
loops on four threads), then round D one step after another.  The modes:

- ``default``: CPython's switch interval (5 ms), the kernel libraries
  loaded with ``ctypes.CDLL`` (each launch releases the interpreter lock
  and takes it back);
- ``switch``: ``sys.setswitchinterval(--switch)``;
- ``pydll``: the kernel libraries loaded with ``ctypes.PyDLL``, which keeps
  the lock across each launch (a few microseconds);
- ``threads1``: one intra-op CPU thread for torch and numpy's BLAS
  (``OMP_NUM_THREADS`` and ``OPENBLAS_NUM_THREADS`` set to 1 before either
  is imported).

Each process prints one JSON line: each round's wall and, for the held
rounds, the seconds until the last request reached the dispatcher (the
prepare time), the process's CPU seconds over each part, and the lane-max
iterations, so a mode that changes the work is seen.  With ``--stacks`` a
sampler thread reads the service threads' Python stacks every 5 ms
during held P and ``step_async`` D and the line adds each part's most
frequent innermost frames (the sampler takes the lock too: time such a run
apart from the others).  The modes run in the
order given and then reversed (``--repeats 2``), which cancels a drift of
the card or its host; compare modes only within one call.  Exits nonzero
without a CUDA device or when a process fails.  ``--device cpu --n-jobs
512`` runs it on the CPU with the kernels' plain versions, in about a
minute.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MODES = ("default", "switch", "pydll", "threads1")

# what one process runs: the mode's setting, then the rounds
CHILD = r"""
import collections, contextlib, ctypes, io, json, os, sys, threading, time
import warnings
mode, switch, device, n_jobs, stacks = sys.argv[1:6]
if mode == "threads1":
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
sys.path.insert(0, "src")
sys.path.insert(0, ".")
import numpy as np, torch
import chip_smoke as cs
from repro_torch.kernels import build
from repro_torch.service import DispatchConfig, PopService
warnings.filterwarnings("ignore", message=".*[Ss]parse.*")
switch, n_jobs = float(switch), int(n_jobs)
if n_jobs != cs.N_JOBS:
    cs.N_JOBS, cs.NUM_WORKERS = n_jobs, (n_jobs // 4,) * 3
if mode == "switch":
    sys.setswitchinterval(switch)
elif mode == "pydll":
    def load(name):
        with build._lock:
            if name not in build._libs:
                build._libs[name] = ctypes.PyDLL(str(build.build()[name]))
            return build._libs[name]
    build.load = load
dev = torch.device(device)
if dev.type == "cuda":
    with contextlib.redirect_stdout(io.StringIO()):
        cs.phase_build()
tenants = cs.async_tenants()
four = [f"A{s}" for s in cs.ASYNC_SEEDS]
row = {"mode": mode, "switch_interval_s": sys.getswitchinterval(),
       "torch_threads": torch.get_num_threads()}


samples, sampling = {}, [None]


def sampler():
    while True:
        name = sampling[0]
        if name:
            frames = sys._current_frames()
            for th in threading.enumerate():
                f = frames.get(th.ident)
                if f is None or not th.name.startswith(("pop-step",
                                                        "pop-dispatch")):
                    continue
                where = []
                while f is not None and len(where) < 3:
                    where.append(f"{os.path.basename(f.f_code.co_filename)}"
                                 f":{f.f_code.co_name}:{f.f_lineno}")
                    f = f.f_back
                samples.setdefault(name, collections.Counter())[
                    " < ".join(where)] += 1
        time.sleep(0.005)


if stacks == "1":
    threading.Thread(target=sampler, daemon=True).start()


def part(name, fn):
    c0, t0 = time.process_time(), time.perf_counter()
    sampling[0] = name if name in ("held P", "step_async D") else None
    out = fn()
    sampling[0] = None
    row[name] = dict(wall_s=time.perf_counter() - t0,
                     cpu_s=time.process_time() - c0)
    return out


def lane_max(allocs):
    return {n: int(cs._lane_its(a).max()) for n, a in allocs.items()}


svc = PopService(device=dev, dispatch=DispatchConfig(
    max_lanes=cs.ASYNC_LANES, max_wait_ms=cs.ASYNC_WAIT_MS))
sess = {n: svc.session(n, tenants[n][1]["C"]) for n in four}
cold = None
for rnd, names in (("C", four), ("D", four), ("P", four[:3])):
    allocs, wall, prep_s = part(f"held {rnd}", lambda: cs.held_round(
        svc, sess, {n: tenants[n][1][rnd] for n in names}))
    row[f"held {rnd}"].update(prepare_s=prep_s, lane_max=lane_max(allocs))
    cold = allocs if rnd == "C" else cold
svc.close()
plain = PopService(device=dev)
psess = {n: plain.session(n, tenants[n][1]["C"]).seed(cold[n].raw)
         for n in four}


def threaded():
    futs = {n: psess[n].step_async(tenants[n][1]["D"]) for n in four}
    return {n: f.result(timeout=600) for n, f in futs.items()}


allocs = part("step_async D", threaded)
row["step_async D"]["lane_max"] = lane_max(allocs)
plain.close()
seq = PopService(device=dev)
ssess = {n: seq.session(n, tenants[n][1]["C"]).seed(cold[n].raw)
         for n in four}
allocs = part("sync D", lambda: {n: ssess[n].step(tenants[n][1]["D"])
                                 for n in four})
row["sync D"]["lane_max"] = lane_max(allocs)
if samples:
    row["stacks"] = {name: c.most_common(10) for name, c in samples.items()}
print(json.dumps(row))
"""


def run(mode: str, switch: float, device: str, n_jobs: int,
        stacks: bool) -> dict:
    proc = subprocess.run([sys.executable, "-c", CHILD, mode, str(switch),
                           device, str(n_jobs), str(int(stacks))], cwd=ROOT,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{mode}: exit {proc.returncode}\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--switch", type=float, default=1e-4,
                    help="the switch interval of the 'switch' mode, s")
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--modes", nargs="+", default=list(MODES),
                    choices=MODES)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-jobs", type=int, default=16_384)
    ap.add_argument("--stacks", action="store_true")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("gil_contention: no CUDA device", file=sys.stderr)
        return 2
    if args.device == "cuda":
        print(torch.cuda.get_device_name(0), flush=True)
    order = list(args.modes)
    for r in range(args.repeats):
        for mode in (order if r % 2 == 0 else order[::-1]):
            row = run(mode, args.switch, args.device, args.n_jobs,
                      args.stacks)
            print(json.dumps({"repeat": r, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
