"""Run one cell of ``BENCHMARK.json`` once on one card and print its result.

    python3 popbench/run.py --workload gavel-16k.drift --seed 7 \\
        --seconds 40 --trace 0

The cell names a configuration (``popbench/configs/<config>.json``) and a
traffic mix (``popbench/traffic/<mix>.json``, read by
``popbench/generate.py``).  The run opens a session of the port's
``PopService`` on the card with the configuration's settings, solves the
first round cold and the second warm (set-up), then runs rounds back to
back, a closed loop, while the window lasts (``popbench/window.py``).  With
``--trace 1`` it also times ``solve_map`` inside each step and runs the
``traced_steps`` rounds right after set-up under ``torch.profiler``,
before the window, so the same rounds are profiled whatever the window
then holds; the per-layer readers of ``popbench/metrics/`` reduce those.
Once the program's state is freed, the plain reference of
``popbench/reference/<domain>.py`` judges every step the window held (and
the profiled ones), and each number it compares is printed beside its
limit (``popbench/limits/<cell>.json``): on the last lines of standard
error, and under ``checks``, the last key of the result line.  The result
is the last line of standard output.

The run needs a CUDA card (as many as the cell asks for) and exits with
another code than 0, printing no result, without one, or when the JAX
package or JAX is loaded in this process once the window has closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def cache_env(root: Path = ROOT) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths
    (the port's own kernels build into ``build/repro_torch_kernels/``),
    and one thread in each CPU thread pool: the solve loop is one host
    thread issuing launches, and idle pool threads only compete with it
    for the machine's shared cores."""
    for name in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                 "OPENBLAS_NUM_THREADS"):
        os.environ[name] = "1"
    cache = root / "build" / "popbench-cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    os.environ["USE_FLAX"] = "0"


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_parts(spec: dict, workload: str, root: Path = ROOT):
    """``(cell, config, mix, limits)`` of a cell, found by name."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"popbench: no workload {workload!r} in "
                         f"BENCHMARK.json ({sorted(cells)})")
    cell = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = json.loads((root / conf["file"]).read_text())
    mix = json.loads((HERE / "traffic" / f"{cell['traffic']}.json")
                     .read_text())
    limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())
    return cell, config, mix, limits


def loaded_forbidden(modules=None) -> list:
    """Top-level names among ``modules`` (default: the loaded ones) that
    this process must not hold, compared whole (``repro_torch`` is not
    ``repro``)."""
    names = list(sys.modules) if modules is None else modules
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def cell_metrics(spec: dict, workload: str, key: str) -> list:
    return [m for m in spec[key]
            if "workloads" not in m or workload in m["workloads"]]


def run_cell(spec: dict, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", config: dict = None,
             t0: float = T0, hooks=None) -> dict:
    """One run of a cell; returns the result line as a dict.  ``config``
    replaces the cell's configuration (the tests run tiny ones on the
    CPU); ``hooks``, if given, is called with the session once it is
    open (the tests plant faults through it)."""
    import numpy as np
    import torch

    from popbench import window as window_mod
    from popbench.generate import Rounds
    from popbench.trace import SolveCapture, TraceRun, reduce_profile

    cell, conf_file, mix, limits = cell_parts(spec, workload)
    config = conf_file if config is None else config
    adapter = importlib.import_module(f"popbench.adapters.{config['domain']}")
    reference = importlib.import_module(
        f"popbench.reference.{config['domain']}")
    on_card = torch.device(device).type == "cuda"
    sync = (lambda: torch.cuda.synchronize()) if on_card else (lambda: None)

    from repro_torch.service import PopService
    rounds = Rounds(config, mix, seed)
    capture = SolveCapture(timed=trace, sync=sync)
    service = PopService(device=device)
    solve_cfg, exec_cfg = adapter.configs(config)
    fleet = rounds.next()
    session = service.session("popbench", adapter.instance(config, fleet),
                              domain=config["domain"], solve=solve_cfg,
                              exec=exec_cfg)
    if hooks is not None:
        hooks(session)
    history = []          # (fleet, record, kind) of every round, in order

    def step(fleet: dict, kind: str) -> dict:
        inst = adapter.instance(config, fleet)
        sync()
        s = time.perf_counter()
        alloc = session.step(inst)
        sync()
        wall = time.perf_counter() - s
        calls = capture.take()
        rec = adapter.record(alloc, [res for _, res in calls])
        rec.update(wall_s=wall,
                   map_s=sum(t for t, _ in calls if t is not None),
                   calls=[np.asarray(res.iterations) for _, res in calls],
                   finite=bool(np.isfinite(np.asarray(alloc.alloc,
                                                      np.float64)).all()))
        history.append((fleet, rec, kind))
        return rec

    step(fleet, "setup")                                # cold: a miss
    step(rounds.next(), "setup")                        # warm
    setup_s = time.perf_counter() - t0

    profile = None
    if trace:
        # the rounds right after set-up, whatever the window then holds
        from torch.profiler import ProfilerActivity, profile as profiler
        from torch.profiler import record_function
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else [])
        with profiler(activities=acts) as prof:
            for _ in range(int(config.get("traced_steps", 1))):
                with record_function("popbench.step"):
                    step(rounds.next(), "profiled")
        profile = reduce_profile(prof.profiler.kineto_results.events())
        del prof

    cpu_before = time.process_time()
    win = window_mod.run_window(
        seconds, lambda: step(rounds.next(), "window")["wall_s"])
    t_window_end = time.perf_counter()
    # the share of the window in which this process held a core: the solve
    # loop is one host thread issuing launches
    cpu_share = (time.process_time() - cpu_before) / win.seconds

    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    capture.close()
    service.close()
    del session, service
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    forbidden = loaded_forbidden()

    # the plain reference judges every step the window held
    t_check = time.perf_counter()
    check = reference.Check(config)
    for fl, rec, kind in history:
        check.observe(fl, rec, kind != "setup")
    judged_recs = [rec for _, rec, kind in history if kind != "setup"]
    for rec, sizes in zip(judged_recs, check.sizes):
        rec["sizes"] = sizes
    window_recs = [rec for _, rec, kind in history if kind == "window"]
    profiled_recs = [rec for _, rec, kind in history if kind == "profiled"]
    failed = sum(1 for r in window_recs
                 if r["status"] != "ok" or not r["finite"])
    checks = {name: {"value": float(check.worst[name]),
                     "limit": float(limits[name])}
              for name in reference.Check.NUMBERS}
    correct = (check.judged == len(judged_recs) and all(
        c["value"] <= c["limit"] for c in checks.values()))

    metrics = {}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(0) if on_card
                            else "cpu"),
                   "count": int(cell["chips"]),
                   "memory_peak_bytes": int(memory_peak)}
    breakdown = None
    if not trace:
        values = {"step_s": window_mod.step_s(win),
                  "step_p90_s": window_mod.step_p90_s(win),
                  "setup_s": setup_s}
        for m in cell_metrics(spec, workload, "end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        from popbench import trace as trace_mod
        peaks = json.loads((HERE / "peaks.json").read_text()).get(
            device_info["kind"])
        run = TraceRun(steps=window_recs, profiled=profiled_recs,
                       profile=profile, peaks=peaks)
        for m in cell_metrics(spec, workload, "per_layer"):
            reader = importlib.import_module(f"popbench.metrics.{m['name']}")
            v = reader.read(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        if profile is not None and profile.steps:
            lo, hi = profile.window
            busy = trace_mod.busy_ns([(s, e) for _, s, e in
                                      profile.device_ops], lo, hi)
            device_info["busy_s"] = busy * 1e-9
            device_info["window_s"] = (hi - lo) * 1e-9
            breakdown = {"device_ops": trace_mod.top_device_ops(profile),
                         "idle_gaps": trace_mod.named_gaps(profile)}

    out = {"correct": bool(correct), "attempted": win.steps,
           "failed": failed, "metrics": metrics, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    notes = {"window_s": win.seconds, "steps": win.steps,
             "judged": check.judged,
             "plan_cache": [r["plan_cache"] for r in window_recs],
             "lane_max_iterations": [int(max((int(max(c, default=0))
                                              for c in r["calls"]),
                                             default=0))
                                     for r in judged_recs],
             "walls": [r["wall_s"] for r in window_recs],
             "lanes": sum(len(c) for r in judged_recs for c in r["calls"]),
             "lanes_at_cap": len(check.capped),
             "capped_lanes": [[float(f"{a:.4g}"), float(f"{b:.4g}")]
                              for a, b in check.capped],
             "cpu_share": cpu_share,
             "seconds": {"setup": setup_s,
                         "window": t_window_end - win.start,
                         "check": time.perf_counter() - t_check},
             "forbidden_modules": forbidden}
    return {"result": out, "notes": notes}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env()
    spec = load_spec()
    cells = {w["name"]: w for w in spec["workloads"]}
    if args.workload not in cells:
        print(f"popbench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch
    torch.set_num_threads(1)
    want = int(cells[args.workload]["chips"])
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < want:
        print(f"popbench: {args.workload} needs {want} CUDA device(s); "
              f"this machine has {have}", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    out = run_cell(spec, args.workload, args.seed, args.seconds,
                   bool(args.trace))
    notes, result = out["notes"], out["result"]
    if notes["forbidden_modules"]:
        print("popbench: loaded once the window closed: "
              + ", ".join(notes["forbidden_modules"]), file=sys.stderr)
        return 3
    print("popbench: " + json.dumps(notes), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
