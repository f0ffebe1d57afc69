#!/usr/bin/env python3
"""Where a session step's host time goes, read from the program's spans
(``repro_torch.tracing``) on the benchmark's ``gavel-16k.drift`` cell.

    python3 tools/step_spans.py [--seed 7300002901] [--turns 3] \\
        [--steps 4] [--out build/step_spans]

Opens the cell's session on the card as ``popbench/run.py`` does (its
configuration, traffic and adapter, one CPU thread), runs the cold step and
one warm step, then ``--turns`` turns of ``--steps`` steps with the
recorder off and on, in the order off, on, on, off, off, on, ...  Each
step's map step is timed as the benchmark's traced window times it
(``popbench.trace.SolveCapture``: a synchronize on each side).

Prints, per side, ``ms_per_iter`` (time in ``solve_map`` over the slowest
lane's iterations) and the step's wall; from the recorder's steps, each
step's host time split into ``pop.prepare`` (``pop.build`` of it),
``pdhg.setup`` + ``pdhg.readback``, the eager chunks' ``pdhg.iterate`` and
``pdhg.check``, ``pdhg.capture`` (the chunk captured as a CUDA graph, its
own iterate and check inside), ``pdhg.replay`` (the graph's launches), the
flag wait (the self time of ``pdhg.loop``) and ``pop.finish``, the
averages ``prepare_s``, ``reduce_s``, ``solve_setup_s``, ``capture_s``,
``iterate_us``, ``check_us``, ``replay_us``, ``flag_wait_us``, and two
checks: the solver's parts per iteration against ``1000 * ms_per_iter``,
and ``prepare_s + reduce_s`` against ``host_prep_s``.  Where chunks
replay, the host launches a chunk in a few microseconds and then waits at
the flag while the device runs it: the flag wait is then the device's
time for the replayed chunks (``flag_wait_is``).  Then the cost of one span, opened and closed
100,000 times with the recorder off and on.  Last (a finished profiler
session slows later host calls), one step under ``torch.profiler`` with
the recorder on: the device's idle seconds under each program span (the
innermost one open at each idle gap's middle), the host's CUDA launches
in each ``pdhg.check`` and ``pdhg.iterate`` range, and whether the
mirrored ranges nest as the records do.  On the card, before it,
``--steps`` steps with CUDA events around each replay of a captured chunk
split a replayed iteration into the device's kernels, the gaps between
them inside the graph, and the launch and flag round trip.

``--device cpu --tiny`` rehearses on the CPU with the CPU tests' small
configuration (``popbench/tests/popbench_tiny.py``): its times are CPU
times, and it has no device trace.
"""

from __future__ import annotations

import argparse
import importlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from popbench import run as run_mod  # noqa: E402

CELL = "gavel-16k.drift"
SPANS = ("pop.step", "pop.prepare", "pop.build", "pop.solve_map",
         "pdhg.setup", "pdhg.loop", "pdhg.iterate", "pdhg.check",
         "pdhg.capture", "pdhg.replay", "pdhg.readback", "pop.finish")
FLAG_WAIT = {False: "the host's wait for the chunk check",
             True: "the device's time for the replayed chunks"}


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "cpu"


def split_step(recs: list) -> dict:
    """One step's host seconds by part, from its span records: the eager
    chunks' iterate and check (those a ``pdhg.loop`` holds directly; the
    captured chunk's lie in ``pdhg.capture``), the capture, the replays'
    launches and the flag wait."""
    from repro_torch import tracing
    selfs = tracing.self_ns(recs)
    loops = [r for r in recs if r.name == "pdhg.loop"]
    loop_ids = {r.id for r in loops}

    def total(name, parents=None):
        return 1e-9 * sum(r.ns for r in recs if r.name == name and (
            parents is None or r.parent in parents))

    return {"prepare": total("pop.prepare"), "build": total("pop.build"),
            "setup": total("pdhg.setup") + total("pdhg.readback"),
            "iterate": total("pdhg.iterate", loop_ids),
            "check": total("pdhg.check", loop_ids),
            "capture": total("pdhg.capture"), "replay": total("pdhg.replay"),
            "flag_wait": 1e-9 * sum(selfs[r.id] for r in loops),
            "reduce": total("pop.finish"),
            "solve_map": total("pop.solve_map"), "step": total("pop.step"),
            "iterations": sum(r.attrs["chunks"] * r.attrs["check_every"]
                              for r in loops),
            "replays": sum(r.attrs.get("replays", 0) for r in loops)}


def averages(steps: list) -> dict:
    """The span metrics over ``steps`` (each a dict of ``wall_s``,
    ``map_s``, ``iters`` and, with the recorder on, ``split``), beside
    ``ms_per_iter`` and ``host_prep_s`` as the benchmark reads them."""
    n = len(steps)
    iters = sum(s["iters"] for s in steps)
    out = {"steps": n, "iters_per_step": iters / n,
           "ms_per_iter": 1e3 * sum(s["map_s"] for s in steps) / iters,
           "host_prep_s": sum(s["wall_s"] - s["map_s"] for s in steps) / n,
           "step_wall_s": sum(s["wall_s"] for s in steps) / n}
    if all("split" in s for s in steps):
        parts = [s["split"] for s in steps]
        span_iters = sum(p["iterations"] for p in parts)

        def per_step(key):
            return sum(p[key] for p in parts) / n

        def per_iter_us(key):
            return 1e6 * sum(p[key] for p in parts) / span_iters

        out.update(prepare_s=per_step("prepare"), reduce_s=per_step("reduce"),
                   solve_setup_s=per_step("setup"),
                   capture_s=per_step("capture"),
                   iterate_us=per_iter_us("iterate"),
                   check_us=per_iter_us("check"),
                   replay_us=per_iter_us("replay"),
                   flag_wait_us=per_iter_us("flag_wait"),
                   flag_wait_is=FLAG_WAIT[any(p["replays"] for p in parts)],
                   span_iters_equal_lane_max=span_iters == iters)
        inside = (1e6 * (out["solve_setup_s"] + out["capture_s"])
                  / out["iters_per_step"]
                  + out["iterate_us"] + out["check_us"] + out["replay_us"]
                  + out["flag_wait_us"])
        out["parts_over_ms_per_iter"] = inside / (1e3 * out["ms_per_iter"])
        out["prepare_reduce_over_host_prep"] = (
            (out["prepare_s"] + out["reduce_s"]) / out["host_prep_s"])
    return out


def span_cost(n: int = 100_000) -> dict:
    """Nanoseconds to open and close one span, the recorder off and on,
    less an empty loop's."""
    from repro_torch import tracing

    def loop(body):
        t = time.perf_counter_ns()
        for _ in range(n):
            body()
        return (time.perf_counter_ns() - t) / n

    def one():
        with tracing.span("pdhg.check"):
            pass

    empty = loop(lambda: None)
    off = loop(one) - empty
    tracing.enable()
    on = loop(one) - empty
    tracing.disable()
    tracing.take()
    return {"off_ns": off, "on_ns": on}


def innermost(ranges: list, points: list) -> list:
    """The name of the innermost of ``ranges`` (``(name, start, end)``,
    nested, sorted by start) open at each of the sorted ``points``, or
    None."""
    out, stack, i = [], [], 0
    for t in points:
        while i < len(ranges) and ranges[i][1] <= t:
            while stack and stack[-1][2] < ranges[i][1]:
                stack.pop()
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        out.append(stack[-1][0] if stack else None)
    return out


def replay_times(step, next_inst, n_steps: int) -> dict:
    """``n_steps`` steps with the recorder on and a pair of CUDA events on
    the current stream around each replay of a captured chunk: the
    device's time from a graph's launch to its last kernel's end, and the
    host's time for the replayed chunks (their launches and flag waits),
    per replayed iteration."""
    import torch

    from repro_torch import tracing
    from repro_torch.core import pdhg

    marks = []
    orig = pdhg._ChunkGraph.replay

    def replay(self):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        orig(self)
        b.record()
        marks.append((a, b))

    pdhg._ChunkGraph.replay = replay
    tracing.enable()
    try:
        got = [step(next_inst(), record=False) for _ in range(n_steps)]
    finally:
        tracing.disable()
        pdhg._ChunkGraph.replay = orig
    recs = tracing.take()
    torch.cuda.synchronize()
    split = split_step(recs)
    replayed = sum(r.attrs["replays"] * r.attrs["check_every"]
                   for r in recs if r.name == "pdhg.loop")
    # the loop's time less its eager chunks and the capture: the replays'
    # launches and every flag wait (the first chunk's is a sliver of it)
    host_s = (sum(r.ns for r in recs if r.name == "pdhg.loop") * 1e-9
              - split["iterate"] - split["check"] - split["capture"])
    graph_ms = sum(a.elapsed_time(b) for a, b in marks)
    return {"steps": n_steps, "iters": sum(g["iters"] for g in got),
            "replays": split["replays"], "replayed_iters": replayed,
            "graph_us": 1e3 * graph_ms / replayed,
            "cycle_us": 1e6 * host_s / replayed,
            "capture_s": split["capture"] / n_steps}


def iteration_split(replayed: dict, profiled: dict) -> dict:
    """A replayed iteration's microseconds: the device's kernels (the
    profiled step's busy time over its iterations), the gaps between them
    inside the graph, and the rest of the host's cycle (the graph's launch
    and the flag's round trip)."""
    kernels = 1e6 * profiled["busy_s"] / profiled["iters"]
    return {"cycle": replayed["cycle_us"], "kernels": kernels,
            "in_graph_gaps": replayed["graph_us"] - kernels,
            "launch_and_flag": replayed["cycle_us"] - replayed["graph_us"]}


def profiled_step(step, next_inst, on_card: bool) -> dict:
    """One step under ``torch.profiler`` with the recorder on."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from popbench.trace import STEP, busy_ns, idle_gaps, reduce_profile
    from repro_torch import tracing

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    tracing.enable()
    with profile(activities=acts) as prof:
        with record_function(STEP):
            rec = step(next_inst(), record=False)
    tracing.disable()
    recs = tracing.take()
    p = reduce_profile(prof.profiler.kineto_results.events())
    del prof
    # the spans' device-side annotations are no device work
    p.device_ops = [o for o in p.device_ops if o[0] not in SPANS]

    mirror = [o for o in p.host_ops if o[0] in SPANS]
    ordered = sorted(recs, key=lambda r: (r.start_ns, -r.end_ns))
    nests = [m[0] for m in mirror] == [r.name for r in ordered]
    if nests:
        at = {r.id: m for r, m in zip(ordered, mirror)}
        nests = all(at[r.parent][1] <= at[r.id][1] <= at[r.id][2]
                    <= at[r.parent][2] for r in ordered
                    if r.parent is not None)

    lo, hi = p.window
    gaps = idle_gaps([(s, e) for _, s, e in p.device_ops], lo, hi)
    idle: dict = {}
    for (s, e), name in zip(gaps, innermost(mirror, [0.5 * (s + e)
                                                     for s, e in gaps])):
        idle[name or STEP] = idle.get(name or STEP, 0.0) + (e - s) * 1e-9
    starts = [o[1] for o in p.host_ops if o[0].startswith("cudaLaunch")]
    launched: dict = {}
    for name in innermost(mirror, starts):
        launched[name] = launched.get(name, 0) + 1

    def launches(name):
        ranges = sum(1 for m in mirror if m[0] == name)
        return launched.get(name, 0) / ranges if ranges else None

    busy = busy_ns([(s, e) for _, s, e in p.device_ops], lo, hi)
    return {"window_s": (hi - lo) * 1e-9, "busy_s": busy * 1e-9,
            "idle_s_by_span": dict(sorted(idle.items(),
                                          key=lambda kv: -kv[1])),
            "check_launches": launches("pdhg.check"),
            "iterate_launches": launches("pdhg.iterate"),
            "mirror_nests_as_records": nests,
            "split": split_step(recs), "iters": rec["iters"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=7300002901)
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--out", default=str(ROOT / "build" / "step_spans"),
                    help="directory of the JSON result, one file a seed")
    args = ap.parse_args(argv)

    run_mod.cache_env()
    import numpy as np
    import torch

    from popbench.generate import Rounds
    from popbench.trace import SolveCapture
    from repro_torch import tracing
    from repro_torch.service import PopService

    torch.set_num_threads(1)
    on_card = torch.device(args.device).type == "cuda"
    if on_card and not torch.cuda.is_available():
        print("step_spans: no CUDA card", file=sys.stderr)
        return 2
    spec = run_mod.load_spec()
    _, config, mix, _ = run_mod.cell_parts(spec, CELL)
    if args.tiny:
        from popbench.tests import popbench_tiny
        config = popbench_tiny.config()
    adapter = importlib.import_module(f"popbench.adapters.{config['domain']}")
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    rounds = Rounds(config, mix, args.seed)
    capture = SolveCapture(timed=True, sync=sync)
    service = PopService(device=args.device)
    solve_cfg, exec_cfg = adapter.configs(config)

    def next_inst():
        return adapter.instance(config, rounds.next())

    first = next_inst()
    session = service.session("spans", first, domain=config["domain"],
                              solve=solve_cfg, exec=exec_cfg)

    def step(inst, record=True) -> dict:
        sync()
        t = time.perf_counter()
        alloc = session.step(inst)
        sync()
        wall = time.perf_counter() - t
        calls = capture.take()
        out = {"wall_s": wall, "map_s": sum(c for c, _ in calls),
               "iters": int(sum(int(np.max(r.iterations)) for _, r in calls)),
               "plan_cache": alloc.plan_cache, "status": alloc.status}
        if record and tracing.enabled():
            out["split"] = split_step(tracing.take())
        return out

    card = card_line() if on_card else "cpu"
    print(f"[card] {card}", flush=True)
    step(first)                                  # cold: a miss
    step(next_inst())                            # warm

    sides = {"off": [], "on": []}
    turns = []
    order = ["off", "on"]
    for t in range(args.turns):
        for side in (order if t % 2 == 0 else order[::-1]):
            (tracing.enable if side == "on" else tracing.disable)()
            got = [step(next_inst()) for _ in range(args.steps)]
            tracing.disable()
            tracing.take()
            sides[side] += got
            turns.append({"side": side, **averages(got)})
            print(f"[turn {t}] {side}: " + json.dumps(turns[-1]), flush=True)
    each = [{k: s[k] for k in ("wall_s", "map_s", "iters", "plan_cache")}
            | s["split"] for s in sides["on"]]
    for s in each:
        print("[step] " + json.dumps(s), flush=True)
    summary = {side: averages(got) for side, got in sides.items()}
    summary["cost_ms_per_iter_on_over_off"] = [
        a["ms_per_iter"] / b["ms_per_iter"] for a, b in
        zip([x for x in turns if x["side"] == "on"],
            [x for x in turns if x["side"] == "off"])]
    summary["span_cost"] = span_cost()
    for side in ("off", "on"):
        print(f"[{side}] " + json.dumps(summary[side]), flush=True)
    print("[cost] ratios " + json.dumps(
        summary["cost_ms_per_iter_on_over_off"]) + " median "
        + repr(statistics.median(summary["cost_ms_per_iter_on_over_off"]))
        + " span " + json.dumps(summary["span_cost"]), flush=True)
    if on_card:
        summary["replayed"] = replay_times(step, next_inst, args.steps)
        print("[replayed] " + json.dumps(summary["replayed"]), flush=True)
    summary["profiled"] = profiled_step(step, next_inst, on_card)
    print("[profiled] " + json.dumps(summary["profiled"]), flush=True)
    if "replayed" in summary:
        summary["iteration_split_us"] = iteration_split(
            summary["replayed"], summary["profiled"])
        print("[split] " + json.dumps(summary["iteration_split_us"]),
              flush=True)

    capture.close()
    service.close()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{args.seed}.json").write_text(json.dumps(
        {"card": card, "seed": args.seed, "turns": turns, "steps": each,
         **summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
