"""Spans and the device trace of a run, reduced to what the per-layer
readers in ``popbench/metrics/`` read.

* :class:`SolveCapture` wraps ``repro_torch.core.backends.solve_map``
  from here while a run lasts: it keeps every call's ``SolveResult`` (the
  per-lane iterations, objectives and flags the reference and the readers
  need); in a traced run it also times each call on the host clock after
  a device synchronize and opens a ``popbench.solve_map`` profiler range
  around it.  Both domains call the map step through the module
  attribute, so the wrapper sees every call.
* :func:`reduce_profile` turns a ``torch.profiler`` session's events into
  a :class:`Profile`: device operations, the ``popbench.step`` and
  ``popbench.solve_map`` ranges, and the host operations of the thread
  that ran the steps (to name what the host did while the device idled).
"""

from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Optional

STEP = "popbench.step"
SOLVE_MAP = "popbench.solve_map"


class SolveCapture:
    def __init__(self, timed: bool, sync=None):
        from repro_torch.core import backends
        self.backends = backends
        self.orig = backends.solve_map
        self.timed = timed
        self.sync = sync or (lambda: None)
        self.calls: list = []

        def wrapper(*args, **kwargs):
            if not self.timed:
                out = self.orig(*args, **kwargs)
                self.calls.append((None, out))
                return out
            import torch
            self.sync()
            t0 = time.perf_counter()
            with torch.profiler.record_function(SOLVE_MAP):
                out = self.orig(*args, **kwargs)
            self.sync()
            self.calls.append((time.perf_counter() - t0, out))
            return out

        backends.solve_map = wrapper

    def take(self) -> list:
        out, self.calls = self.calls, []
        return out

    def close(self) -> None:
        self.backends.solve_map = self.orig


@dataclasses.dataclass
class Profile:
    """Times in nanoseconds on the profiler's clock."""

    device_ops: list          # (name, start, end) of every device operation
    steps: list               # (start, end) of each popbench.step range
    solve_maps: list          # (start, end) of each popbench.solve_map range
    host_ops: list            # (name, start, end) on the stepping thread

    @property
    def window(self) -> tuple:
        return (min(s for s, _ in self.steps), max(e for _, e in self.steps))


def is_kernel(name: str) -> bool:
    """A launched kernel, not a copy or a fill."""
    return not name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def reduce_profile(events) -> Profile:
    """``events``: the profiler's raw events
    (``prof.profiler.kineto_results.events()``)."""
    device_ops, steps, maps, host = [], [], [], []
    step_thread = None
    for e in events:
        name = e.name()
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type().name == "CUDA":
            if e.is_user_annotation() or name.startswith("popbench."):
                continue
            device_ops.append((name, start, end))
        elif name == STEP:
            steps.append((start, end))
            step_thread = e.start_thread_id()
        elif name == SOLVE_MAP:
            maps.append((start, end))
    for e in events:
        if (e.device_type().name != "CUDA" and step_thread is not None
                and e.start_thread_id() == step_thread):
            start = e.start_ns()
            host.append((e.name(), start, start + e.duration_ns()))
    return Profile(device_ops=sorted(device_ops, key=lambda o: o[1]),
                   steps=sorted(steps), solve_maps=sorted(maps),
                   host_ops=sorted(host, key=lambda o: (o[1], -o[2])))


def union(intervals, lo: float, hi: float) -> list:
    """The union of ``(start, end)`` intervals clipped to [lo, hi], as
    disjoint sorted intervals."""
    out = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def busy_ns(intervals, lo: float, hi: float) -> float:
    return float(sum(e - s for s, e in union(intervals, lo, hi)))


def idle_gaps(intervals, lo: float, hi: float) -> list:
    """The stretches of [lo, hi] that no interval covers."""
    gaps, t = [], lo
    for s, e in union(intervals, lo, hi):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def host_op_at(host_ops: list, starts: list, t: float,
               default: str) -> str:
    """The innermost host operation open at ``t`` (the one that started
    last among those that contain it, looked for among the 64 that
    started last before ``t``); ``starts`` is the sorted start list of
    ``host_ops``."""
    i = bisect.bisect_right(starts, t) - 1
    best: Optional[str] = None
    limit = 64
    while i >= 0 and limit:
        name, s, e = host_ops[i]
        if e >= t:
            best = name
            break
        i -= 1
        limit -= 1
    return best or default


def named_gaps(profile: Profile, top: int = 10) -> list:
    """Idle time of the device in the traced window, summed by the host
    operation open at each gap's middle (the popbench range around it
    where only Python ran): ``[[name, seconds], ...]``, longest first."""
    lo, hi = profile.window
    gaps = idle_gaps([(s, e) for _, s, e in profile.device_ops], lo, hi)
    starts = [s for _, s, _ in profile.host_ops]
    map_starts = [s for s, _ in profile.solve_maps]
    total: dict = {}
    for s, e in gaps:
        mid = 0.5 * (s + e)
        outer = (SOLVE_MAP if in_spans(mid, profile.solve_maps, map_starts)
                 else STEP)
        name = host_op_at(profile.host_ops, starts, mid, outer)
        total[name] = total.get(name, 0.0) + (e - s) * 1e-9
    return [[n, v] for n, v in sorted(total.items(), key=lambda kv: -kv[1])
            [:top]]


def top_device_ops(profile: Profile, top: int = 10) -> list:
    lo, hi = profile.window
    total: dict = {}
    for name, s, e in profile.device_ops:
        if s >= lo and s < hi:
            total[name] = total.get(name, 0.0) + (e - s) * 1e-9
    return [[n, v] for n, v in sorted(total.items(), key=lambda kv: -kv[1])
            [:top]]


def in_spans(t: float, spans: list, starts: list) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= spans[i][1]


@dataclasses.dataclass
class TraceRun:
    """What a traced run hands each per-layer reader.

    ``steps`` are the timed window's steps and ``profiled`` the steps run
    under the profiler after it; each is a dict with ``wall_s`` (the
    step's host wall time), ``map_s`` (seconds inside ``solve_map``),
    ``calls`` (one array of per-lane iterations for each ``solve_map``
    call) and ``sizes`` (per lane ``(n_var, n_con, n_coef)`` of the LP
    without padding, from the reference).  ``profile`` is the profiled
    steps' :class:`Profile`; ``peaks`` the card's row of
    ``popbench/peaks.json`` (None for a card not in it)."""

    steps: list
    profiled: list
    profile: Optional[Profile]
    peaks: Optional[dict]


def lane_max(step: dict) -> int:
    """The iterations a step's map steps ran: the slowest lane of each."""
    return int(sum(int(max(c, default=0)) for c in step["calls"]))
