"""Seconds a step spends outside ``solve_map`` (session, plan, build,
stack, warm-start remap, reduce, rounding), averaged over the window's
steps: the session and preparation layer."""

from popbench.trace import TraceRun


def read(run: TraceRun):
    steps = run.steps
    if not steps:
        return None
    return sum(s["wall_s"] - s["map_s"] for s in steps) / len(steps)
