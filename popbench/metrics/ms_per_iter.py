"""Milliseconds inside ``solve_map`` per iteration of its slowest lane,
over the window: the solver's speed apart from how many iterations a
warm start needs."""

from popbench.trace import TraceRun, lane_max


def read(run: TraceRun):
    iters = sum(lane_max(s) for s in run.steps)
    if iters == 0:
        return None
    return 1e3 * sum(s["map_s"] for s in run.steps) / iters
