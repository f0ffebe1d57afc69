"""PDHG iterations a step's map step runs (the slowest lane of each
``solve_map`` call), averaged over the window's steps."""

from popbench.trace import TraceRun, lane_max


def read(run: TraceRun):
    if not run.steps:
        return None
    return sum(lane_max(s) for s in run.steps) / len(run.steps)
