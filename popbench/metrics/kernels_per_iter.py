"""Device kernels launched inside ``solve_map`` per iteration of its
slowest lane, over the profiled steps (copies and fills not counted)."""

from popbench.trace import TraceRun, in_spans, is_kernel, lane_max


def read(run: TraceRun):
    p = run.profile
    iters = sum(lane_max(s) for s in run.profiled)
    if p is None or not p.solve_maps or iters == 0:
        return None
    starts = [s for s, _ in p.solve_maps]
    n = sum(1 for name, s, _ in p.device_ops
            if is_kernel(name) and in_spans(s, p.solve_maps, starts))
    return n / iters if n else None
