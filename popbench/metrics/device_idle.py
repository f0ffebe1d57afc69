"""Share of the profiled steps' window in which no operation ran on the
device, in percent: one minus the union of device intervals."""

from popbench.trace import TraceRun, busy_ns


def read(run: TraceRun):
    p = run.profile
    if p is None or not p.steps or not p.device_ops:
        return None
    lo, hi = p.window
    busy = busy_ns([(s, e) for _, s, e in p.device_ops], lo, hi)
    return 100.0 * (1.0 - busy / (hi - lo))
