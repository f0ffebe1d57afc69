"""The solve's share of its memory roofline, in percent: the least time
the work of the profiled steps' map steps needs at the card's HBM
bandwidth, over the device time of every kernel launched inside
``solve_map``.

The work is counted from the instance's LP, whatever implements it, and
padding counts for nothing.  For one lane and one iteration of that
lane's own:

* each of the two products (K x and K^T y) reads every number that
  defines K once: ``n_coef`` of them;
* the iterates x and y are each read once and written once;
* the cost c and the bounds l and u (``n_var`` each) and the right-hand
  side q (``n_con``) are each read once;

four bytes a number (float32, the configuration's precision).  A lane
that finished early adds nothing for the iterations it sat out."""

from popbench.trace import TraceRun, in_spans, is_kernel

WORD = 4


def lane_iteration_bytes(n_var: int, n_con: int, n_coef: int) -> int:
    return WORD * (2 * n_coef + 2 * (n_var + n_con) + 3 * n_var + n_con)


def work_bytes(steps: list) -> float:
    total = 0.0
    for s in steps:
        for iters in s["calls"]:
            for it, size in zip(iters, s["sizes"]):
                total += int(it) * lane_iteration_bytes(*size)
    return total


def read(run: TraceRun):
    p = run.profile
    if p is None or not p.solve_maps or not run.peaks:
        return None
    starts = [s for s, _ in p.solve_maps]
    device_ns = sum(e - s for name, s, e in p.device_ops
                    if is_kernel(name) and in_spans(s, p.solve_maps, starts))
    work = work_bytes(run.profiled)
    if device_ns <= 0 or work <= 0:
        return None
    least_s = work / float(run.peaks["hbm_bytes_per_s"])
    return 100.0 * least_s / (device_ns * 1e-9)
