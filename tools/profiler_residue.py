"""How much a finished ``torch.profiler`` session slows later host calls.

    python tools/profiler_residue.py

On a CUDA device: the host microseconds of two ``new_empty`` allocations
and of one small ``add_`` (least of three runs of 2,000 calls each), in a
fresh process, then after a profiler session of CUDA activity, then after
one of CPU and CUDA activity.  ``chip_smoke.py`` takes its with-host times
and its host breakdown before it profiles anything, because of what this
prints.  Exits nonzero without a CUDA device.
"""

from __future__ import annotations

import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

CALLS = 2_000
RUNS = 3


def host_us(fn) -> float:
    """Least host microseconds per call of ``fn`` over :data:`RUNS` runs of
    :data:`CALLS` calls."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(RUNS):
        t0 = time.perf_counter_ns()
        for _ in range(CALLS):
            fn()
        best = min(best, (time.perf_counter_ns() - t0) / CALLS / 1e3)
        torch.cuda.synchronize()
    return best


def main() -> int:
    if not torch.cuda.is_available():
        print("profiler_residue: no CUDA device", file=sys.stderr)
        return 2
    x = torch.zeros(8, 4099, device="cuda")
    a, b = torch.Size((8, 4099)), torch.Size((8, 6145))
    alloc = lambda: (x.new_empty(a), x.new_empty(b))
    add = lambda: x.add_(1.0)

    def line(when: str) -> None:
        print(f"{when}: two new_empty {host_us(alloc):.2f} us, add_ "
              f"{host_us(add):.2f} us per call", flush=True)

    print(torch.cuda.get_device_name(0))
    line("fresh process")
    for activities in ([ProfilerActivity.CUDA],
                       [ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with profile(activities=activities) as prof:
            for _ in range(10):
                add()
            torch.cuda.synchronize()
        prof.key_averages()
        line("after a profiler session of "
             + " and ".join(a.name for a in activities))
    return 0


if __name__ == "__main__":
    sys.exit(main())
