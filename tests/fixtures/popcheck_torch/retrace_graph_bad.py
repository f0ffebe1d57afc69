"""Known-bad fixture: per-call CUDA graph captures and fresh keys into the
port's own cached doors (``_memoized`` builders, ``make_map_solver``)."""
import torch

from repro_torch.core import backends
from repro_torch.core.pdhg import _memoized


@_memoized(maxsize=4)
def _engine(kernel_backend, plan):
    return kernel_backend, plan


def engine_each_call(s):
    # BAD: a list literal keys a _memoized builder — TypeError or a miss
    return _engine(None, [(0, 128, 8)])


def solver_each_call(K_mv, KT_mv, batch, its):
    # BAD: a dict literal into make_map_solver — a fresh solver every call
    return backends.make_map_solver(K_mv, KT_mv, {"max_iters": its})(batch)


def chunk_each_call(step, x):
    # BAD: a graph built and captured on every call
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = step(x)
    g.replay()
    return out


def graphed_each_call(make, x):
    # BAD: make_graphed_callables of a fresh callable, run in the same call
    fn = torch.cuda.make_graphed_callables(make(), (x,))
    return fn(x)
