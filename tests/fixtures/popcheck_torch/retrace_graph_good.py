"""Good twin: hashable keys, graphs captured once in a memoized builder
and replayed."""
import functools

import torch

from repro_torch.core import backends
from repro_torch.core.pdhg import _memoized

PLAN = ((0, 128, 8),)
SOLVER_KW = (("max_iters", 400),)


@_memoized(maxsize=4)
def _engine(kernel_backend, plan):
    return kernel_backend, plan


@functools.lru_cache(maxsize=8)
def _captured(step, x):
    # captured once per (step, buffer) and replayed by every caller
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = step(x)
    return g, out


@functools.lru_cache(maxsize=8)
def _graphed(fn, x):
    return torch.cuda.make_graphed_callables(fn, (x,))


def engine_once(s):
    return _engine(None, PLAN)


def solver_once(K_mv, KT_mv, batch):
    return backends.make_map_solver(K_mv, KT_mv, dict(SOLVER_KW))(batch)


def chunk_replayed(step, x):
    g, out = _captured(step, x)
    g.replay()
    return out


def graphed_once(fn, x):
    return _graphed(fn, x)(x)
