"""Known-bad fixture: fresh objects defeating the builder caches."""
import functools

import torch


@functools.lru_cache(maxsize=8)
def _cached_builder(key, fn):
    return key, fn


def build_each_call(data):
    # BAD: lambda arg to an lru_cached function — cache miss every call
    return _cached_builder("k", lambda x: x + 1)


def solve_each_call(solver, chunked):
    # BAD: compile of a fresh lambda invoked in place — recompiles per call
    return torch.compile(lambda c: torch.stack([solver(a) for a in c]))(
        chunked)


def wrap_each_call(make, batch):
    # BAD: locally-built callable compiled then invoked in the same function
    fn = torch.compile(make())
    return fn(batch)
