"""Good twin: the memoized-builder pattern."""
import functools

import torch


@functools.lru_cache(maxsize=8)
def _cached_builder(key, fn):
    return key, fn


@functools.lru_cache(maxsize=8)
def _runner(solver):
    # compile inside an lru_cached builder: built once per solver identity
    return torch.compile(lambda c: torch.stack([solver(a) for a in c]))


def build_once(named_fn):
    return _cached_builder("k", named_fn)


def solve_cached(solver, chunked):
    return _runner(solver)(chunked)
