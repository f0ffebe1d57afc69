"""Program spans: where a session step's host time goes.

    from repro_torch import tracing
    tracing.enable()
    alloc = session.step(instance)
    records = tracing.take()     # [SpanRecord, ...], in order of ending

A span is a named interval of host time on one thread, opened with
``with tracing.span(name, **attrs) as s`` (``s.set(**attrs)`` adds
attributes known only at its end).  Each :class:`SpanRecord` holds the
name, its own id and its parent's (the span open on the same thread when
it opened: parents come from a per-thread stack), the id of the
``pop.step`` it lies in (shared by every span of that step; None outside
a step), the thread, start and end from ``time.perf_counter_ns()`` and a
few integer or string attributes.  Records stay in memory until
:func:`take`; nothing is written out while steps run.

Nothing turns tracing on but a caller's :func:`enable`.  Off, ``span``
returns one shared no-op after a single flag test: it records nothing.
On, a span reads the clock twice and touches no tensor: it takes no
device synchronize, so it times the host issuing the work inside it, and
the device may still be running that work when the span ends.  While a
``torch.profiler`` session records, each span also opens
``torch.profiler.record_function(name)``, so the spans stand in the
profiler's trace beside the device operations, on its clock: an idle gap
of the device can be put down to the span that was open.

The spans of a session step, and no others:

==================  ====================================================
``pop.step``        ``service.PopSession.step``, the whole step
                    (``plan_cache``)
``pop.prepare``     ``core/pop.prepare_instance``: plan, build, stack,
                    warm remap, exec resolution
``pop.build``       inside ``pop.prepare``: plan resolution, the
                    sub-LPs' build and stack, the finite check (the
                    interval ``PreparedSolve.build_time_s`` is read from)
``pop.solve_map``   ``core/backends.solve_map``, the whole map step
                    (``lanes``)
``pdhg.setup``      ``core/pdhg.solve_stacked`` from entry to the loop:
                    engine prep, equilibration, power iteration, start
                    iterates, first products
``pdhg.loop``       the loop of ``solve_stacked`` (``chunks``: the loop's
                    turns, ``check_every``; ``captured``: 1 where its
                    chunks replay a CUDA graph, ``replays``: how many)
``pdhg.iterate``    a chunk's step sizes, sum copies and ``check_every``
                    iterations
``pdhg.check``      the rest of the chunk: running averages, candidate
                    choice, KKT, restart and freeze, the new state
``pdhg.capture``    inside ``pdhg.loop``: a chunk captured as a CUDA
                    graph and instantiated (its ``pdhg.iterate`` and
                    ``pdhg.check`` inside, issuing nothing that runs)
``pdhg.replay``     inside ``pdhg.loop``: one launch of the captured
                    chunk's graph
``pdhg.readback``   after the loop: the final KKT, unscaling and the
                    host copies of the result
``pop.finish``      ``core/pop.finish_prepared``: reduce and assemble
==================  ====================================================

The host's wait at the loop's one flag read a chunk is the self time of
``pdhg.loop`` (:func:`self_ns`): its duration less what its children
cover.  Where the chunks replay a graph, the host issues a chunk in one
launch and the wait is the device's time for it.  Two sessions stepped on two threads give two disjoint trees.
The dispatcher's coalesced map step (``service.MicroBatchDispatcher``)
runs on its own thread: its ``pop.solve_map`` there has no parent and no
step id.
"""

from __future__ import annotations

import collections
import itertools
import threading
from time import perf_counter_ns
from typing import NamedTuple, Optional

import torch

__all__ = ["SpanRecord", "span", "timed", "enable", "disable", "enabled",
           "take", "self_ns"]

STEP = "pop.step"

_on = False
# finished spans as plain tuples (appends and pops of a deque are atomic)
_records: collections.deque = collections.deque()
_ids = itertools.count(1)
_local = threading.local()
_get_ident = threading.get_ident
_profiling = torch._C._autograd._profiler_enabled


class SpanRecord(NamedTuple):
    name: str
    id: int
    parent: Optional[int]
    step: Optional[int]
    thread: int
    start_ns: int
    end_ns: int
    attrs: dict

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns


class _Off:
    """The shared span of a recorder that is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "attrs", "record", "id", "parent", "step",
                 "start_ns", "end_ns", "_stack", "_mirror")

    def __init__(self, name: str, attrs: dict, record: bool):
        self.name, self.attrs, self.record = name, attrs, record

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def __enter__(self):
        if self.record:
            self._stack = stack = _stack()
            self.id = next(_ids)
            if stack:
                top = stack[-1]
                self.parent, self.step = top.id, top.step
            else:
                self.parent, self.step = None, None
            if self.name == STEP:
                self.step = self.id
            stack.append(self)
            self._mirror = None
            if _profiling():
                self._mirror = torch.profiler.record_function(self.name)
                self._mirror.__enter__()
        self.start_ns = perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = perf_counter_ns()
        if self.record:
            if self._mirror is not None:
                self._mirror.__exit__(*exc)
            self._stack.pop()
            _records.append((self.name, self.id, self.parent, self.step,
                             _get_ident(), self.start_ns, self.end_ns,
                             self.attrs))
        return False


def span(name: str, **attrs):
    """A context manager recording ``name`` while the recorder is on, the
    shared no-op while it is off."""
    if not _on:
        return _OFF
    return _Span(name, attrs, True)


def timed(name: str, **attrs) -> _Span:
    """A span that reads the clock whether or not the recorder is on
    (``.seconds`` once it has closed) and records like :func:`span` while
    it is: for a time the program keeps itself, one timing, not two."""
    return _Span(name, attrs, _on)


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def take() -> list:
    """The :class:`SpanRecord` of every span that ended since the last
    call, in the order they ended."""
    out = []
    while True:
        try:
            out.append(SpanRecord._make(_records.popleft()))
        except IndexError:
            return out


def self_ns(records) -> dict:
    """Each record's duration less what its children among ``records``
    cover, by id (a thread's spans nest, so children never overlap)."""
    out = {r.id: r.ns for r in records}
    for r in records:
        if r.parent in out:
            out[r.parent] -= r.ns
    return out
