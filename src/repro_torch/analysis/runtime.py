"""Runtime sanitizers: a build counter and a host-sync tripwire — the port
of ``repro/analysis/runtime.py``.

The static rules catch hazard *shapes*; these guards catch the hazards
themselves, at test time, with no instrumentation on the hot path:

:func:`retrace_guard`
    Counts *builds* inside the ``with`` block — cache misses of every
    ``pdhg._memoized`` builder (the step engines and ``make_map_solver``'s
    solver cache, :data:`repro_torch.core.pdhg.MEMOIZED`), map solvers
    built uncached for unhashable keys, kernel libraries compiled or
    loaded by ``kernels/build.py``, and ``torch._dynamo`` graphs where
    dynamo is in use — and raises :class:`RetraceError` when the count
    exceeds ``max_retraces``.  A warm re-solve builds NOTHING: a build
    means a cache key churned (a fresh callable, an unhashable config, a
    new kernel plan).

:func:`host_sync_tripwire`
    Raises :class:`HostSyncError` on a device->host sync on the CURRENT
    thread inside the block, naming the frame that took it.  On the card
    it arms ``torch.cuda.set_sync_debug_mode("warn")`` (process-wide, so
    a refcounted ``warnings.showwarning`` hook decides by the thread
    that warned, and an ``"always"`` filter keeps Python from showing the
    warning once per location only); on the CPU, where no sync exists to
    catch, it patches the doors — ``torch.Tensor.item``/``tolist``/
    ``numpy``/``cpu``/``__bool__``/``__float__``/``__int__`` and
    ``np.asarray``/``np.array`` of a tensor.  The syncs the solve loop
    takes by design (:data:`ALLOWED_SYNC_SITES`: the chunk check and the
    result readback) are counted apart and pass; the CPU counts door
    calls (``_np``'s ``.cpu().numpy()`` is two).

:func:`steady_state_guard`
    The combination the tests and ``chip_smoke.py``'s ``steady`` phase
    use: the build guard over the whole block plus the tripwire scoped to
    the map-step backends (every entry of ``backends.MAP_BACKENDS`` is
    wrapped for the duration, on whichever thread calls it, in the mode
    of the batch's device) — preparing the instance before the solve and
    reducing the result after it are legitimate host work, so the
    tripwire arms only around the hot region.  Yields
    :class:`SanitizerStats`; on exit asserts the build budget and that no
    sync was denied (also one that a caller's ``except`` swallowed).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import re
import sys
import threading
import warnings
from pathlib import Path
from typing import Iterator, Optional

import numpy as np
import torch

__all__ = ["RetraceError", "HostSyncError", "SanitizerStats",
           "ALLOWED_SYNC_SITES", "retrace_guard", "host_sync_tripwire",
           "steady_state_guard"]

# The syncs the solve loop takes by design: (file, function, kind), the
# function being the innermost frame of the package when the sync happens.
# Each is a baselined host-sync-in-hot-path finding whose reason
# docs/LINTS_torch.md gives (tests/test_torch_steady_state.py holds the two
# lists equal).
ALLOWED_SYNC_SITES = (
    # the one test a check_every chunk: any lane still running?
    ("src/repro_torch/core/pdhg.py", "solve_stacked", "chunk_check"),
    # the SolveResult fields read back once the loop ends
    ("src/repro_torch/core/pdhg.py", "_np", "readback"),
)

_PKG = Path(__file__).resolve().parents[1]
_HERE = Path(__file__).resolve()
_SYNC_MSG = "called a synchronizing CUDA operation"
_CPU_DOORS = ("item", "tolist", "numpy", "cpu", "__bool__", "__float__",
              "__int__")


class RetraceError(AssertionError):
    """Something was built inside a region declared steady-state."""


class HostSyncError(AssertionError):
    """A device->host sync happened inside the guarded hot region."""


@dataclasses.dataclass
class SanitizerStats:
    """What the guards observed (filled as the block runs, readable after
    the ``with`` block exits)."""

    builds: int = 0
    built_names: list = dataclasses.field(default_factory=list)
    hot_backend_calls: int = 0
    chunk_checks: int = 0
    readbacks: int = 0
    syncs_denied: int = 0
    denied_sites: list = dataclasses.field(default_factory=list)
    # the tripwire modes that armed: "cuda" (the debug mode), "cpu" (doors)
    modes: set = dataclasses.field(default_factory=set)
    # held by every thread counting into these stats (the dispatcher's
    # worker and the callers' threads)
    lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)

    @property
    def syncs_allowed(self) -> int:
        return self.chunk_checks + self.readbacks


# --------------------------------------------------------------------------
# builds
# --------------------------------------------------------------------------

def _build_state() -> dict:
    """Everything a build changes, read without touching the hot path."""
    from ..core import backends, pdhg
    from ..kernels import build
    state = {f"{fn.__module__}.{fn.__qualname__}": fn.cache_info().misses
             for fn in pdhg.MEMOIZED}
    state["uncached map solver"] = backends.UNCACHED_SOLVERS
    for name in build._libs:
        state[f"kernel library load {name}"] = 1
    for name, info in build.build_info.items():
        state[f"nvcc {name}"] = id(info)
    dynamo = sys.modules.get("torch._dynamo.utils")
    if dynamo is not None:
        state["torch._dynamo graphs"] = (
            dynamo.counters["stats"]["unique_graphs"])
    return state


def _builds_between(before: dict, after: dict) -> list:
    """The names of the builds between two :func:`_build_state` reads, one
    entry a build."""
    out = []
    for key, value in after.items():
        old = before.get(key)
        if key.startswith(("kernel library load", "nvcc")):
            if old != value:
                out.append(key)
        elif value > (old or 0):
            out.extend([key] * (value - (old or 0)))
    return out


@contextlib.contextmanager
def retrace_guard(max_retraces: int = 0,
                  stats: Optional[SanitizerStats] = None
                  ) -> Iterator[SanitizerStats]:
    """Raise :class:`RetraceError` if more than ``max_retraces`` builds
    happen inside the block."""
    stats = stats if stats is not None else SanitizerStats()
    before = _build_state()
    yield stats
    seen = _builds_between(before, _build_state())
    stats.builds += len(seen)
    stats.built_names.extend(seen)
    if len(seen) > max_retraces:
        raise RetraceError(
            f"{len(seen)} build(s) inside a steady-state region (budget "
            f"{max_retraces}): {seen} — a cache key churned (a fresh "
            "callable, an unhashable config or a new kernel plan)")


# --------------------------------------------------------------------------
# the tripwire
# --------------------------------------------------------------------------

_SKIP_DIRS = tuple(Path(m.__file__).resolve().parent for m in (torch, np))
_SKIP_FILES = {_HERE, Path(warnings.__file__).resolve(),
               Path(contextlib.__file__).resolve()}
_resolved: dict = {}


def _where(filename: str):
    """``(resolved path, is in the package, is skipped)`` of a frame's
    file, cached by file name."""
    got = _resolved.get(filename)
    if got is None:
        path = Path(filename).resolve()
        skipped = path in _SKIP_FILES or any(path.is_relative_to(d)
                                             for d in _SKIP_DIRS)
        got = _resolved[filename] = (path, path.is_relative_to(_PKG),
                                     skipped)
    return got


def _site(frame) -> tuple:
    """``(file, function, line)`` of the innermost frame of the package
    (this module aside) on the stack from ``frame`` out, else of the
    innermost frame outside this module, the warnings machinery, torch
    and numpy."""
    first = None
    while frame is not None:
        path, in_pkg, skipped = _where(frame.f_code.co_filename)
        if in_pkg and path != _HERE:
            rel = "src/repro_torch/" + path.relative_to(_PKG).as_posix()
            return rel, frame.f_code.co_name, frame.f_lineno
        if first is None and not skipped:
            first = (path.as_posix(), frame.f_code.co_name, frame.f_lineno)
        frame = frame.f_back
    return first or ("?", "?", 0)


_ALLOWED = {(path, fn): kind for path, fn, kind in ALLOWED_SYNC_SITES}


class _Armed:
    """One armed tripwire block: its mode and the stats it counts into."""

    def __init__(self, mode: str, stats: SanitizerStats):
        self.mode, self.stats = mode, stats


class _TripwireRegistry:
    """Shared state for :func:`host_sync_tripwire` — THREAD-SCOPED arming.

    The guards install process-global hooks (the CUDA sync debug mode and
    a ``warnings.showwarning`` hook; on the CPU patched tensor and numpy
    doors), but a serving dispatcher runs the guarded hot region on a
    worker thread WHILE client threads legitimately read results back.  So
    each mode's hooks install once (refcounted across nested and
    concurrent guards) and deny only on threads currently inside a
    tripwire block of that mode; every other thread falls through."""

    def __init__(self):
        self.lock = threading.RLock()
        self.depth = {"cuda": 0, "cpu": 0}
        self.armed: dict = {}          # thread ident -> [_Armed, ...]
        self.saved: dict = {}
        self.local = threading.local()

    def current(self, mode: str) -> Optional[_Armed]:
        stack = self.armed.get(threading.get_ident())
        if stack and stack[-1].mode == mode:
            return stack[-1]
        return None

    def enter(self, armed: _Armed) -> None:
        with self.lock:
            if self.depth[armed.mode] == 0:
                (self._install_cuda if armed.mode == "cuda"
                 else self._install_cpu)()
            self.depth[armed.mode] += 1
            self.armed.setdefault(threading.get_ident(), []).append(armed)

    def exit(self, armed: _Armed) -> None:
        with self.lock:
            ident = threading.get_ident()
            stack = self.armed.get(ident, [])
            if armed in stack:
                stack.remove(armed)
            if not stack:
                self.armed.pop(ident, None)
            self.depth[armed.mode] -= 1
            if self.depth[armed.mode] == 0:
                (self._restore_cuda if armed.mode == "cuda"
                 else self._restore_cpu)()

    # -- one sync, either mode -----------------------------------------
    def record(self, armed: _Armed, frame, what: str) -> None:
        """Count a sync on an armed thread: an allowed site's by kind, any
        other one as denied (raised here, and again at the guard's exit
        should a caller swallow it)."""
        path, fn, line = _site(frame)
        kind = _ALLOWED.get((path, fn))
        st = armed.stats
        with st.lock:
            if kind == "chunk_check":
                st.chunk_checks += 1
            elif kind == "readback":
                st.readbacks += 1
            else:
                st.syncs_denied += 1
                st.denied_sites.append(f"{what} at {path}:{line} in {fn}")
        if kind is None:
            raise HostSyncError(
                f"{what} at {path}:{line} in {fn} inside the guarded hot "
                "region forces a device->host sync; keep the map step on "
                "the device and read back only at its boundary "
                f"(allowed sites: {ALLOWED_SYNC_SITES})")

    # -- the card: sync debug mode + a warnings hook ------------------
    def _install_cuda(self) -> None:
        prev_mode = torch.cuda.get_sync_debug_mode()
        prev_show = warnings.showwarning
        warnings.filterwarnings("always", message=".*" + re.escape(_SYNC_MSG))
        entry = warnings.filters[0]
        registry = self

        def showwarning(message, category, filename, lineno, file=None,
                        line=None):
            if _SYNC_MSG not in str(message):
                if prev_show is warnings._showwarning_orig:
                    warnings._showwarnmsg_impl(warnings.WarningMessage(
                        message, category, filename, lineno, file, line))
                else:
                    prev_show(message, category, filename, lineno, file,
                              line)
                return
            armed = registry.current("cuda")
            if armed is not None:      # other threads' syncs pass silently
                registry.record(armed, sys._getframe(1),
                                "a synchronizing CUDA operation")

        warnings.showwarning = showwarning
        torch.cuda.set_sync_debug_mode("warn")
        self.saved["cuda"] = (prev_mode, prev_show, showwarning, entry)

    def _restore_cuda(self) -> None:
        prev_mode, prev_show, hook, entry = self.saved.pop("cuda")
        torch.cuda.set_sync_debug_mode(prev_mode)
        if warnings.showwarning is hook:
            warnings.showwarning = prev_show
        for i, f in enumerate(warnings.filters):
            if f is entry:
                del warnings.filters[i]
                warnings._filters_mutated()
                break

    # -- the CPU: patched doors ----------------------------------------
    def _guard(self, what: str, orig, applies=lambda *a: True):
        registry = self

        @functools.wraps(orig)
        def guarded(*args, **kw):
            armed = registry.current("cpu")
            if (armed is not None and applies(*args)
                    and not getattr(registry.local, "inside", False)):
                registry.record(armed, sys._getframe(1), what)
            # a door inside a door (np.asarray -> Tensor.__array__ ->
            # numpy) is one sync
            outer = getattr(registry.local, "inside", False)
            registry.local.inside = True
            try:
                return orig(*args, **kw)
            finally:
                registry.local.inside = outer
        return guarded

    def _install_cpu(self) -> None:
        saved = {}
        for name in _CPU_DOORS:
            saved[name] = torch.Tensor.__dict__.get(name)
            setattr(torch.Tensor, name,
                    self._guard(f"Tensor.{name}", getattr(torch.Tensor,
                                                          name)))
        is_tensor = lambda a, *rest: isinstance(a, torch.Tensor)
        np_orig = (np.asarray, np.array)
        np.asarray = self._guard("np.asarray(Tensor)", np_orig[0], is_tensor)
        np.array = self._guard("np.array(Tensor)", np_orig[1], is_tensor)
        self.saved["cpu"] = (saved, np_orig)

    def _restore_cpu(self) -> None:
        saved, (np.asarray, np.array) = self.saved.pop("cpu")
        for name, orig in saved.items():
            if orig is None:
                delattr(torch.Tensor, name)
            else:
                setattr(torch.Tensor, name, orig)


_TRIPWIRE = _TripwireRegistry()


@contextlib.contextmanager
def host_sync_tripwire(mode: Optional[str] = None,
                       stats: Optional[SanitizerStats] = None
                       ) -> Iterator[SanitizerStats]:
    """Deny device->host syncs on the CURRENT thread for the duration of
    the block (the allowed sites counted into ``stats``).  ``mode`` is
    "cuda" (the sync debug mode; the default where a card is present) or
    "cpu" (the patched doors; the default without one).  Arming is
    per-thread and composes across concurrent guards (see
    :class:`_TripwireRegistry`)."""
    if mode is None:
        mode = "cuda" if torch.cuda.is_available() else "cpu"
    if mode not in ("cuda", "cpu"):
        raise ValueError(f"unknown tripwire mode {mode!r}")
    if mode == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the CUDA tripwire needs a CUDA device")
    stats = stats if stats is not None else SanitizerStats()
    armed = _Armed(mode, stats)
    stats.modes.add(mode)
    _TRIPWIRE.enter(armed)
    try:
        yield stats
    finally:
        _TRIPWIRE.exit(armed)


@contextlib.contextmanager
def steady_state_guard(max_retraces: int = 0) -> Iterator[SanitizerStats]:
    """Assert a block builds nothing anywhere and takes no host sync inside
    the map-step backends beyond :data:`ALLOWED_SYNC_SITES`."""
    from ..core import backends as backends_mod

    stats = SanitizerStats()
    saved = dict(backends_mod.MAP_BACKENDS)

    def wrap(fn):
        @functools.wraps(fn)
        def run(batch, *args, **kw):
            with stats.lock:
                stats.hot_backend_calls += 1
            mode = "cuda" if batch[0].c.is_cuda else "cpu"
            with host_sync_tripwire(mode, stats):
                return fn(batch, *args, **kw)
        return run

    for name, fn in saved.items():
        backends_mod.MAP_BACKENDS[name] = wrap(fn)
    try:
        with retrace_guard(max_retraces, stats=stats):
            yield stats
    finally:
        backends_mod.MAP_BACKENDS.clear()
        backends_mod.MAP_BACKENDS.update(saved)
    if stats.syncs_denied:
        raise HostSyncError(
            f"{stats.syncs_denied} host sync(s) denied inside the map-step "
            f"backends: {stats.denied_sites}")
