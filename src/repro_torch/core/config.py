"""Frozen, hashable configuration for the POP pipeline (a copy of
``repro/core/config.py`` validated against this package's own
``backends.MAP_BACKENDS``, ``pdhg.ENGINE_NAMES`` and
``pdhg.SOLVER_KW_NAMES``).

The public surface used to thread a dozen loose kwargs (``strategy=``,
``k=``, ``backend=``, ``engine=``, ``solver_kw=``, ``backend_opts=``, ...)
through every entry point.  These two dataclasses collapse that soup:

:class:`SolveConfig`
    WHAT split to solve — k, partition strategy, replication — the inputs
    of the planning stage (``pop.plan``).

:class:`ExecConfig`
    HOW to execute it — map-step backend, PDHG step engine, solver
    keywords, backend options — the inputs of the solve stage
    (``backends.solve_map``).

Both are validated eagerly at construction (an unknown backend name or a
misspelled solver keyword fails where the config is *written*, not three
layers down inside a solve) and are hashable, so they can key caches
directly.  Dict-valued inputs (``solver_kw``,
``backend_opts``) are frozen into sorted item tuples automatically —
``ExecConfig(solver_kw={"max_iters": 100})`` works and hashes.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Optional, Tuple, Union

__all__ = ["SolveConfig", "ExecConfig", "validate_cache_key"]


def _check_cache_key(cfg) -> None:
    """Construction-time ``__hash__``/``__eq__`` consistency check.

    These configs key caches directly, so an unhashable field
    value (or a hash that disagrees with equality) must fail where the
    config is WRITTEN, not as a silent per-call cache miss three layers
    down.  An equal reconstruction (``dataclasses.replace`` with no
    changes — which re-runs validation and field freezing) must compare
    equal and hash identically; this also covers subclasses that add
    fields (``tests/test_config_keys.py``)."""
    if getattr(_CHECKING, "active", False):
        return   # the reconstruction below re-enters __post_init__
    _CHECKING.active = True
    try:
        try:
            h = hash(cfg)
        except TypeError as e:
            raise TypeError(
                f"{type(cfg).__name__} must stay hashable — it keys the "
                f"caches ({e}); pass hashable field values "
                "(dicts are frozen automatically)") from e
        twin = dataclasses.replace(cfg)
        if twin != cfg or hash(twin) != h:
            raise ValueError(
                f"{type(cfg).__name__} hash/eq are inconsistent: an equal "
                "reconstruction produced a different cache key — field "
                "freezing in __post_init__ must be idempotent")
    finally:
        _CHECKING.active = False


_CHECKING = threading.local()

# public alias: config-like frozen dataclasses OUTSIDE this module get the
# same construction-time hash/eq gate
validate_cache_key = _check_cache_key


def _freeze_items(value: Any, field: str) -> Tuple:
    """dict -> sorted item tuple; tuples pass through; reject the rest."""
    if value is None:
        return ()
    if isinstance(value, dict):
        return tuple(sorted(value.items()))
    if isinstance(value, tuple):
        return value
    raise TypeError(f"{field} must be a dict or an item tuple, "
                    f"got {type(value).__name__}")


@dataclasses.dataclass(frozen=True)
class SolveConfig:
    """The planning-stage config: how the problem is split.

    ``k`` is the requested sub-problem count; ``min_per_sub``, when set,
    clamps it so every sub-problem keeps at least that many entities
    (``k_for(n)`` — small instances then degrade toward the k=1 full
    solve instead of over-splitting).  ``strategy`` names a partition
    strategy from ``core/partition.py``; ``replicate_threshold`` enables
    §4.3 hot-entity replication.
    """

    k: int = 4
    strategy: str = "stratified"
    seed: int = 0
    replicate_threshold: Optional[float] = None
    min_per_sub: Optional[int] = None

    def __post_init__(self):
        from .partition import STRATEGIES
        if not isinstance(self.k, int) or self.k < 1:
            raise ValueError(f"k must be an int >= 1, got {self.k!r}")
        if self.strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {self.strategy!r}; expected "
                             f"one of {STRATEGIES}")
        if self.replicate_threshold is not None and self.replicate_threshold <= 0:
            raise ValueError("replicate_threshold must be positive or None, "
                             f"got {self.replicate_threshold!r}")
        if self.min_per_sub is not None and self.min_per_sub < 1:
            raise ValueError(f"min_per_sub must be >= 1 or None, "
                             f"got {self.min_per_sub!r}")
        _check_cache_key(self)

    def k_for(self, n_entities: int) -> int:
        """Effective k for an instance of ``n_entities`` (1 = full solve)."""
        if self.min_per_sub is None:
            return max(1, min(self.k, n_entities))
        return max(1, min(self.k, n_entities // self.min_per_sub))


@dataclasses.dataclass(frozen=True)
class ExecConfig:
    """The execution-stage config: how the stacked solve runs.

    ``backend`` names a map-step backend (``core/backends.py`` registry,
    ``"auto"`` selects by k/devices/size); ``engine`` a PDHG step engine
    (``core/pdhg.py``: ``"auto"``/``"matvec"``/``"fused_structured"``/
    ``"fused_structured_full"`` or a
    :class:`~repro_torch.core.pdhg.StepEngine`; ``"fused"`` validates but
    is not ported yet).
    ``solver_kw`` keys are validated against the solver signature
    (``pdhg.SOLVER_KW_NAMES``).  The *resolved* backend/engine that
    actually ran are reported on every :class:`~repro_torch.core.pop.POPResult`
    / :class:`~repro_torch.service.Allocation` — ``"auto"`` is a request, not
    an answer.
    """

    backend: str = "auto"
    engine: Any = "auto"
    solver_kw: Union[dict, tuple] = ()
    backend_opts: Union[dict, tuple] = ()

    def __post_init__(self):
        from . import backends as backends_mod
        from . import pdhg
        object.__setattr__(self, "solver_kw",
                           _freeze_items(self.solver_kw, "solver_kw"))
        object.__setattr__(self, "backend_opts",
                           _freeze_items(self.backend_opts, "backend_opts"))
        if self.backend != "auto" and self.backend not in backends_mod.MAP_BACKENDS:
            raise ValueError(
                f"unknown backend {self.backend!r}; expected 'auto' or one "
                f"of {sorted(backends_mod.MAP_BACKENDS)}")
        if not isinstance(self.engine, pdhg.StepEngine) and \
                self.engine not in pdhg.ENGINE_NAMES:
            raise ValueError(
                f"unknown engine {self.engine!r}; expected one of "
                f"{pdhg.ENGINE_NAMES} or a StepEngine")
        bad = [k for k, _ in self.solver_kw if k not in pdhg.SOLVER_KW_NAMES]
        if bad:
            raise ValueError(
                f"unknown solver_kw key(s) {bad}; the solver accepts "
                f"{sorted(pdhg.SOLVER_KW_NAMES)}")
        _check_cache_key(self)

    def solver_dict(self) -> dict:
        return dict(self.solver_kw)

    def opts_dict(self) -> dict:
        return dict(self.backend_opts)
