"""The domain registry: name -> :class:`~repro_torch.domains.base.DomainSpec`
(the port of ``repro/domains/registry.py``)."""

from __future__ import annotations

from typing import Any, Dict, Optional

from .base import DomainSpec

_REGISTRY: Dict[str, DomainSpec] = {}


def register(spec: DomainSpec, *, replace: bool = False) -> DomainSpec:
    """Add ``spec`` under ``spec.name`` (re-registering a name needs
    ``replace=True``)."""
    if not replace and spec.name in _REGISTRY:
        raise ValueError(f"domain {spec.name!r} is already registered "
                         "(pass replace=True to override)")
    _REGISTRY[spec.name] = spec
    return spec


def get(name: str) -> DomainSpec:
    if name not in _REGISTRY:
        raise KeyError(f"unknown domain {name!r}; registered: "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]


def names() -> tuple:
    return tuple(sorted(_REGISTRY))


def spec_for(instance: Any) -> Optional[DomainSpec]:
    """Infer the domain of ``instance`` from registered ``instance_types``
    (most-derived match wins; None when nothing matches)."""
    best: Optional[DomainSpec] = None
    best_depth = -1
    for spec in _REGISTRY.values():
        for t in spec.instance_types:
            if isinstance(instance, t):
                depth = len(type(instance).__mro__) - len(t.__mro__)
                if best is None or depth < best_depth:
                    best, best_depth = spec, depth
    return best
