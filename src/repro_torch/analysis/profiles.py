"""Tuning-profile hygiene rules — the port of
``repro/analysis/profiles.py``.

``profile-staleness``
    A :class:`~repro_torch.tuning.TuningProfile` is a *measurement
    artifact*: it encodes quality/latency curves for one profile-format
    version, sealed by a content digest.  ``load_profile`` deliberately
    does NOT validate — ``check_profile`` is the gate that rejects a
    stale format version, a hand-edited (digest-mismatched) file, or a
    profile measured on a different platform.  Code that loads a profile
    and never checks it will happily tune the service from garbage.

    The rule flags every resolved call to ``load_profile`` (imported
    from ``repro_torch.tuning`` / ``repro_torch.tuning.profile``, directly
    or via a module alias) in a function or module scope that contains no
    ``check_profile`` call.  ``check_profile(load_profile(path))`` is
    the idiomatic clean form.  The defining module
    (``tuning/profile.py``) is exempt — findings there would be the
    implementation itself.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional

from .core import FileContext, Finding, Project, rule

_PROFILE_MODULES = {"repro_torch.tuning", "repro_torch.tuning.profile"}
_LOADER = "load_profile"
_CHECKER = "check_profile"

_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)


def _resolved_call(ctx: FileContext, func: ast.AST) -> Optional[str]:
    """The tuning-door function a call's func node resolves to
    (``load_profile``/``check_profile``), or None.  Mirrors the
    deprecated-door resolution: names imported from the tuning modules
    (asname-aware via the recorded origin) and attribute access on a
    tuning module alias; a ``load_profile`` *method* on some unrelated
    object is not flagged."""
    if isinstance(func, ast.Name):
        origin = ctx.imported_names.get(func.id, "")
        base, _, leaf = origin.rpartition(".")
        if base in _PROFILE_MODULES and leaf in (_LOADER, _CHECKER):
            return leaf
    elif isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name):
        alias = ctx.module_aliases.get(func.value.id, "")
        if alias in _PROFILE_MODULES and func.attr in (_LOADER, _CHECKER):
            return func.attr
    return None


def _scope_nodes(tree: ast.AST) -> Iterator[ast.AST]:
    """Every scope the rule reasons over: the module plus each function
    (methods included), innermost scopes owning their own calls."""
    yield tree
    for node in ast.walk(tree):
        if isinstance(node, _FUNCS):
            yield node


def _iter_scope(scope: ast.AST) -> Iterator[ast.AST]:
    """Nodes belonging to ``scope`` without descending into nested
    function scopes (a helper that checks is its own scope)."""
    stack = list(getattr(scope, "body", []))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, _FUNCS):
            stack.extend(ast.iter_child_nodes(node))


@rule("profile-staleness")
def check_profile_staleness(project: Project) -> List[Finding]:
    findings = []
    for ctx in project.files:
        if ctx.tree is None or ctx.rel.endswith("tuning/profile.py"):
            continue
        if _LOADER not in ctx.text:
            continue
        for scope in _scope_nodes(ctx.tree):
            loads: List[ast.Call] = []
            checked = False
            for node in _iter_scope(scope):
                if not isinstance(node, ast.Call):
                    continue
                resolved = _resolved_call(ctx, node.func)
                if resolved == _LOADER:
                    loads.append(node)
                elif resolved == _CHECKER:
                    checked = True
            if checked:
                continue
            for call in loads:
                findings.append(Finding(
                    "profile-staleness", ctx.rel, call.lineno,
                    "load_profile without check_profile in the same scope "
                    "— a stale or hand-edited TuningProfile (version/digest "
                    "mismatch) silently tunes the service; wrap the read: "
                    "check_profile(load_profile(path))"))
    return findings
