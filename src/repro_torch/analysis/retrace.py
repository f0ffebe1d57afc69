"""Rule ``retrace-hazard``: fresh objects must not reach the builder
caches — the port of ``repro/analysis/retrace.py``.

The map step keys what it builds on *identity and hashability*: the step
engines (``pdhg._memoized`` builders keyed on matvec identity and kernel
plans) and the map solver (``backends.make_map_solver`` over ``(K_mv,
KT_mv, kw_items, engine)``).  Two hazard shapes defeat them:

1. passing a definitely-fresh / unhashable object (a lambda, a list/dict/
   set literal or comprehension) as an argument to a cached builder
   (``functools.lru_cache`` / ``functools.cache`` / ``_memoized``, or the
   ``make_map_solver`` door): either a ``TypeError`` or a guaranteed miss
   per call;
2. compiling or capturing a freshly built callable and running it in the
   same function — ``torch.compile(lambda ...)(x)``, ``fn =
   torch.compile(make()); fn(x)``, ``torch.cuda.make_graphed_callables``
   of a fresh callable, or a ``torch.cuda.CUDAGraph`` built and captured
   (``with torch.cuda.graph(g)``) in the same call, outside a memoized
   builder — which recompiles or recaptures on EVERY invocation.

Builders that RETURN the compiled callable (``return torch.compile(...)``)
are fine — caching is then the caller's contract — and compiles or
captures inside a memoized builder are the blessed pattern.  The POP
path's one capture, the solve loop's chunk (``core/pdhg.solve_stacked``),
is made once a solve by design, through ``capture_begin``: its graph holds
that solve's operator and state, so there is nothing to reuse across
solves.
"""

from __future__ import annotations

import ast
from typing import List, Set

from .core import FileContext, Finding, Project, rule

RULE = "retrace-hazard"

_FRESH_NODES = (ast.Lambda, ast.ListComp, ast.SetComp, ast.DictComp,
                ast.GeneratorExp, ast.List, ast.Dict, ast.Set)
# the cached doors every scan knows, wherever they are defined
_CACHED_DOORS = {"_cached_solver", "make_map_solver"}
# callables that compile or capture what they are given
_WRAPPERS = {"torch.compile", "torch.cuda.make_graphed_callables"}


def _is_cache_decorator(dec: ast.AST) -> bool:
    """functools.lru_cache / functools.cache / pdhg._memoized, bare or
    called."""
    if isinstance(dec, ast.Call):
        dec = dec.func
    name = dec.attr if isinstance(dec, ast.Attribute) else \
        dec.id if isinstance(dec, ast.Name) else ""
    return name in ("lru_cache", "cache", "_memoized")


def _cached_def_names(project: Project) -> Set[str]:
    names = set()
    for ctx in project.files:
        if ctx.tree is None:
            continue
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.FunctionDef) and any(
                    _is_cache_decorator(d) for d in node.decorator_list):
                names.add(node.name)
    return names


def _called_name(call: ast.Call) -> str:
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return ""


def _is_wrap(call: ast.Call, ctx: FileContext) -> bool:
    return ctx.resolve(call.func) in _WRAPPERS


def _is_graph_ctor(call: ast.AST, ctx: FileContext) -> bool:
    return (isinstance(call, ast.Call)
            and ctx.resolve(call.func) == "torch.cuda.CUDAGraph")


def _check_function(ctx: FileContext, fn: ast.FunctionDef,
                    cached_names: Set[str], findings: List[Finding]) -> None:
    if any(_is_cache_decorator(d) for d in fn.decorator_list):
        return  # memoized builder: fresh compiles inside are built once a key

    # names assigned from defs / lambdas / calls inside this function are
    # fresh per invocation
    fresh_local: Set[str] = set()
    graphs: Set[str] = set()   # locals holding a CUDAGraph built here
    for node in ast.walk(fn):
        if isinstance(node, ast.FunctionDef) and node is not fn:
            fresh_local.add(node.name)
        elif isinstance(node, ast.Assign) and isinstance(
                node.value, (ast.Lambda, ast.Call)):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    fresh_local.add(t.id)
                    if _is_graph_ctor(node.value, ctx):
                        graphs.add(t.id)

    compiled_fresh: Set[str] = set()   # locals holding a fresh compile
    for node in ast.walk(fn):
        if isinstance(node, ast.With):
            # (3) a graph built in this call and captured in it
            for item in node.items:
                ce = item.context_expr
                if (isinstance(ce, ast.Call)
                        and ctx.resolve(ce.func) == "torch.cuda.graph"
                        and ce.args
                        and ((isinstance(ce.args[0], ast.Name)
                              and ce.args[0].id in graphs)
                             or _is_graph_ctor(ce.args[0], ctx))):
                    findings.append(Finding(
                        RULE, ctx.rel, node.lineno,
                        "CUDA graph built and captured inside the call — "
                        "recaptures on every invocation; capture once in "
                        "a memoized builder and replay"))
            continue
        if not isinstance(node, ast.Call):
            continue
        # (1) unhashable/fresh args into a cached builder
        if _called_name(node) in cached_names:
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                if isinstance(arg, _FRESH_NODES):
                    findings.append(Finding(
                        RULE, ctx.rel, arg.lineno,
                        f"fresh/unhashable {type(arg).__name__} argument to "
                        f"cached '{_called_name(node)}' — guaranteed "
                        "cache miss (or TypeError) every call"))
        # (2) compile / graph-wrap of a fresh callable, run in the same
        # function
        if _is_wrap(node, ctx) and node.args:
            target = node.args[0]
            fresh = (isinstance(target, (ast.Lambda, ast.Call))
                     or (isinstance(target, ast.Name)
                         and target.id in fresh_local))
            if fresh:
                parent = getattr(node, "_pc_parent", None)
                if isinstance(parent, ast.Call) and parent.func is node:
                    # torch.compile(...)(x): compiled and invoked at once
                    findings.append(Finding(
                        RULE, ctx.rel, node.lineno,
                        "compile/graph capture of a freshly-constructed "
                        "callable invoked in place — rebuilds on every "
                        "call; memoize the builder (functools.lru_cache)"))
                else:
                    for t in _assign_targets(node):
                        compiled_fresh.add(t)
    if compiled_fresh:
        for node in ast.walk(fn):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id in compiled_fresh):
                findings.append(Finding(
                    RULE, ctx.rel, node.lineno,
                    f"'{node.func.id}' holds a per-call compile/graph "
                    "capture of a fresh callable and is invoked here — "
                    "rebuilds on every call; memoize the builder "
                    "(functools.lru_cache)"))


def _assign_targets(value_node: ast.Call) -> List[str]:
    parent = getattr(value_node, "_pc_parent", None)
    if isinstance(parent, ast.Assign) and parent.value is value_node:
        return [t.id for t in parent.targets if isinstance(t, ast.Name)]
    return []


def _link_parents(tree: ast.AST) -> None:
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child._pc_parent = node


@rule(RULE)
def check_retrace(project: Project) -> List[Finding]:
    cached_names = _cached_def_names(project) | _CACHED_DOORS
    findings: List[Finding] = []
    for ctx in project.files:
        if ctx.tree is None:
            continue
        _link_parents(ctx.tree)
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.FunctionDef):
                _check_function(ctx, node, cached_names, findings)
    # dedup (nested defs are walked by their parents too)
    seen, out = set(), []
    for f in findings:
        key = (f.path, f.line, f.message)
        if key not in seen:
            seen.add(key)
            out.append(f)
    return out
