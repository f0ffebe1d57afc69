"""Rule ``host-sync-in-hot-path``: no device->host sync reachable from the
solver's inner loop — the port of ``repro/analysis/hotpath.py``.

Every ``.item()``, ``.cpu()``, ``.numpy()``, ``.tolist()``, ``bool()`` /
``float()`` / ``int()`` of a torch call, ``np.asarray`` / ``np.array``,
``synchronize()`` or Python branch on a torch call inside ``solve_stacked``
or the map backends blocks the host until the card drains its queue: the
host stops issuing launches, which is the port's bottleneck (PERF.md §5).
The rule walks an approximate call graph DOWNWARD from the hot roots
(functions named ``solve_stacked``, plus any def marked ``# popcheck:
hot`` on or above its ``def`` line — the map backends are) and flags those
constructs in any function it reaches.

The call graph is name-based and deliberately approximate: a call
``f(...)`` or ``obj.f(...)`` reaches every *followable* def named ``f``.
Followable files are the solver substrate (``core/`` and ``kernels/``
under ``src/repro_torch``) plus any scanned file outside the package and
outside the default roots (fixture corpora, ad-hoc scans): the service,
domain and example layers run before and after the solve on the host,
where syncs are the point, so propagation stops at that boundary.

The syncs the loop takes by design — the chunk check and the result
readback — stand in ``popcheck_torch_baseline.json`` with their reason in
``docs/LINTS_torch.md``; :mod:`.runtime` counts them apart at run time.
"""

from __future__ import annotations

import ast
from collections import deque
from pathlib import Path
from typing import Dict, List, Set, Tuple

from .core import FileContext, Finding, Project, rule

RULE = "host-sync-in-hot-path"

HOT_ROOT_NAMES = {"solve_stacked"}

# numpy calls that read a tensor back to the host
_NUMPY_DOORS = {"numpy.asarray", "numpy.array"}
# tensor methods that read a tensor back to the host
_READBACK_METHODS = {
    "item": ".item() forces a device->host sync",
    "cpu": ".cpu() copies to the host (a device->host sync)",
    "numpy": ".numpy() reads the tensor on the host",
    "tolist": ".tolist() copies to the host (a device->host sync)",
}
# torch namespaces whose calls are host-side queries, not tensor compute,
# and torch calls that build host objects (a device, a dtype, a shape)
_HOST_QUERY_PREFIXES = ("torch.cuda.", "torch.distributed.",
                        "torch.backends.", "torch._C.")
_HOST_OBJECTS = {"device", "dtype", "Size", "finfo", "iinfo"}


def _followable(ctx: FileContext) -> bool:
    parts = Path(ctx.rel).parts
    for i in range(len(parts) - 1):
        if parts[i] == "src" and parts[i + 1] == "repro_torch":
            return "core" in parts or "kernels" in parts
    return not (parts[:1] == ("examples_torch",)
                or parts[-1:] == ("chip_smoke.py",))


def _function_defs(ctx: FileContext):
    """Every (possibly nested / method) def in the file."""
    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _calls(fn: ast.AST) -> List[Tuple[str, str]]:
    """``(name, receiver)`` of every call in ``fn``, sorted: ``f(...)``
    gives ``("f", "")``, ``obj.f(...)`` gives ``("f", "obj")`` when ``obj``
    is a bare name, else ``("f", ".")``."""
    out = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Name):
                out.add((f.id, ""))
            elif isinstance(f, ast.Attribute):
                recv = f.value.id if isinstance(f.value, ast.Name) else "."
                out.add((f.attr, recv))
    return sorted(out)


def _module_file(dotted: str, files: Dict[str, FileContext]):
    """The scanned file of module ``dotted`` (absolute, or relative with
    its dots dropped: ``kernels.ops``), matched by path suffix."""
    tail = "/" + dotted.replace(".", "/")
    for rel, ctx in files.items():
        if rel.endswith(tail + ".py") or rel.endswith(tail + "/__init__.py"):
            return ctx
    return None


class _Graph:
    """Name-based call edges, narrowed where Python's scoping decides: a
    bare call reaches a def nested in the caller, else the caller file's
    module-level def of that name; ``mod.f(...)`` through a module alias
    reaches that module's def.  Everything else reaches every followable
    def of the name."""

    def __init__(self, ctxs: List[FileContext]):
        self.index: Dict[str, List[Tuple[FileContext, ast.AST]]] = {}
        self.top: Dict[str, Dict[str, ast.AST]] = {}
        self.files = {ctx.rel: ctx for ctx in ctxs}
        for ctx in ctxs:
            self.top[ctx.rel] = {
                n.name: n for n in ctx.tree.body
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
            for fn in _function_defs(ctx):
                self.index.setdefault(fn.name, []).append((ctx, fn))

    def targets(self, ctx: FileContext, fn: ast.AST, name: str, recv: str):
        if recv == "":
            nested = [n for n in ast.walk(fn) if n is not fn and isinstance(
                n, (ast.FunctionDef, ast.AsyncFunctionDef)) and n.name == name]
            if nested:
                return [(ctx, n) for n in nested]
            top = self.top.get(ctx.rel, {}).get(name)
            if top is not None:
                return [(ctx, top)]
        elif recv != "." and recv in ctx.module_aliases:
            mod = _module_file(ctx.module_aliases[recv], self.files)
            if mod is not None:
                top = self.top[mod.rel].get(name)
                return [(mod, top)] if top is not None else []
        return self.index.get(name, [])


def _is_torch_compute(call: ast.Call, ctx: FileContext) -> bool:
    """A call through a torch alias that computes on tensors
    (``torch.any(...)``), not a host-side query (``torch.cuda.
    is_available()``, ``torch.is_tensor(x)``)."""
    name = ctx.resolve(call.func)
    if not (name == "torch" or name.startswith("torch.")):
        return False
    leaf = name.rpartition(".")[2]
    return not (name.startswith(_HOST_QUERY_PREFIXES)
                or leaf.startswith(("is_", "get_")) or leaf in _HOST_OBJECTS)


def _mentions_torch_call(expr: ast.AST, ctx: FileContext) -> bool:
    return any(isinstance(node, ast.Call) and _is_torch_compute(node, ctx)
               for node in ast.walk(expr))


def _walk_with_def(fn: ast.AST):
    """``(node, name of the innermost def holding it)`` over ``fn``, nested
    defs included (a helper passed by reference, not called by name, is
    still part of its parent's work)."""
    stack = [(fn, fn.name)]
    while stack:
        node, owner = stack.pop()
        yield node, owner
        for child in ast.iter_child_nodes(node):
            inner = (child.name if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)) else owner)
            stack.append((child, inner))


def _violations_in(fn: ast.AST, ctx: FileContext, via: str) -> List[Finding]:
    out = []

    def flag(node, msg):
        out.append(Finding(RULE, ctx.rel, node.lineno,
                           f"in {owner}: {msg} [hot via {via}]"))

    for node, owner in _walk_with_def(fn):
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute):
                after_cpu = (f.attr == "numpy"
                             and isinstance(f.value, ast.Call)
                             and isinstance(f.value.func, ast.Attribute)
                             and f.value.func.attr == "cpu")
                if after_cpu:
                    continue    # x.cpu().numpy(): one readback, at .cpu()
                if f.attr in _READBACK_METHODS and not (
                        f.attr == "item" and node.args):
                    flag(node, _READBACK_METHODS[f.attr])
                elif f.attr == "synchronize":
                    flag(node, "synchronize() stalls the host until the "
                               "card drains its queue")
                elif ctx.resolve(f) in _NUMPY_DOORS:
                    flag(node, f"np.{f.attr}() on (potentially) device data "
                               "forces a host transfer; keep the hot path "
                               "in torch")
            elif isinstance(f, ast.Name) and f.id in ("float", "int", "bool"):
                if node.args and _mentions_torch_call(node.args[0], ctx):
                    flag(node, f"{f.id}() of a torch call reads a tensor "
                               "back to the host (a device->host sync)")
        elif isinstance(node, (ast.If, ast.While)):
            if _mentions_torch_call(node.test, ctx):
                kind = "if" if isinstance(node, ast.If) else "while"
                flag(node, f"Python `{kind}` on a torch expression "
                           "branches on device data (a device->host "
                           "sync); use torch.where")
    return out


@rule(RULE)
def check_hot_path(project: Project) -> List[Finding]:
    ctxs = [ctx for ctx in project.files
            if ctx.tree is not None and _followable(ctx)]
    graph = _Graph(ctxs)
    roots: List[Tuple[FileContext, ast.AST]] = []
    for ctx in ctxs:
        for fn in _function_defs(ctx):
            marked = (fn.lineno in ctx.hot_marker_lines
                      or any(ln in ctx.hot_marker_lines
                             for ln in range(max(1, fn.lineno - 1 - len(
                                 fn.decorator_list)), fn.lineno + 1)))
            if fn.name in HOT_ROOT_NAMES or marked:
                roots.append((ctx, fn))

    # propagate hotness over the call edges, breadth first in name order:
    # each def is reached by its shortest call chain from a root, the same
    # chain every run (the chain is part of the fingerprint)
    hot: Set[int] = set()
    hot_entries: List[Tuple[FileContext, ast.AST, str]] = []
    work = deque((ctx, fn, fn.name) for ctx, fn in roots)
    while work:
        ctx, fn, via = work.popleft()
        if id(fn) in hot:
            continue
        hot.add(id(fn))
        hot_entries.append((ctx, fn, via))
        for name, recv in _calls(fn):
            for tctx, tfn in graph.targets(ctx, fn, name, recv):
                if id(tfn) not in hot:
                    work.append((tctx, tfn, f"{via} -> {name}"))

    findings: List[Finding] = []
    seen = set()
    for ctx, fn, via in hot_entries:
        for f in _violations_in(fn, ctx, via):
            key = (f.path, f.line)
            if key not in seen:
                seen.add(key)
                findings.append(f)
    return findings
