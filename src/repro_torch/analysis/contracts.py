"""Contract rules: deprecated doors, dtype promotion, registry hooks,
config hashability, silent excepts — the port of
``repro/analysis/contracts.py`` with ``repro_torch`` module names.

``deprecated-door``
    Internal code must go through the one public surface (``solve_instance``
    / ``solve_full_ex`` / ``PopService`` sessions), not the kept-for-compat
    forwarders: module-level ``pop_solve`` / ``solve_full`` (tuple form),
    ``GavelScheduler``, ``serve.balance_requests``.  Method calls named
    ``pop_solve``/``solve_full`` on problem objects
    (``LoadBalanceProblem.pop_solve``) are the problem's OWN surface and
    are not flagged — only calls through a ``repro_torch.core``/
    ``repro_torch.core.pop`` module alias or a name imported from there.

``dtype-promotion``
    The kernels and their plain versions are f32 end to end (the CUDA
    sources take ``float*``); a stray ``torch.float64``/``torch.double``/
    ``np.float64`` (or ``.double()``) in ``kernels/`` doubles every buffer
    and fails the wrappers' dtype checks, and ``torch.set_default_dtype(
    torch.float64)`` anywhere turns every fresh tensor f64.  Scoped to
    ``kernels/`` files (plus the default-dtype flip anywhere).

``registry-contract``
    Statically mirrors (and extends) ``DomainSpec.__post_init__``: a spec
    must pick exactly one fill style.  Flags (a) specs with none of
    ``problem=`` / ``step_override=`` / the six declarative hooks, (b)
    ``step_override`` combined with pipeline hooks the override silently
    ignores, (c) ``problem=`` combined with declarative builder hooks
    (two conflicting fill styles).

``config-hashability``
    Frozen config dataclasses key the jit/plan caches, so every field must
    stay hashable: flags dict/list/set/ndarray-annotated fields of
    ``@dataclass(frozen=True)`` classes that are not re-frozen in
    ``__post_init__``, and any class defining ``__eq__`` without
    ``__hash__`` (Python then silently sets ``__hash__ = None``).

``silent-except``
    The fault-tolerant serving layer (docs/ROBUSTNESS.md) turns every
    caught exception into a recorded fault — an ``except`` that swallows
    silently hides exactly the divergence/deadline/corruption events the
    ladder exists to count.  Flags, inside ``core/`` and ``service.py``
    of ``src/repro_torch``:
    bare ``except:`` (catches ``KeyboardInterrupt``/``SystemExit`` too),
    and ``except Exception:`` / ``except BaseException:`` whose body is
    only ``pass``/``...``.  Typed handlers (``except ValueError: pass``)
    and broad handlers that record/re-raise are fine.
"""

from __future__ import annotations

import ast
from typing import List, Set

from .core import Finding, Project, rule

_DOOR_MODULES = {"repro_torch.core", "repro_torch.core.pop",
                 "repro_torch.sched", "repro_torch.sched.gavel_service",
                 "repro_torch.serve", "repro_torch.serve.engine"}
_DOOR_NAMES = {
    "pop_solve": "pop.solve_instance(problem, SolveConfig, ExecConfig) or a "
                 "PopService session",
    "solve_full": "pop.solve_full_ex(problem, exec_cfg=...)",
    "GavelScheduler": "repro_torch.service.PopService().session("
                      "domain='gavel')",
    "balance_requests": "repro_torch.service.PopService().session("
                        "domain='load_balance')",
}
# modules that DEFINE the doors (the forwarders themselves + their tests
# live outside the scan roots); findings there are the implementation
_DOOR_DEFINING = ("src/repro_torch/core/pop.py", "src/repro_torch/sched/",
                  "src/repro_torch/serve/")


@rule("deprecated-door")
def check_deprecated_door(project: Project) -> List[Finding]:
    findings = []
    for ctx in project.files:
        if ctx.tree is None or ctx.rel.startswith(_DOOR_DEFINING):
            continue
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            name, hit = None, False
            if isinstance(f, ast.Name) and f.id in _DOOR_NAMES:
                origin = ctx.imported_names.get(f.id, "")
                hit = origin.rpartition(".")[0] in _DOOR_MODULES
                name = f.id
            elif (isinstance(f, ast.Attribute) and f.attr in _DOOR_NAMES
                  and isinstance(f.value, ast.Name)):
                # only module-alias calls: pop.solve_full(...), not
                # prob.solve_full(...) (the problem's own method)
                alias = ctx.module_aliases.get(f.value.id, "")
                hit = alias in _DOOR_MODULES
                name = f.attr
            if hit:
                findings.append(Finding(
                    "deprecated-door", ctx.rel, node.lineno,
                    f"call to deprecated forwarder '{name}'; use "
                    f"{_DOOR_NAMES[name]}"))
    return findings


_F64_TOKENS = {"float64", "double"}


def _is_default_dtype_flip(node: ast.AST) -> bool:
    """``torch.set_default_dtype(<a float64 dtype>)``."""
    if not (isinstance(node, ast.Call) and node.args):
        return False
    f = node.func
    name = f.attr if isinstance(f, ast.Attribute) else \
        f.id if isinstance(f, ast.Name) else ""
    arg = node.args[0]
    token = arg.attr if isinstance(arg, ast.Attribute) else \
        arg.value if isinstance(arg, ast.Constant) else None
    return name == "set_default_dtype" and token in _F64_TOKENS


@rule("dtype-promotion")
def check_dtype(project: Project) -> List[Finding]:
    findings = []
    for ctx in project.files:
        if ctx.tree is None:
            continue
        in_kernels = "kernels" in ctx.rel.split("/")
        inside_flip = set()
        for node in ast.walk(ctx.tree):
            if _is_default_dtype_flip(node):
                inside_flip.update(id(n) for n in ast.walk(node.args[0]))
                findings.append(Finding(
                    "dtype-promotion", ctx.rel, node.lineno,
                    "torch.set_default_dtype(float64) — every fresh tensor "
                    "becomes f64 repo-wide and the f32 kernel contract "
                    "breaks"))
                continue
            if not in_kernels or id(node) in inside_flip:
                continue
            if isinstance(node, ast.Attribute) and node.attr in _F64_TOKENS:
                findings.append(Finding(
                    "dtype-promotion", ctx.rel, node.lineno,
                    f"{node.attr} in a kernels/ module — the kernel "
                    "contract is f32 end to end (the CUDA sources take "
                    "float*)"))
            elif (isinstance(node, ast.Constant)
                  and node.value in _F64_TOKENS):
                findings.append(Finding(
                    "dtype-promotion", ctx.rel, node.lineno,
                    f"dtype string '{node.value}' in a kernels/ module — "
                    "the kernel contract is f32 end to end"))
    return findings


_DECLARATIVE = ("n_entities", "entity_attrs", "build_sub", "K_mv", "KT_mv",
                "extract")
_IGNORED_UNDER_OVERRIDE = ("problem", "build_sub", "K_mv", "KT_mv",
                           "extract", "sub_layout", "entity_attrs",
                           "entity_scores", "n_entities")


@rule("registry-contract")
def check_registry(project: Project) -> List[Finding]:
    findings = []
    for ctx in project.files:
        if ctx.tree is None or "DomainSpec" not in ctx.text:
            continue
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else \
                f.id if isinstance(f, ast.Name) else ""
            if name != "DomainSpec":
                continue
            kw: Set[str] = {k.arg for k in node.keywords if k.arg}
            has_override = "step_override" in kw
            has_problem = "problem" in kw
            declarative = [h for h in _DECLARATIVE if h in kw]
            if not has_override and not has_problem and \
                    len(declarative) < len(_DECLARATIVE):
                missing = sorted(set(_DECLARATIVE) - set(declarative))
                findings.append(Finding(
                    "registry-contract", ctx.rel, node.lineno,
                    "DomainSpec picks no fill style: provide problem=, "
                    "step_override=, or all declarative hooks (missing: "
                    f"{missing})"))
            if has_override:
                ignored = sorted(set(_IGNORED_UNDER_OVERRIDE) & kw)
                if ignored:
                    findings.append(Finding(
                        "registry-contract", ctx.rel, node.lineno,
                        f"DomainSpec(step_override=...) also sets {ignored} "
                        "— the override runs its own pipeline and these "
                        "hooks are silently ignored"))
            if has_problem and not has_override:
                conflicting = sorted(
                    {"build_sub", "K_mv", "KT_mv", "extract"} & kw)
                if conflicting:
                    findings.append(Finding(
                        "registry-contract", ctx.rel, node.lineno,
                        f"DomainSpec(problem=...) also sets {conflicting} — "
                        "the problem factory path takes hooks from the "
                        "problem object; mixing fill styles is ambiguous"))
    return findings


# a Tensor hashes by identity but compares elementwise: a frozen config
# holding one neither keys a cache by value nor compares as a bool
_UNHASHABLE_ANNOS = {"dict", "Dict", "list", "List", "set", "Set",
                     "ndarray", "np.ndarray", "numpy.ndarray",
                     "Tensor", "torch.Tensor"}


def _anno_names(anno: ast.AST) -> Set[str]:
    """Top-level type heads of a field annotation.  Unwraps Optional/Union
    one level; does NOT descend into other subscripts — ``Callable[[Any],
    np.ndarray]`` describes a hashable callable, not an ndarray field."""
    if isinstance(anno, ast.Subscript):
        heads = _anno_names(anno.value)
        if heads & {"Optional", "Union"}:
            elts = anno.slice.elts if isinstance(anno.slice, ast.Tuple) \
                else [anno.slice]
            for e in elts:
                heads = heads | _anno_names(e)
        return heads
    if isinstance(anno, ast.Name):
        return {anno.id}
    if isinstance(anno, ast.Attribute):
        return {f"{anno.value.id}.{anno.attr}"
                if isinstance(anno.value, ast.Name) else anno.attr,
                anno.attr}
    if isinstance(anno, ast.Constant) and isinstance(anno.value, str):
        return {anno.value.split("[")[0]}
    return set()


def _is_frozen_dataclass(cls: ast.ClassDef) -> bool:
    for dec in cls.decorator_list:
        call = dec if isinstance(dec, ast.Call) else None
        target = call.func if call else dec
        name = target.attr if isinstance(target, ast.Attribute) else \
            target.id if isinstance(target, ast.Name) else ""
        if name == "dataclass" and call is not None:
            for k in call.keywords:
                if k.arg == "frozen" and isinstance(k.value, ast.Constant) \
                        and k.value.value is True:
                    return True
    return False


@rule("config-hashability")
def check_config_hash(project: Project) -> List[Finding]:
    findings = []
    for ctx in project.files:
        if ctx.tree is None:
            continue
        for cls in ast.walk(ctx.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            # a suppression on the class (or decorator) line covers every
            # field finding in the class body
            if any(ctx.suppressed("config-hashability", ln)
                   for ln in range(cls.lineno - len(cls.decorator_list),
                                   cls.lineno + 1)):
                continue
            methods = {n.name for n in cls.body
                       if isinstance(n, ast.FunctionDef)}
            if "__eq__" in methods and "__hash__" not in methods:
                findings.append(Finding(
                    "config-hashability", ctx.rel, cls.lineno,
                    f"class {cls.name} defines __eq__ without __hash__ — "
                    "Python sets __hash__ = None and instances can no "
                    "longer key the jit/plan caches"))
            if not _is_frozen_dataclass(cls):
                continue
            post = next((n for n in cls.body
                         if isinstance(n, ast.FunctionDef)
                         and n.name == "__post_init__"), None)
            refrozen: Set[str] = set()
            if post is not None:
                for node in ast.walk(post):
                    # object.__setattr__(self, "field", _freeze...(...))
                    if (isinstance(node, ast.Call)
                            and isinstance(node.func, ast.Attribute)
                            and node.func.attr == "__setattr__"
                            and len(node.args) >= 2
                            and isinstance(node.args[1], ast.Constant)):
                        refrozen.add(node.args[1].value)
            for stmt in cls.body:
                if not isinstance(stmt, ast.AnnAssign) or \
                        not isinstance(stmt.target, ast.Name):
                    continue
                field = stmt.target.id
                if field in refrozen:
                    continue
                bad = _anno_names(stmt.annotation) & _UNHASHABLE_ANNOS
                if bad:
                    findings.append(Finding(
                        "config-hashability", ctx.rel, stmt.lineno,
                        f"frozen dataclass {cls.name}.{field} is annotated "
                        f"{sorted(bad)} (unhashable) and never re-frozen "
                        "in __post_init__ — it will poison every cache "
                        "keyed on the config"))
    return findings


_BROAD_EXC = {"Exception", "BaseException"}


def _silent_except_scope(rel: str) -> bool:
    """Which files the silent-except rule polices: the serving hot path
    (``core/`` + ``service.py``) inside the package; everything handed to
    the runner outside it (so fixtures pin the rule)."""
    parts = rel.split("/")
    if "repro_torch" in parts and "src" in parts:
        return "core" in parts or parts[-1] == "service.py"
    return True


def _is_silent_body(body) -> bool:
    return all(
        isinstance(stmt, ast.Pass)
        or (isinstance(stmt, ast.Expr)
            and isinstance(stmt.value, ast.Constant)
            and stmt.value.value is ...)
        for stmt in body)


def _exc_names(node) -> Set[str]:
    """Exception-class names a handler catches (unwraps tuples)."""
    if node is None:
        return set()
    elts = node.elts if isinstance(node, ast.Tuple) else [node]
    names = set()
    for e in elts:
        if isinstance(e, ast.Name):
            names.add(e.id)
        elif isinstance(e, ast.Attribute):
            names.add(e.attr)
    return names


@rule("silent-except")
def check_silent_except(project: Project) -> List[Finding]:
    findings = []
    for ctx in project.files:
        if ctx.tree is None or not _silent_except_scope(ctx.rel):
            continue
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if node.type is None:
                findings.append(Finding(
                    "silent-except", ctx.rel, node.lineno,
                    "bare 'except:' — catches KeyboardInterrupt/SystemExit "
                    "and hides the fault from the serving ladder; catch a "
                    "typed exception and record it as a fault"))
                continue
            broad = _exc_names(node.type) & _BROAD_EXC
            if broad and _is_silent_body(node.body):
                findings.append(Finding(
                    "silent-except", ctx.rel, node.lineno,
                    f"'except {sorted(broad)[0]}' with a pass-only body "
                    "swallows faults silently — record the fault "
                    "(Allocation.faults / stats counters) or re-raise"))
    return findings
