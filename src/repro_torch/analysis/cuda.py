"""CUDA kernel invariant rules — the counterpart of
``repro/analysis/pallas.py``.

``cuda-no-float-atomics``
    The kernels' determinism contract: every sum runs in a fixed order, so
    a call gives the same bits every time (``chip_smoke.py`` and the CUDA
    tests check it).  A float atomic adds in whatever order the blocks
    arrive.  Flags, in CUDA sources (``.cu``/``.cuh``), ``atomicAdd`` /
    ``atomicSub`` / ``atomicExch`` whose target is float or half data
    (``float``, ``double``, ``half``/``__half``, ``__nv_bfloat16`` and
    their vector forms), and in ``kernels/*.py`` the torch scatters that
    add with atomics on the card: ``index_add_``/``index_add``,
    ``scatter_add_``/``scatter_add``, ``scatter_reduce`` and
    ``index_put_(..., accumulate=True)`` — what ``pallas-no-scatter``
    guards in the reference.  An atomic on integer data (a ticket that
    elects the last block, ``pdhg_matvec.cu``'s ``last_to_arrive``) is an
    election, not a sum, and passes.  A target whose type the rule cannot
    resolve from the file is flagged: declare it where it can be read, or
    suppress the line with its reason.

The reference's ``pallas-vmem-budget`` and ``pallas-block-align`` have no
counterpart: they are rules of the TPU's VMEM and (8, 128) tiling.  The
port's kernels take their shared memory dynamically (``extern
__shared__``) and are held to it at run time by the plan limit against
shared memory (PR 12, ROADMAP §3 "Repaired"); Hopper has no block tiling
rule a source can break statically.  ``docs/LINTS_torch.md`` says so.
"""

from __future__ import annotations

import ast
import re
from typing import List, Optional

from .core import FileContext, Finding, Project, rule

RULE = "cuda-no-float-atomics"

_ATOMIC_RE = re.compile(r"\b(atomicAdd|atomicSub|atomicExch)\s*\(")
_FLOAT_TYPES = {"float", "double", "half", "__half", "__half2",
                "__nv_bfloat16", "__nv_bfloat162", "nv_bfloat16",
                "nv_bfloat162", "float2", "float4", "double2"}
_INT_TYPES = {"int", "unsigned", "uint32_t", "int32_t", "uint64_t",
              "int64_t", "long", "short", "char", "size_t",
              "unsigned int", "unsigned long long", "long long",
              "unsigned long", "uint16_t", "int16_t", "bool"}
_SCATTERS = {"index_add_", "index_add", "scatter_add_", "scatter_add",
             "scatter_reduce_", "scatter_reduce"}


def _strip_comments(text: str) -> str:
    """The source with comments blanked (newlines kept, so offsets map to
    the same lines)."""
    def blank(m):
        return re.sub(r"[^\n]", " ", m.group(0))
    return re.sub(r"//[^\n]*|/\*.*?\*/", blank, text, flags=re.S)


def _first_arg(text: str, start: int) -> str:
    """The first argument of the call whose ``(`` is at ``start - 1``."""
    depth, i = 0, start
    while i < len(text):
        ch = text[i]
        if ch in "([{":
            depth += 1
        elif ch in ")]}":
            if depth == 0:
                break
            depth -= 1
        elif ch == "," and depth == 0:
            break
        i += 1
    return text[start:i].strip()


def _target_type(arg: str, text: str) -> Optional[str]:
    """The element type the atomic writes: an explicit cast in the
    argument, else the declared type of the pointer or array it names
    (a parameter or a local of the file), else None."""
    cast = re.match(r"\(\s*(?:const\s+)?([\w:]+(?:\s+\w+)*)\s*\*\s*\)", arg)
    if cast:
        return cast.group(1)
    name = re.findall(r"[A-Za-z_]\w*", arg)
    if not name:
        return None
    base = name[0]
    decl = re.search(
        r"(?:const\s+)?((?:unsigned\s+long\s+long|unsigned\s+long|"
        r"unsigned\s+int|long\s+long|[\w:]+))\s*(?:\*\s*(?:__restrict__\s*)?"
        r"|\s+)(?:__restrict__\s+)?" + re.escape(base) + r"\s*(?:\[|[,);=])",
        text)
    return decl.group(1) if decl else None


def _cuda_findings(ctx: FileContext) -> List[Finding]:
    text = _strip_comments(ctx.text)
    out = []
    for m in _ATOMIC_RE.finditer(text):
        arg = _first_arg(text, m.end())
        typ = _target_type(arg, text)
        line = text.count("\n", 0, m.start()) + 1
        if typ is not None and typ.replace("const ", "").strip() in _INT_TYPES:
            continue
        if typ is None:
            what = (f"{m.group(1)} on '{arg}' whose element type is not "
                    "declared in the file — cannot prove it integer")
        elif typ in _FLOAT_TYPES:
            what = (f"{m.group(1)} on {typ} data ('{arg}') adds in block "
                    "arrival order — the kernels' sums are fixed-order "
                    "(deterministic) by contract")
        else:
            what = (f"{m.group(1)} on {typ} data ('{arg}'), not an "
                    "integer type")
        out.append(Finding(RULE, ctx.rel, line, what))
    return out


def _py_findings(ctx: FileContext) -> List[Finding]:
    out = []
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)):
            continue
        name = node.func.attr
        accumulate = name in ("index_put_", "index_put") and any(
            k.arg == "accumulate" and not (
                isinstance(k.value, ast.Constant) and not k.value.value)
            for k in node.keywords)
        if name in _SCATTERS or accumulate:
            what = (f"{name}(..., accumulate=True)" if accumulate
                    else f"{name}()")
            out.append(Finding(
                RULE, ctx.rel, node.lineno,
                f"{what} in a kernels/ module adds with float atomics on "
                "the card (order-dependent bits) — fold with a fixed-order "
                "gather, as the CUDA kernels do"))
    return out


@rule(RULE)
def check_no_float_atomics(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    for ctx in project.files:
        if ctx.is_cuda:
            findings.extend(_cuda_findings(ctx))
    for ctx in project.in_dir("kernels"):
        if ctx.tree is not None:
            findings.extend(_py_findings(ctx))
    return findings
