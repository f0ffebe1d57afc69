"""Collective statistics and parameter accounting shared by the dry run, the
roofline and the tests — the port of ``repro/launch/hlo_stats.py``.

The module keeps the reference's name and public names, but its input is
not HLO text: the port has no compiled program to read.  Collectives are
read from what ran, either a :class:`CollectiveLog` (a
``torch.distributed.tensor.debug.CommDebugMode`` that also keeps each
collective's result tensor) or a list of ``(op, result tensor)`` pairs.
"""

from __future__ import annotations

import math

import torch
from torch.distributed.tensor.debug import CommDebugMode

from . import specs as sp

COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                  "collective-permute")

# op-name stems of c10d and functional collectives -> the reference's kinds
_KINDS = (
    ("reduce_scatter", "reduce-scatter"),
    ("allgather", "all-gather"), ("all_gather", "all-gather"),
    ("allreduce", "all-reduce"), ("all_reduce", "all-reduce"),
    ("alltoall", "all-to-all"), ("all_to_all", "all-to-all"),
    ("send", "collective-permute"), ("recv", "collective-permute"),
)

# in-place c10d ops whose result is their first (output) argument
_INPLACE_OUT = ("_allgather_base_", "allgather_", "_reduce_scatter_base_",
                "reduce_scatter_", "alltoall_base_", "alltoall_",
                "allreduce_", "allreduce_coalesced_", "send", "recv_")


def collective_kind(op) -> str | None:
    """The reference's kind of a collective op (an ``OpOverload``, its
    packet, or a name), or None for any other op."""
    name = str(getattr(op, "__name__", op)).split(".")[-1] \
        if not isinstance(op, str) else op.split(".")[-1]
    for stem, kind in _KINDS:
        if stem in name:
            return kind
    return None


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def _nbytes(x) -> int:
    return sum(math.prod(t.shape) * t.element_size() for t in _tensors(x))


class CollectiveLog(CommDebugMode):
    """``CommDebugMode`` that also keeps ``(op name, result tensors)`` of
    every collective it sees, in order (``pairs``)."""

    def __init__(self):
        super().__init__()
        self.pairs: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        packet = getattr(func, "_overloadpacket", None)
        if packet is not None and out is not NotImplemented:
            name = str(packet)
            if collective_kind(name) is not None and "wait" not in name:
                short = name.split(".")[-1]
                result = args[0] if short in _INPLACE_OUT else out
                self.pairs.append((name, [torch.empty(
                    t.shape, dtype=t.dtype, device="meta")
                    for t in _tensors(result)]))
        return out


def collective_bytes(record) -> dict:
    """Sum the RESULT bytes of every collective, by kind, with ``count`` and
    ``total``.  ``record``: a :class:`CollectiveLog` or a list of ``(op,
    result)`` pairs (a result is a tensor or a list of tensors; an op is an
    ``OpOverload`` or its name)."""
    pairs = record.pairs if isinstance(record, CollectiveLog) else record
    if isinstance(record, CommDebugMode) and not isinstance(
            record, CollectiveLog):
        raise TypeError("a plain CommDebugMode keeps counts, not result "
                        "tensors: record with hlo_stats.CollectiveLog")
    out = {op: 0 for op in COLLECTIVE_OPS}
    out["count"] = 0
    for op, result in pairs:
        kind = collective_kind(op)
        if kind is None:
            continue
        out[kind] += _nbytes(result)
        out["count"] += 1
    out["total"] = sum(out[op] for op in COLLECTIVE_OPS)
    return out


def _paths(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _paths(v, path)
    elif isinstance(tree, torch.Tensor):
        yield path, tree


def active_param_counts(cfg) -> dict:
    """(total, active) param counts — MoE counts top_k of n_experts."""
    total = active = embed = 0
    for names, leaf in _paths(sp.params_shape(cfg)):
        n = math.prod(leaf.shape)
        total += n
        if "table" in names or "unembed" in names:
            embed += n
            active += n
            continue
        if any(x in names for x in ("w_gate", "w_up", "w_down")) and \
                leaf.ndim >= 3 and cfg.moe is not None and \
                leaf.shape[-3] == cfg.moe.n_experts:
            active += int(n * cfg.moe.top_k / cfg.moe.n_experts)
        else:
            active += n
    return {"total": total, "active": active, "embed": embed}
