"""Carry state between the reference package and the port through numpy.

The tests feed both packages identical LPs, ELL payloads (f32, bf16 or
int8 coefficients with their dequant scales) and warm iterates:
they convert the reference's leaves to numpy, and these helpers build the
port's containers from them.  Nothing here imports the reference.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .core.pdhg import OperatorLP, StructuredOperator
from .core.plan import WarmStart
from .core.problem import LinearProgram

_INDEX_FIELDS = ("row_idx", "wrow_idx", "wrow_ids", "col_idx", "wcol_idx",
                 "wcol_ids", "row_fold", "col_fold")


def _tensor(name: str, a, device) -> Optional[torch.Tensor]:
    """One leaf: indices int32, bool and int8 (quantized coefficients) as
    they are, bf16 coefficients (numpy's ``bfloat16`` extension dtype,
    which ``np.floating`` does not catch) through f32 — exact — into
    ``torch.bfloat16``, other floats (scales included) f32."""
    if a is None:
        return None
    a = np.asarray(a)
    if name in _INDEX_FIELDS:
        a = a.astype(np.int32)
    elif a.dtype.name == "bfloat16":
        return torch.tensor(a.astype(np.float32),
                            device=device).to(torch.bfloat16)
    elif a.dtype == np.bool_:
        pass
    elif np.issubdtype(a.dtype, np.floating):
        a = a.astype(np.float32)
    # a copy: the reference's arrays arrive read-only
    return torch.tensor(a, device=device)


def _structured(fields: dict, device) -> StructuredOperator:
    return StructuredOperator(**{
        f: _tensor(f, fields.get(f), device)
        for f in StructuredOperator._fields})


def operator_from_numpy(fields: dict, device):
    """The port's container from the reference's leaves as numpy arrays.

    ``fields`` holds either the :class:`StructuredOperator` fields
    (``row_idx``, ``row_val``, ...; missing optional ones are None) — and
    a StructuredOperator comes back — or the :class:`OperatorLP` fields
    ``c``, ``q``, ``l``, ``u``, ``ineq_mask``, ``data`` (a tuple of
    arrays) and optionally ``structured`` (a dict of StructuredOperator
    fields, or None)."""
    device = torch.device(device)
    if "row_idx" in fields:
        return _structured(fields, device)
    data = fields.get("data", ())
    data = tuple(_tensor(f"data{i}", a, device) for i, a in enumerate(data))
    structured = fields.get("structured")
    return OperatorLP(
        c=_tensor("c", fields["c"], device),
        q=_tensor("q", fields["q"], device),
        l=_tensor("l", fields["l"], device),
        u=_tensor("u", fields["u"], device),
        ineq_mask=_tensor("ineq_mask",
                          np.asarray(fields["ineq_mask"], bool), device),
        data=data,
        structured=None if structured is None else _structured(structured,
                                                               device))


def linear_program_from_numpy(fields: dict, device) -> LinearProgram:
    """The port's :class:`LinearProgram` from the reference's leaves as
    numpy arrays (``c``, ``G``, ``h``, ``A``, ``b``, ``l``, ``u``; floats
    to f32) and its static sizes (``n_var``, ``n_ineq``, ``n_eq``)."""
    device = torch.device(device)
    return LinearProgram(
        *(_tensor(f, fields[f], device) for f in ("c", "G", "h", "A", "b",
                                                  "l", "u")),
        n_var=int(fields["n_var"]), n_ineq=int(fields["n_ineq"]),
        n_eq=int(fields["n_eq"]))


def warm_from_numpy(x, y, mask=None, *, device):
    """Warm iterates for the port's solvers: an ``(x, y)`` tensor pair, or
    a masked :class:`~repro_torch.core.plan.WarmStart` when ``mask`` ([k]
    bool) is given."""
    device = torch.device(device)
    tx = torch.tensor(np.asarray(x, np.float32), device=device)
    ty = torch.tensor(np.asarray(y, np.float32), device=device)
    if mask is None:
        return tx, ty
    return WarmStart(x=tx, y=ty, mask=np.asarray(mask, bool), stats={})
