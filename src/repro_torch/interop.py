"""Carry state between the reference package and the port through numpy.

The tests feed both packages identical LPs, ELL payloads (f32, bf16 or
int8 coefficients with their dequant scales), warm iterates, language-model
parameters, optimizer states and decode caches: they convert the
reference's leaves to numpy, and these helpers build the port's containers
from them.  Nothing here imports the reference.
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


# ---------------------------------------------------------------------------
# language models: parameters and decode caches
# ---------------------------------------------------------------------------

def _float_tensor(a, device) -> torch.Tensor:
    """A float leaf as it is (f32, or bf16 through f32, which is exact);
    anything else f32."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.astype(np.float32),
                            device=device).to(torch.bfloat16)
    return torch.tensor(a.astype(np.float32), device=device)


def _paths(tree, prefix=""):
    """``{path: leaf}`` of a nested dict/list tree (``a.0.b``)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_paths(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def _rebuild(like, leaf_of, prefix=""):
    if isinstance(like, dict):
        return {k: _rebuild(v, leaf_of, f"{prefix}.{k}" if prefix else k)
                for k, v in like.items()}
    if isinstance(like, list):
        return [_rebuild(v, leaf_of, f"{prefix}.{i}" if prefix else str(i))
                for i, v in enumerate(like)]
    return leaf_of(prefix, like)


def params_from_numpy(tree: dict, cfg, device) -> dict:
    """The port's LM parameters for ``cfg`` from the reference's
    ``init_params`` tree with every leaf converted to numpy.  Leaf paths
    map one to one (``segments.0.b0.mixer.wq``); stacked period leaves stay
    stacked.  A missing or extra leaf, or a leaf of another shape, raises
    ``ValueError``."""
    from .models.transformer import init_params
    device = torch.device(device)
    like = init_params(None, cfg)
    want, got = _paths(like), _paths(tree)
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(f"parameter tree mismatch: missing {missing}, "
                         f"extra {extra}")
    for path, t in want.items():
        if tuple(np.shape(got[path])) != tuple(t.shape):
            raise ValueError(f"{path}: shape {np.shape(got[path])}, "
                             f"expected {tuple(t.shape)}")
    return _rebuild(like, lambda path, _: _float_tensor(got[path], device))


def opt_state_from_numpy(step, m: dict, v: dict, cfg, device):
    """The port's :class:`~repro_torch.train.optimizer.AdamWState` from the
    reference's ``AdamWState`` fields as numpy: ``step`` a 0-d int32 tensor,
    ``m`` and ``v`` parameter trees for ``cfg`` (as
    :func:`params_from_numpy` checks and builds them)."""
    from .train.optimizer import AdamWState
    device = torch.device(device)
    return AdamWState(
        step=torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                          device=device),
        m=params_from_numpy(m, cfg, device),
        v=params_from_numpy(v, cfg, device))


def cache_from_numpy(tree: dict, cfg, device) -> dict:
    """The port's decode cache for ``cfg`` from the reference's
    ``init_cache`` tree (after decode steps or not) with every leaf
    converted to numpy: KV caches ``(k, v)`` of ``[n_periods, B, L, Kv,
    hd]`` become the port's ``[n_periods, B, Kv, L, hd]`` ring buffers, the
    mamba2/mlstm/slstm states keep their shapes and ``pos`` becomes a 0-d
    int64 tensor.  A missing or extra segment, block or state leaf raises
    ``ValueError``."""
    from .models.attention import KVCache
    device = torch.device(device)
    segs = tree["seg_caches"]
    if set(tree) != {"seg_caches", "pos"} or len(segs) != len(cfg.segments):
        raise ValueError("cache tree mismatch: expected seg_caches for "
                         f"{len(cfg.segments)} segments and pos")
    like = [
        {f"b{i}": _state_keys(cfg, b) for i, b in enumerate(seg.period)}
        for seg in cfg.segments]
    out = []
    for seg_tree, seg_like in zip(segs, like):
        if set(seg_tree) != set(seg_like):
            raise ValueError(f"cache blocks {sorted(seg_tree)}, expected "
                             f"{sorted(seg_like)}")
        seg_out = {}
        for name, keys in seg_like.items():
            leaf = seg_tree[name]
            if keys is None:                  # a KV cache (k, v)
                k, v = leaf
                seg_out[name] = KVCache(
                    *(_float_tensor(np.swapaxes(np.asarray(a), -3, -2),
                                    device).contiguous() for a in (k, v)))
                continue
            if set(leaf) != keys:
                raise ValueError(f"{name}: state {sorted(leaf)}, expected "
                                 f"{sorted(keys)}")
            seg_out[name] = {k: _float_tensor(leaf[k], device)
                             for k in leaf}
        out.append(seg_out)
    return {"seg_caches": out,
            "pos": torch.tensor(int(np.asarray(tree["pos"])),
                                dtype=torch.int64, device=device)}


def _state_keys(cfg, bcfg):
    """The state leaves of a block's decode cache (None: a KV cache)."""
    if bcfg.mixer in ("attn", "shared_attn"):
        return None
    return {"mamba2": {"ssm", "conv"}, "mlstm": {"C", "n", "m"},
            "slstm": {"h", "c", "n", "m"}}[bcfg.mixer]
