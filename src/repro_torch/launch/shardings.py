"""Sharding rules for parameters, optimizer state, activations and caches —
the port of ``repro/launch/shardings.py``.

Policy (single-pod mesh ("data", "model"); multi-pod prepends "pod"):

  * batch dims           -> all data-parallel axes ("pod", "data")
  * attention heads      -> "model" when the head count divides the axis,
    else head_dim when IT divides, else replicated
  * ffn hidden / experts' ffn hidden / vocab  -> "model"
  * mamba/xlstm inner dims -> "model"
  * norms, routers, gates  -> replicated
  * KV caches: batch -> data axes; heads/head_dim -> "model" by the same
    divisibility rule.  long_500k (batch=1): cache SEQUENCE -> "data".

Rules are keyed on the leaf's path name and apply to its TRAILING dims, so
the same rule covers stacked leaves (leading [n_periods] axis) and
unstacked ones.  A spec is a :class:`~repro_torch.core.placement.P`,
entry for entry the reference's ``PartitionSpec``; ``core/placement.py``
holds the trees and placements that carry the specs out.

The port's KV cache is ``[n_periods, B, Kv, L, hd]`` where the reference's
is ``[n_periods, B, L, Kv, hd]``: :func:`kv_cache_specs` decides on the
reference's order of dims and puts each entry on the port's dim, so the
same *semantic* dims are sharded.

A mesh is a ``DeviceMesh`` or any object with ``axis_names`` and a
``shape`` mapping of axis name to size (the reference tests' stand-in).
"""

from __future__ import annotations

from ..core.placement import (P, axis_names, axis_size, dp_axes, dp_size,
                              map_with_path, placements, zip_map)

# the port's KV leaf [n_periods, B, Kv, L, hd] against the reference's
# [n_periods, B, L, Kv, hd]: port dim i holds reference dim KV_DIMS[i]
KV_DIMS = (0, 1, 3, 2, 4)


def _div(n: int, mesh, axis: str = "model") -> bool:
    return axis in axis_names(mesh) and n % axis_size(mesh, axis) == 0


def _leaf_rule(name: str, shape: tuple, mesh) -> P:
    """Partial spec for the SEMANTIC (trailing) dims of a leaf."""
    m = "model"

    def pick(*cands):
        """cands: dim indices from the end — the first divisible wins."""
        spec = [None] * len(shape)
        for di in cands:
            if _div(shape[di], mesh):
                spec[di] = m
                return P(*spec)
        return P(*spec)

    if name == "table":                       # embedding [V, D]
        return pick(-2, -1)
    if name in ("wq",):                       # [D, H, hd]
        return pick(-2, -1)
    if name in ("wk", "wv"):                  # [D, Kv, hd]
        # Kv heads when divisible; otherwise replicate (a few MB)
        return pick(-2)
    if name == "wo":                          # [H, hd, D]
        return pick(-3, -2)
    if name in ("w_gate", "w_up"):            # [.., D, F] (dense or expert)
        return pick(-1)
    if name == "w_down":                      # [.., F, D]
        return pick(-2)
    if name in ("w_z", "w_x"):                # mamba [D, d_inner]
        return pick(-1)
    if name == "conv_w":                      # [W, d_inner]
        return pick(-1)
    if name == "w_out":                       # [d_inner|D, D]
        return pick(-2)
    if name == "w_in":                        # slstm [D, H, 4hd]
        return pick(-1)
    if name == "r":                           # slstm [H, hd, 4hd]
        return pick(-1)
    if name == "wo_gate":                     # mlstm [D, D]
        return pick(-1)
    if name == "w" and len(shape) == 2:       # dense (unembed/frontend) [D, V]
        return pick(-1)
    # norms, routers, scalars, gates, a_log, dt_bias, ...
    return P(*([None] * len(shape)))


def _dict_names(path) -> list:
    return [str(k.key) for k in path if k.kind == "dict"]


def param_specs(params, mesh):
    """A :class:`P` tree matching ``params``' structure."""
    def spec_of(path, leaf):
        names = _dict_names(path)
        base = _leaf_rule(names[-1] if names else "", tuple(leaf.shape), mesh)
        # left-pad for stacked leading axes
        return P(*([None] * (leaf.ndim - len(base)) + list(base)))

    return map_with_path(spec_of, params)


def param_shardings(params, mesh):
    """The DTensor placements of every parameter (:func:`placements` of
    :func:`param_specs`)."""
    return zip_map(lambda s: placements(s, mesh), param_specs(params, mesh))


# ---------------------------------------------------------------------------
# activations / batches / caches
# ---------------------------------------------------------------------------

def batch_spec(mesh) -> P:
    """[B, S] token batches."""
    return P(dp_axes(mesh), None)


def activation_spec(mesh) -> P:
    """[B, S, D] hidden states."""
    return P(dp_axes(mesh), None, None)


def kv_cache_specs(cache, mesh, batch: int, shard_seq: bool = False,
                   seq_on_model: bool = False):
    """Specs for a decode cache tree (see ``transformer.init_cache``).

    ``shard_seq=True`` is the long-context mode: batch is tiny (1), so the
    cache SEQUENCE dim carries the data axes instead.
    ``seq_on_model=True`` (the flash-decode layout): batch stays on the
    data axes and the cache SEQUENCE shards over ``model``."""
    dp = dp_axes(mesh)
    n_dp = dp_size(mesh) if dp else 1
    batch_ok = batch % max(n_dp, 1) == 0 and not shard_seq

    def spec_of(path, leaf):
        if "pos" in _dict_names(path):
            return P()
        ndim = leaf.ndim
        # KVCache leaves are fields of a named tuple ("seq" entries);
        # SSM/xLSTM states are dicts and end in a dict key
        if ndim == 5 and path and path[-1].kind == "seq":
            # decide on the reference's dim order [periods, B, L, Kv, hd]
            shape = [leaf.shape[KV_DIMS.index(i)] for i in range(5)]
            b = dp if batch_ok else None
            if seq_on_model and _div(shape[2], mesh):
                ref = (None, b, "model", None, None)
            else:
                s = dp if (shard_seq and shape[2] % max(n_dp, 1) == 0) \
                    else None
                kv_dim, hd_dim = None, None
                if _div(shape[3], mesh):
                    kv_dim = "model"
                elif _div(shape[4], mesh):
                    hd_dim = "model"
                ref = (None, b, s, kv_dim, hd_dim)
            return P(*(ref[KV_DIMS[i]] for i in range(5)))
        # SSM / xLSTM states: [n_periods, B, ...] — shard batch + widest
        # trailing dim divisible by model
        spec = [None] * ndim
        if ndim >= 2 and batch_ok:
            spec[1] = dp
        for di in range(ndim - 1, 1, -1):
            if _div(leaf.shape[di], mesh):
                spec[di] = "model"
                break
        return P(*spec)

    return map_with_path(spec_of, cache)


def opt_state_specs(param_spec_tree):
    """Adam m/v mirror the param specs; scalars replicated."""
    return param_spec_tree
