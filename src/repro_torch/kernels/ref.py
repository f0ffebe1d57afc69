"""Plain PyTorch versions of the PDHG kernels — the port of
``repro/kernels/ref.py``.

These are the semantic ground truth for the hand-written CUDA kernels in
``csrc/pdhg_matvec.cu`` and ``csrc/fused_pdhg_step.cu`` (the dense
``[k, M, N]`` family), ``csrc/structured_pdhg_step.cu`` (the structured
k-lane stack) and ``csrc/structured_full_pdhg_step.cu`` (the single-lane
full problem): the CPU path runs them, and ``chip_smoke.py`` holds each
kernel against them on the card.  The dense products are ``einsum`` in
f32 (bf16 coefficients are widened first, exactly).  The structured
matvec directions are ``torch.gather`` + a sum over the nnz axis; the
wide-bucket results are folded into their segments with ``index_add_``
(the reference's one-hot accumulation: bucket ids are distinct, padded
bucket columns add an exact 0.0 to segment 0).

A lane's sums must not depend on how many lanes share its stack (the
serving dispatcher stacks several tenants into one launch): every sum
along a row runs through :func:`row_reduce` over at least
:data:`LANE_ROWS` rows and in chunks of at most :data:`LANE_CHUNK`
entries, and the wide-bucket sums run along rows of their own, where
padding a bucket wider adds only zeros at a row's end.
"""

from __future__ import annotations

import functools

import torch

# the fewest rows a reduction along the last axis runs over.  CUDA's
# reduction picks its block shape by the row count (each row summed 64
# threads wide at 8 rows, 32 wide from 16 rows on), so without the padding
# a lane's sum would change with the number of lanes in its stack
LANE_ROWS = 16
# the longest row reduced in one pass.  From about 131,000 entries a row
# (256 values a thread of a 512-thread block) CUDA's reduction also splits
# each row across blocks, as many as fill the card for the row count, so
# longer rows are summed in chunks of this length first
LANE_CHUNK = 65_536

sum_last = functools.partial(torch.sum, dim=-1)
norm_last = functools.partial(torch.linalg.vector_norm, dim=-1)


def row_reduce(fn, a: torch.Tensor) -> torch.Tensor:
    """``fn(a)`` for a sum or a 2-norm ``fn`` along the last axis of ``a``
    ([rows, n]), each row's result the same whatever the number of rows:
    it runs over at least :data:`LANE_ROWS` rows (zero rows appended,
    their results dropped), and a row longer than :data:`LANE_CHUNK` is
    reduced in zero-padded chunks of that length, then over its chunks'
    results (a sum of sums, a norm of norms)."""
    rows, n = a.shape
    if n > LANE_CHUNK:
        m = -(-n // LANE_CHUNK)
        a = torch.nn.functional.pad(a, (0, m * LANE_CHUNK - n))
        parts = row_reduce(fn, a.reshape(rows * m, LANE_CHUNK))
        return row_reduce(fn, parts.reshape(rows, m))
    if rows < LANE_ROWS:
        a = torch.cat([a, a.new_zeros((LANE_ROWS - rows, n))])
    return fn(a)[:rows]


def bmatvec(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y[k, m] = sum_n A[k, m, n] * x[k, n]   (f32 accumulation)."""
    return torch.einsum("kmn,kn->km", A.to(torch.float32),
                        x.to(torch.float32))


def bmatvec_t(A: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x[k, n] = sum_m A[k, m, n] * y[k, m]   (A read transposed)."""
    return torch.einsum("kmn,km->kn", A.to(torch.float32),
                        y.to(torch.float32))


def _bgather(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """v[k, n] gathered per lane by idx [k, ...] -> [k, ...]."""
    k = idx.shape[0]
    return torch.gather(v, 1, idx.reshape(k, -1).long()).reshape(idx.shape)


def _gather_side(idx, val, widx, wval, wids, v, n_out):
    """One direction of the two-bucket ELL matvec:

        out  = sum_w val[:, w, :] * v[idx[:, w, :]]          (narrow)
        out += fold(wids, sum_w wval[:, w, :] * v[widx[:, w, :]])
    """
    out = torch.sum(val * _bgather(v, idx), dim=-2)          # [k, n_out]
    k, d = wids.shape
    # each bucket column summed along a row of its own: [k * D, Ww]
    prod = (wval * _bgather(v, widx)).transpose(1, 2).reshape(k * d, -1)
    wide = row_reduce(sum_last, prod).reshape(k, d)          # [k, D]
    lane = torch.arange(k, device=wids.device)[:, None] * n_out
    flat = (wids.long() + lane).reshape(-1)
    return out.reshape(-1).index_add_(0, flat, wide.reshape(-1)).reshape(
        k, n_out)


def smatvec(s, x):
    """kx[k, m] = (K x) through the row-side layout."""
    return _gather_side(s.row_idx, s.row_val, s.wrow_idx, s.wrow_val,
                        s.wrow_ids, x, s.row_idx.shape[-1])


def smatvec_t(s, y):
    """kty[k, n] = (K^T y) through the column-side layout."""
    return _gather_side(s.col_idx, s.col_val, s.wcol_idx, s.wcol_val,
                        s.wcol_ids, y, s.col_idx.shape[-1])


def primal_tail(x, c, l, u, tau, kty):
    """x_new = clip(x - tau * (c + kty), l, u)   (NaN in x propagates)."""
    return torch.minimum(torch.maximum(x - tau * (c + kty), l), u)


def dual_tail(y, q, sigma, ineq_mask, kx_new, kx_prev):
    """y_new = y + sigma * (2 kx_new - kx_prev - q), then >= 0 where
    ``ineq_mask``."""
    y_new = y + sigma * (2.0 * kx_new - kx_prev - q)
    return torch.where(ineq_mask, torch.clamp_min(y_new, 0.0), y_new)


def fused_forward_step(A, x, c, l, u, tau, kty):
    """Dense primal half-step + forward product: (x_new, A x_new);
    ``tau`` broadcasts against [k, N] (pass [k, 1])."""
    x_new = primal_tail(x, c, l, u, tau, kty)
    return x_new, bmatvec(A, x_new)


def fused_backward_step(A, y, q, sigma, ineq_mask, kx_new, kx_prev):
    """Dense dual half-step + adjoint product: (y_new, A^T y_new);
    ``sigma`` broadcasts against [k, M]."""
    y_new = dual_tail(y, q, sigma, ineq_mask, kx_new, kx_prev)
    return y_new, bmatvec_t(A, y_new)


def structured_forward_step(s, x, c, l, u, tau, kty):
    """(x_new, K x_new); ``tau`` broadcasts against [k, N] (pass [k, 1])."""
    x_new = primal_tail(x, c, l, u, tau, kty)
    return x_new, smatvec(s, x_new)


def structured_backward_step(s, y, q, sigma, ineq_mask, kx_new, kx_prev):
    """(y_new, K^T y_new); ``sigma`` broadcasts against [k, M]."""
    y_new = dual_tail(y, q, sigma, ineq_mask, kx_new, kx_prev)
    return y_new, smatvec_t(s, y_new)


# --------------------------------------------------------------------------
# full-problem (single-lane) oracles — the fused_structured_full engine's
# semantics (``repro/kernels/ref.py:112-172``): fold-map wide add-back, the
# ragged wide-block plan over the descending-width bucket, and int8/bf16
# coefficient storage dequantized on the fly (f32 accumulation)
# --------------------------------------------------------------------------

def _deq(val, scale):
    """Coefficients to f32: cast, then fold in the per-bucket dequant scale
    when the payload is int8-quantized (scale [k, 1] or None)."""
    v = val.to(torch.float32)
    return v if scale is None else v * scale[..., None]


def _gather_wide_sorted(widx, wval, wscale, fold, v, plan):
    """Wide-bucket reduce + fold-map add-back:

        wide[d] = sum_w wval[:, w, d] * v[widx[:, w, d]]     per plan block
        out     = pad(wide, 1)[fold]                          (a gather)

    ``plan`` is the ragged block plan ``((c0, c1, wb), ...)`` of
    ``pdhg._wide_block_plans``: block ``[c0, c1)`` of the descending-width
    bucket is reduced over its first ``wb`` rows only.  The fold map sends
    narrow segments to the zero slot one past the bucket's end."""
    if not plan:
        plan = ((0, wval.shape[-1], wval.shape[-2]),)
    parts = [
        torch.sum(_deq(wval[:, :wb, c0:c1], wscale)
                  * _bgather(v, widx[:, :wb, c0:c1]), dim=-2)
        for (c0, c1, wb) in plan]
    wide = torch.nn.functional.pad(torch.cat(parts, dim=-1), (0, 1))
    return _bgather(wide, fold)


def smatvec_full(s, x, plan=()):
    """kx = K x for the single-lane full problem: the narrow ELL reduce
    plus the fold-map wide add-back (no one-hot)."""
    narrow = torch.sum(_deq(s.row_val, s.row_scale)
                       * _bgather(x, s.row_idx), dim=-2)
    return narrow + _gather_wide_sorted(
        s.wrow_idx, s.wrow_val, s.wrow_scale, s.row_fold, x, plan)


def smatvec_t_full(s, y, plan=()):
    """kty = K^T y through the column-side layout (see smatvec_full)."""
    narrow = torch.sum(_deq(s.col_val, s.col_scale)
                       * _bgather(y, s.col_idx), dim=-2)
    return narrow + _gather_wide_sorted(
        s.wcol_idx, s.wcol_val, s.wcol_scale, s.col_fold, y, plan)


def structured_full_forward_step(s, x, c, l, u, tau, kty, plan=()):
    """(x_new, K x_new) for the full problem; ``tau`` broadcasts against
    [1, N] (pass [1, 1])."""
    x_new = primal_tail(x, c, l, u, tau, kty)
    return x_new, smatvec_full(s, x_new, plan)


def structured_full_backward_step(s, y, q, sigma, ineq_mask, kx_new,
                                  kx_prev, plan=()):
    """(y_new, K^T y_new) for the full problem (column side)."""
    y_new = dual_tail(y, q, sigma, ineq_mask, kx_new, kx_prev)
    return y_new, smatvec_t_full(s, y_new, plan)
