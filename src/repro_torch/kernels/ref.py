"""Plain PyTorch versions of the structured PDHG kernels — the port of
``repro/kernels/ref.py:28-102``.

These are the semantic ground truth for the hand-written CUDA kernels in
``csrc/structured_pdhg_step.cu``: the CPU path runs them, and
``chip_smoke.py`` holds each kernel against them on the card.  Both
matvec directions are ``torch.gather`` + a sum over the nnz axis; the
wide-bucket results are folded into their segments with ``index_add_``
(the reference's one-hot accumulation: bucket ids are distinct, padded
bucket columns add an exact 0.0 to segment 0).
"""

from __future__ import annotations

import torch


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
    wide = torch.sum(wval * _bgather(v, widx), dim=-2)       # [k, D]
    k = wids.shape[0]
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


def structured_forward_step(s, x, c, l, u, tau, kty):
    """(x_new, K x_new); ``tau`` broadcasts against [k, N] (pass [k, 1])."""
    x_new = primal_tail(x, c, l, u, tau, kty)
    return x_new, smatvec(s, x_new)


def structured_backward_step(s, y, q, sigma, ineq_mask, kx_new, kx_prev):
    """(y_new, K^T y_new); ``sigma`` broadcasts against [k, M]."""
    y_new = dual_tail(y, q, sigma, ineq_mask, kx_new, kx_prev)
    return y_new, smatvec_t(s, y_new)
