"""Dispatch for the PDHG kernels — the port of ``repro/kernels/ops.py``.

The dense family (``bmatvec`` / ``bmatvec_t`` / ``fused_forward_step`` /
``fused_backward_step`` over an explicit ``A [k, M, N]``), the structured
half-steps (``structured_forward_step`` / ``structured_backward_step``,
the k-lane stack) and the full-problem half-steps
(``structured_full_forward_step`` / ``structured_full_backward_step``, the
single-lane full problem with its ragged wide-block ``plan``) take a
``backend`` keyword:

``None`` / ``"auto"``
    The hand-written CUDA kernel for CUDA tensors, the plain torch version
    (``ref.py``) for CPU tensors.  Nothing else decides: no fallback.
``"kernel"``
    Force the CUDA kernel; CPU tensors raise.
``"ref"``
    Force the plain version (``chip_smoke.py`` holds the kernel against it
    on the same CUDA inputs).

The out-of-loop products ``smatvec``/``smatvec_t`` and
``smatvec_full``/``smatvec_t_full`` (power iteration, equilibration probes,
the final KKT report) stay plain torch, as the reference keeps them on XLA
(``repro/kernels/ops.py:154-164,226-235``).

The reference pads dense operands to ``BLOCK_M/N=256`` multiples, lane
axes to ``STRUCT_ALIGN=128`` and the full problem's sides to sublane and
``FULL_BLOCK_*`` multiples for its VMEM blocks; those are TPU layout rules
and are not carried over — the CUDA kernels mask their ragged edges
themselves.
"""

from __future__ import annotations

import torch

from . import ref as _ref

_MODES = (None, "auto", "kernel", "ref")


def _resolve_mode(backend, tensor) -> str:
    """'kernel' | 'ref' from a user-facing backend name and the device of
    the tensors the call was given."""
    if backend is None:  # the solver's every call: decide first
        return "kernel" if tensor.is_cuda else "ref"
    if backend not in _MODES:
        raise ValueError(f"unknown kernel backend {backend!r}; "
                         f"expected one of {_MODES}")
    on_cuda = tensor.is_cuda
    if backend in (None, "auto"):
        return "kernel" if on_cuda else "ref"
    if backend == "kernel" and not on_cuda:
        raise ValueError("backend='kernel' needs CUDA tensors; got tensors "
                         f"on {tensor.device}")
    return backend


# --------------------------------------------------------------------------
# dense family: A [k, M, N] f32 or bf16, f32 vectors (bf16 vectors are
# widened, exactly, before a kernel call, as the reference's einsum widens)
# --------------------------------------------------------------------------

def _f32(v):
    return v.to(torch.float32)


def bmatvec(A, x, *, backend=None):
    """y = A @ x batched over the leading axis; any [k, M, N] shape."""
    if _resolve_mode(backend, A) == "ref":
        return _ref.bmatvec(A, x)
    from . import pdhg_matvec as _kernel
    return _kernel.bmatvec(A, _f32(x))


def bmatvec_t(A, y, *, backend=None):
    """x = A^T @ y batched over the leading axis (A read untransposed)."""
    if _resolve_mode(backend, A) == "ref":
        return _ref.bmatvec_t(A, y)
    from . import pdhg_matvec as _kernel
    return _kernel.bmatvec_t(A, _f32(y))


def fused_forward_step(A, x, c, l, u, tau, kty, *, backend=None):
    """(x_new, kx) — clip(x - tau (c + kty), l, u), then A x_new; ``tau``
    is [k]."""
    if _resolve_mode(backend, x) == "ref":
        return _ref.fused_forward_step(A, x, c, l, u, tau[:, None], kty)
    from . import fused_pdhg_step as _kernel
    return _kernel.fused_forward_step(A, x, c, l, u, tau, kty)


def fused_backward_step(A, y, q, sigma, ineq_mask, kx_new, kx_prev, *,
                        backend=None):
    """(y_new, kty) — y + sigma (2 kx_new - kx_prev - q), >= 0 on
    ``ineq_mask``, then A^T y_new; ``sigma`` is [k]."""
    if _resolve_mode(backend, y) == "ref":
        return _ref.fused_backward_step(A, y, q, sigma[:, None], ineq_mask,
                                        kx_new, kx_prev)
    from . import fused_pdhg_step as _kernel
    return _kernel.fused_backward_step(A, y, q, sigma, ineq_mask, kx_new,
                                       kx_prev)


# --------------------------------------------------------------------------
# structured family
# --------------------------------------------------------------------------

def smatvec(s, x):
    """kx = K x through the row-side gather layout (plain torch)."""
    return _ref.smatvec(s, x)


def smatvec_t(s, y):
    """kty = K^T y through the column-side gather layout (plain torch)."""
    return _ref.smatvec_t(s, y)


def precheck_structured(s) -> None:
    """Check a stacked structured operator's bucket ids where the lane
    kernels will read it (CUDA tensors, a [k] lane axis), so the checks'
    one device sync falls before the map step rather than inside its first
    half-step; nothing to do elsewhere."""
    if s is None or not s.row_idx.is_cuda or s.row_idx.ndim != 3:
        return
    from . import structured_pdhg_step as _kernel
    _kernel.precheck(s)


def structured_forward_step(s, x, c, l, u, tau, kty, *, backend=None):
    """(x_new, kx) for a structured operator: the whole k-stack in one
    call (``tau`` is [k])."""
    if _resolve_mode(backend, x) == "ref":
        return _ref.structured_forward_step(s, x, c, l, u, tau[:, None], kty)
    from . import structured_pdhg_step as _kernel
    return _kernel.structured_forward_step(s, x, c, l, u, tau, kty)


def structured_backward_step(s, y, q, sigma, ineq_mask, kx_new, kx_prev, *,
                             backend=None):
    """(y_new, kty) for a structured operator (``sigma`` is [k])."""
    if _resolve_mode(backend, y) == "ref":
        return _ref.structured_backward_step(s, y, q, sigma[:, None],
                                             ineq_mask, kx_new, kx_prev)
    from . import structured_pdhg_step as _kernel
    return _kernel.structured_backward_step(s, y, q, sigma, ineq_mask,
                                            kx_new, kx_prev)


def smatvec_full(s, x, *, plan=()):
    """kx = K x for the single-lane full problem (plain torch)."""
    return _ref.smatvec_full(s, x, plan)


def smatvec_t_full(s, y, *, plan=()):
    """kty = K^T y through the column-side full layout (plain torch)."""
    return _ref.smatvec_t_full(s, y, plan)


def structured_full_forward_step(s, x, c, l, u, tau, kty, *, plan=(),
                                 backend=None):
    """(x_new, kx) for the single-lane full problem (``tau`` is [1])."""
    if _resolve_mode(backend, x) == "ref":
        return _ref.structured_full_forward_step(s, x, c, l, u, tau[:, None],
                                                 kty, plan)
    from . import structured_full_pdhg_step as _kernel
    return _kernel.structured_full_forward_step(s, x, c, l, u, tau, kty,
                                                plan)


def structured_full_backward_step(s, y, q, sigma, ineq_mask, kx_new,
                                  kx_prev, *, plan=(), backend=None):
    """(y_new, kty) for the single-lane full problem (``sigma`` is [1])."""
    if _resolve_mode(backend, y) == "ref":
        return _ref.structured_full_backward_step(
            s, y, q, sigma[:, None], ineq_mask, kx_new, kx_prev, plan)
    from . import structured_full_pdhg_step as _kernel
    return _kernel.structured_full_backward_step(s, y, q, sigma, ineq_mask,
                                                 kx_new, kx_prev, plan)
