"""Dispatch for the structured PDHG half-steps — the port of the
structured and full-problem subsets of ``repro/kernels/ops.py``.

``structured_forward_step`` / ``structured_backward_step`` (the k-lane
stack) and ``structured_full_forward_step`` /
``structured_full_backward_step`` (the single-lane full problem, with its
ragged wide-block ``plan``) take a ``backend`` keyword:

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

The reference pads lane axes to ``STRUCT_ALIGN=128`` and the full
problem's sides to sublane and ``FULL_BLOCK_*`` multiples for its VMEM
blocks; those are TPU layout rules and are not carried over — the CUDA
kernels mask their ragged edges themselves.
"""

from __future__ import annotations

from . import ref as _ref

_MODES = (None, "auto", "kernel", "ref")


def _resolve_mode(backend, tensor) -> str:
    """'kernel' | 'ref' from a user-facing backend name and the device of
    the tensors the call was given."""
    if backend not in _MODES:
        raise ValueError(f"unknown kernel backend {backend!r}; "
                         f"expected one of {_MODES}")
    on_cuda = tensor.device.type == "cuda"
    if backend in (None, "auto"):
        return "kernel" if on_cuda else "ref"
    if backend == "kernel" and not on_cuda:
        raise ValueError("backend='kernel' needs CUDA tensors; got tensors "
                         f"on {tensor.device}")
    return backend


def smatvec(s, x):
    """kx = K x through the row-side gather layout (plain torch)."""
    return _ref.smatvec(s, x)


def smatvec_t(s, y):
    """kty = K^T y through the column-side gather layout (plain torch)."""
    return _ref.smatvec_t(s, y)


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
