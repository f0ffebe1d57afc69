"""Load and launch the hand-written CUDA fused dense PDHG half-steps
(``csrc/fused_pdhg_step.cu``) — the port of
``repro/kernels/fused_pdhg_step.py`` (``fused_forward_step`` :87,
``fused_backward_step`` :116).

The library is built at first use by :mod:`.build` (``nvcc`` for
``sm_90a``, loaded with ``ctypes``); nothing is built when this module is
imported, and a build failure raises.

Each wrapper checks device, dtype, shape and contiguity (the checks of
:mod:`.pdhg_matvec`), allocates its outputs with ``torch.empty``, launches
on the current stream, raises on a nonzero ``cudaGetLastError`` and then
adds one to its entry in :data:`LAUNCHES`.  The forward call makes two CUDA
launches (the primal tail, then the row product); the backward call one
(the column product with the dual tail computed per block), or two when M
is cut into chunks (see the source's note).
"""

from __future__ import annotations

import ctypes

import torch

from . import build as _build
from .pdhg_matvec import (COEF, check_operands, col_chunks, raise_on_error,
                          stream_of)

# launches of each wrapper since the counts were last set to 0
LAUNCHES = {"fused_forward_step": 0, "fused_backward_step": 0}

_F, _U8 = torch.float32, torch.uint8
_lib = None


def library() -> ctypes.CDLL:
    """The kernels' shared library, built if needed, with its C
    signatures declared."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _build.load("fused_pdhg_step")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_forward_step.argtypes = [i] + [p] * 9 + [i] * 3 + [p]
    lib.fused_forward_step.restype = i
    lib.fused_backward_step.argtypes = [i] + [p] * 10 + [i] * 5 + [p]
    lib.fused_backward_step.restype = i
    lib.fused_pdhg_error_string.argtypes = [i]
    lib.fused_pdhg_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def fused_forward_step(A, x, c, l, u, tau, kty):
    """(x_new [k, N], kx [k, M]) for A [k, M, N]; x/c/l/u/kty [k, N] f32,
    tau [k] f32."""
    vecs = (x, c, l, u, kty, tau)
    k, m, n = check_operands(
        "fused_forward_step", A,
        tuple(zip(vecs, ("N",) * 5 + (None,))))
    lib = library()
    x_new = torch.empty((k, n), dtype=_F, device=A.device)
    kx = torch.empty((k, m), dtype=_F, device=A.device)
    err = lib.fused_forward_step(
        COEF[A.dtype], A.data_ptr(), *(v.data_ptr() for v in vecs),
        x_new.data_ptr(), kx.data_ptr(), k, m, n, stream_of(A))
    raise_on_error(lib, "fused_pdhg_error_string", "fused_forward_step", err)
    LAUNCHES["fused_forward_step"] += 1
    return x_new, kx


def fused_backward_step(A, y, q, sigma, ineq_mask, kx_new, kx_prev):
    """(y_new [k, M], kty [k, N]) for A [k, M, N]; y/q/kx_new/kx_prev
    [k, M] f32, ineq_mask [k, M] bool, sigma [k] f32."""
    if ineq_mask.dtype != torch.bool:
        raise ValueError(f"fused_backward_step: ineq_mask must be bool, got "
                         f"{ineq_mask.dtype}")
    vecs = (y, q, ineq_mask.view(_U8), kx_new, kx_prev, sigma)
    k, m, n = check_operands(
        "fused_backward_step", A,
        tuple(zip(vecs, ("M",) * 5 + (None,))),
        (_F, _F, _U8, _F, _F, _F))
    lib = library()
    rows, n_chunks = col_chunks(k, m, n)
    y_new = torch.empty((k, m), dtype=_F, device=A.device)
    kty = torch.empty((k, n), dtype=_F, device=A.device)
    part = (torch.empty((k, n_chunks, n), dtype=_F, device=A.device)
            if n_chunks > 1 else kty)
    err = lib.fused_backward_step(
        COEF[A.dtype], A.data_ptr(), *(v.data_ptr() for v in vecs),
        part.data_ptr(), y_new.data_ptr(), kty.data_ptr(), k, m, n, rows,
        n_chunks, stream_of(A))
    raise_on_error(lib, "fused_pdhg_error_string", "fused_backward_step", err)
    LAUNCHES["fused_backward_step"] += 1
    return y_new, kty
