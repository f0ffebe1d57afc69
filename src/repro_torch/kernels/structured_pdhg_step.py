"""Load and launch the hand-written CUDA structured PDHG half-steps
(``csrc/structured_pdhg_step.cu``) — the port of the lane kernels of
``repro/kernels/structured_pdhg_step.py`` (``structured_forward_step``
:110, ``structured_backward_step`` :141).

The library is built at first use by :mod:`.build` (``nvcc`` for
``sm_90a``, loaded with ``ctypes``); nothing is built when this module is
imported, and a build failure raises.

Each wrapper checks device, dtype and contiguity, allocates its outputs
with ``torch.empty``, launches on the current stream, raises on a nonzero
``cudaGetLastError`` and then adds one to its entry in :data:`LAUNCHES`.
Each call makes two CUDA launches (narrow pass + tail, then the wide
bucket; see the source's note).
"""

from __future__ import annotations

import ctypes

import torch

from . import build as _build

# launches of each wrapper since the counts were last set to 0
LAUNCHES = {"structured_forward_step": 0, "structured_backward_step": 0}

_lib = None


def library() -> ctypes.CDLL:
    """The kernels' shared library, built if needed, with its C
    signatures declared."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _build.load("structured_pdhg_step")
    p, i = ctypes.c_void_p, ctypes.c_int
    for name in ("structured_forward_step", "structured_backward_step"):
        fn = getattr(lib, name)
        fn.argtypes = [p] * 13 + [i] * 6 + [p]
        fn.restype = i
    lib.structured_pdhg_error_string.argtypes = [i]
    lib.structured_pdhg_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def _ptrs(tensors, dtypes):
    """data_ptr()s after checking device, dtype and contiguity."""
    out = []
    for t, dt in zip(tensors, dtypes):
        if not t.is_cuda or t.dtype != dt or not t.is_contiguous():
            raise ValueError(
                f"kernel operand must be a contiguous CUDA {dt} tensor; got "
                f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
        out.append(t.data_ptr())
    return out


_F, _I, _U8 = torch.float32, torch.int32, torch.uint8


def _check_shapes(name, side, vecs, k, v_len, s_len):
    """The ELL side must be [k, W, s_len] / [k, Ww, D] / [k, D] and every
    lane vector [k, v_len] (the per-lane step size [k]); the kernels index
    by these sizes and would read out of bounds otherwise."""
    idx, val, widx, wval, wids = side
    d = wids.shape[-1] if wids.ndim == 2 else -1
    ok = (idx.ndim == 3 and idx.shape[0] == k and idx.shape[2] == s_len
          and val.shape == idx.shape and widx.ndim == 3
          and widx.shape[0] == k and widx.shape[2] == d
          and wval.shape == widx.shape and wids.shape == (k, d)
          and all(v.shape == (k, v_len) for v in vecs[:-1])
          and vecs[-1].shape == (k,))
    if not ok:
        raise ValueError(
            f"{name}: operand shapes do not fit k={k}, {v_len} vector "
            f"entries, {s_len} output segments: side "
            f"{[tuple(a.shape) for a in side]}, vectors "
            f"{[tuple(v.shape) for v in vecs]}")


def _launch(name, side, vecs, vec_dtypes, n_out_vec, n_out_seg, dims, ref):
    k = ref.shape[0]
    _check_shapes(name, side, vecs, k, n_out_vec, n_out_seg)
    lib = library()
    v_new = torch.empty((k, n_out_vec), dtype=_F, device=ref.device)
    out = torch.empty((k, n_out_seg), dtype=_F, device=ref.device)
    args = _ptrs(side, (_I, _F, _I, _F, _I)) + _ptrs(vecs, vec_dtypes)
    stream = torch.cuda.current_stream(ref.device).cuda_stream
    err = getattr(lib, name)(*args, v_new.data_ptr(), out.data_ptr(), k,
                             *dims, stream)
    if err != 0:
        msg = lib.structured_pdhg_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({err}: {msg})")
    LAUNCHES[name] += 1
    return v_new, out


def structured_forward_step(s, x, c, l, u, tau, kty):
    """(x_new [k, N], kx [k, M]) for the row side of ``s`` (batched
    StructuredOperator); x/c/l/u/kty [k, N] f32, tau [k] f32."""
    k, wr, m = s.row_idx.shape
    n = s.col_idx.shape[-1]
    side = (s.row_idx, s.row_val, s.wrow_idx, s.wrow_val, s.wrow_ids)
    return _launch("structured_forward_step", side, (x, c, l, u, kty, tau),
                   (_F,) * 6, n, m,
                   (n, m, wr, s.wrow_idx.shape[1], s.wrow_idx.shape[2]), x)


def structured_backward_step(s, y, q, sigma, ineq_mask, kx_new, kx_prev):
    """(y_new [k, M], kty [k, N]) for the column side of ``s``;
    y/q/kx_new/kx_prev [k, M] f32, ineq_mask [k, M] bool, sigma [k] f32."""
    k, wc, n = s.col_idx.shape
    m = s.row_idx.shape[-1]
    side = (s.col_idx, s.col_val, s.wcol_idx, s.wcol_val, s.wcol_ids)
    if ineq_mask.dtype != torch.bool:
        raise ValueError(f"structured_backward_step: ineq_mask must be "
                         f"bool, got {ineq_mask.dtype}")
    mask = ineq_mask.view(torch.uint8)
    return _launch("structured_backward_step", side,
                   (y, q, mask, kx_new, kx_prev, sigma),
                   (_F, _F, _U8, _F, _F, _F), m, n,
                   (m, n, wc, s.wcol_idx.shape[1], s.wcol_idx.shape[2]), y)
