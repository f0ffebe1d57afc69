"""Load and launch the hand-written CUDA full-problem PDHG half-steps
(``csrc/structured_full_pdhg_step.cu``) — the port of the streaming kernels
of ``repro/kernels/structured_pdhg_step.py`` (``structured_full_forward_step``
:312, ``structured_full_backward_step`` :334).

The library is built at first use by :mod:`.build` (``nvcc`` for
``sm_90a``, loaded with ``ctypes``); nothing is built when this module is
imported, and a build failure raises.

Each wrapper takes one lane (``[1, ...]`` operands) of a
:class:`~repro_torch.core.pdhg.StructuredOperator` with f32, bf16 or int8
coefficients and the ragged wide-block ``plan`` of
``pdhg._wide_block_plans``.  It checks device, dtype, contiguity, every
shape, the plan and the fold map's values (the fold check syncs once per
fold tensor and is remembered while that tensor lives unmodified; the plan
is turned into a small device ``int32 [n_blocks, 3]`` array once per plan
and device), allocates its outputs and the wide partial sums with
``torch.empty``, launches on the current stream, raises on a nonzero
``cudaGetLastError`` and then adds one to its entry in :data:`LAUNCHES`.
Each call makes three CUDA launches (the tail, the wide bucket's partial
sums, then the narrow pass with the fold-map add-back; see the source's
note).
"""

from __future__ import annotations

import ctypes
import functools
import weakref

import torch

from . import build as _build

# launches of each wrapper since the counts were last set to 0
LAUNCHES = {"structured_full_forward_step": 0,
            "structured_full_backward_step": 0}

# the kernels' block size, rows per thread of a wide tile and most plan
# blocks (the source's kThreads, kWideIters and kMaxPlanBlocks)
THREADS = 256
WIDE_ITERS = 16
MAX_PLAN_BLOCKS = 4010

# coefficient storage codes of the C interface
_COEF = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

_lib = None
# fold maps whose values were checked: id -> (weakref, version, D)
_checked_folds: dict = {}


def library() -> ctypes.CDLL:
    """The kernels' shared library, built if needed, with its C
    signatures declared."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _build.load("structured_full_pdhg_step")
    p, i = ctypes.c_void_p, ctypes.c_int
    for name in ("structured_full_forward_step",
                 "structured_full_backward_step"):
        fn = getattr(lib, name)
        fn.argtypes = [i] + [p] * 17 + [i] * 7 + [p]
        fn.restype = i
    lib.structured_full_pdhg_error_string.argtypes = [i]
    lib.structured_full_pdhg_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


@functools.lru_cache(maxsize=64)
def plan_layout(plan: tuple, d: int, ww: int):
    """``(tc, n_tiles, n_chunks)`` of the wide pass for a ragged plan over a
    ``[ww, d]`` bucket: the tile's column count (a power of two up to 32,
    from the widest plan block), the tiles the plan holds and the most row
    chunks any column has.  Raises unless the plan's blocks tile
    ``[0, d)`` in order with widths in ``[0, ww]``."""
    if not plan:
        plan = ((0, d, ww),)
    c_prev = 0
    for c0, c1, wb in plan:
        if c0 != c_prev or c1 <= c0 or not 0 <= wb <= ww:
            raise ValueError(f"wide-block plan {plan} does not tile the "
                             f"[{ww}, {d}] bucket's columns in order")
        c_prev = c1
    if c_prev != d:
        raise ValueError(f"wide-block plan {plan} ends at column {c_prev}, "
                         f"the bucket has {d}")
    if len(plan) > MAX_PLAN_BLOCKS:
        raise ValueError(f"wide-block plan of {len(plan)} blocks; the "
                         f"kernels take at most {MAX_PLAN_BLOCKS}")
    widest = max(c1 - c0 for c0, c1, _ in plan)
    tc = min(32, 1 << (widest - 1).bit_length())
    rows = (THREADS // tc) * WIDE_ITERS
    n_tiles = sum(-(-(c1 - c0) // tc) * -(-wb // rows) for c0, c1, wb in plan)
    n_chunks = max(-(-wb // rows) for _, _, wb in plan)
    return tc, n_tiles, n_chunks


@functools.lru_cache(maxsize=64)
def plan_tensor(plan: tuple, d: int, ww: int,
                device: torch.device) -> torch.Tensor:
    """The plan as the kernels read it: ``int32 [n_blocks, 3]`` on
    ``device``, made once per plan and device."""
    plan = plan or ((0, d, ww),)
    return torch.tensor(plan, dtype=torch.int32, device=device)


def _check_fold(name: str, fold: torch.Tensor, d: int) -> None:
    """Raise unless every fold value lies in ``[0, d]`` (``d`` is the zero
    slot); one device sync the first time a fold tensor is seen."""
    seen = _checked_folds.get(id(fold))
    if seen is not None and seen[0]() is fold and seen[1:] == (fold._version,
                                                               d):
        return
    lo, hi = torch.stack([fold.min(), fold.max()]).tolist()
    if lo < 0 or hi > d:
        raise ValueError(f"{name}: fold map values span [{lo}, {hi}], "
                         f"outside [0, {d}]")
    for key in [k for k, v in _checked_folds.items() if v[0]() is None]:
        del _checked_folds[key]
    _checked_folds[id(fold)] = (weakref.ref(fold), fold._version, d)


def _ptr(t, dtypes, what: str) -> int:
    if t is None:
        return 0
    if not t.is_cuda or t.dtype not in dtypes or not t.is_contiguous():
        raise ValueError(
            f"{what} must be a contiguous CUDA tensor of "
            f"{[str(dt) for dt in dtypes]}; got {t.dtype} on {t.device} "
            f"(contiguous={t.is_contiguous()})")
    return t.data_ptr()


_F, _I, _U8 = (torch.float32,), (torch.int32,), (torch.uint8,)


def _launch(name, side, vecs, vec_dtypes, v_len, plan, ref):
    idx, val, scale, widx, wval, wscale, fold = side
    _, w, s_len = idx.shape if idx.ndim == 3 else (0, 0, -1)
    _, ww, d = widx.shape if widx.ndim == 3 else (0, 0, -1)
    coef = _COEF.get(val.dtype)
    int8 = val.dtype == torch.int8
    ok = (idx.shape[0] == 1 and s_len >= 0 and val.shape == idx.shape
          and widx.shape[0] == 1 and d >= 1
          and wval.shape == widx.shape and wval.dtype == val.dtype
          and coef is not None and fold is not None
          and fold.shape == (1, s_len)
          and all(sc is not None and sc.shape == (1, 1)
                  if int8 else sc is None for sc in (scale, wscale))
          and all(v.shape == (1, v_len) for v in vecs[:-1])
          and vecs[-1].shape == (1,))
    if not ok:
        raise ValueError(
            f"{name}: operands do not fit one lane of {v_len} vector "
            f"entries and {s_len} output segments: side "
            f"{[None if a is None else (tuple(a.shape), str(a.dtype)) for a in side]}, "
            f"vectors {[tuple(v.shape) for v in vecs]} (f32, bf16 or int8 "
            "coefficients; int8 needs its [1, 1] scales, the others none)")
    tc, n_tiles, n_chunks = plan_layout(tuple(plan), d, ww)
    _check_fold(name, fold, d)
    coef_dtypes = (val.dtype,)
    args = [_ptr(idx, _I, "indices"), _ptr(val, coef_dtypes, "coefficients"),
            _ptr(scale, _F, "scale"), _ptr(widx, _I, "wide indices"),
            _ptr(wval, coef_dtypes, "wide coefficients"),
            _ptr(wscale, _F, "wide scale"), _ptr(fold, _I, "fold map")]
    args += [_ptr(v, dt, "vector") for v, dt in zip(vecs, vec_dtypes)]
    lib = library()
    dev = ref.device
    plan_t = plan_tensor(tuple(plan), d, ww, dev)
    partial = torch.empty((max(n_chunks, 1), d), dtype=torch.float32,
                          device=dev)
    v_new = torch.empty((1, v_len), dtype=torch.float32, device=dev)
    out = torch.empty((1, s_len), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = getattr(lib, name)(
        coef, *args[:7], plan_t.data_ptr(), *args[7:], partial.data_ptr(),
        v_new.data_ptr(), out.data_ptr(), v_len, s_len, w, d,
        plan_t.shape[0], tc, n_tiles, stream)
    if err != 0:
        msg = lib.structured_full_pdhg_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({err}: {msg})")
    LAUNCHES[name] += 1
    return v_new, out


def structured_full_forward_step(s, x, c, l, u, tau, kty, plan=()):
    """(x_new [1, N], kx [1, M]) for the row side of the single-lane
    operator ``s``; x/c/l/u/kty [1, N] f32, tau [1] f32."""
    side = (s.row_idx, s.row_val, s.row_scale, s.wrow_idx, s.wrow_val,
            s.wrow_scale, s.row_fold)
    return _launch("structured_full_forward_step", side,
                   (x, c, l, u, kty, tau), (_F,) * 6, s.col_idx.shape[-1],
                   plan, x)


def structured_full_backward_step(s, y, q, sigma, ineq_mask, kx_new,
                                  kx_prev, plan=()):
    """(y_new [1, M], kty [1, N]) for the column side of ``s``;
    y/q/kx_new/kx_prev [1, M] f32, ineq_mask [1, M] bool, sigma [1] f32."""
    if ineq_mask.dtype != torch.bool:
        raise ValueError(f"structured_full_backward_step: ineq_mask must be "
                         f"bool, got {ineq_mask.dtype}")
    side = (s.col_idx, s.col_val, s.col_scale, s.wcol_idx, s.wcol_val,
            s.wcol_scale, s.col_fold)
    return _launch("structured_full_backward_step", side,
                   (y, q, ineq_mask.view(torch.uint8), kx_new, kx_prev,
                    sigma),
                   (_F, _F, _U8, _F, _F, _F), s.row_idx.shape[-1], plan, y)
