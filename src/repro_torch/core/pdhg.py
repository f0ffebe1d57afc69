"""Restarted PDHG (PDLP-family) LP solver in PyTorch — the port of
``repro/core/pdhg.py``.

The math and the step-engine contract are the reference's, unchanged:
every array carries a leading ``[k]`` sub-problem axis, per-lane scalars
(step sizes) are ``[k]`` tensors, and an engine provides two half-steps
that each emit the product they materialise:

    forward(data, x, c, l, u, tau[k], kty)          -> (x_new, K x_new)
    backward(data, y, q, sigma[k], ineq, kx, kx_-)  -> (y_new, K^T y_new)

The reference's four engines are ported:

``matvec`` (:func:`matvec_engine`)
    The problem's own per-lane ``K_mv``/``KT_mv`` callables, applied lane
    by lane, with the element-wise tails in plain torch.
``fused`` (:func:`fused_dense_engine`)
    Dense operators (``op.data == (K,)``, K ``[k, M, N]``): each half-step
    and each out-of-loop product is ONE call into ``kernels/ops.py`` for
    the whole stack — the hand-written CUDA kernel on CUDA tensors, its
    plain torch version on CPU tensors.
``fused_structured`` (:func:`fused_structured_engine`)
    Operators carrying a :class:`StructuredOperator` (two-bucket ELL index
    metadata); each half-step is one ``kernels/ops.py`` call, as above.
``fused_structured_full`` (:func:`fused_structured_full_engine`)
    The single-lane full (k=1) problem with fold maps: each half-step is
    one streaming call over the narrow ELL and the ragged plan of the wide
    bucket, with int8/bf16 coefficient storage read as stored.

``select_engine`` keeps the reference's rule word for word, with the CUDA
device where the reference names the TPU: ``fused`` for dense operators
on the accelerator.

The reference's ``lax.while_loop`` becomes a Python loop over
``check_every``-iteration chunks with exactly one host sync per chunk (the
``any(~done & ~diverged & it < max_iters)`` test).  Results come back as
numpy arrays at the reference's :class:`SolveResult` fields.

Packing (``_pack_ell``/``_pack_side``) is the reference's numpy code,
verbatim, so the ELL arrays come out bit-equal to the reference's.
"""

from __future__ import annotations

import functools
import inspect
import threading
from typing import Any, Callable, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from ..kernels.ref import norm_last, row_reduce, sum_last
from .problem import BIG, LinearProgram


# --------------------------------------------------------------------------
# containers + tree helpers
# --------------------------------------------------------------------------

def map_arrays(fn: Callable, tree):
    """Apply ``fn`` to every array leaf of a (Named)tuple/list/dict tree;
    ``None`` leaves stay ``None``."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_arrays(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_arrays(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {key: map_arrays(fn, v) for key, v in tree.items()}
    return fn(tree)


def zip_arrays(fn: Callable, *trees):
    """``fn(*leaves)`` over several trees of identical structure."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(zip_arrays(fn, *vs) for vs in zip(*trees)))
    if isinstance(first, (tuple, list)):
        return type(first)(zip_arrays(fn, *vs) for vs in zip(*trees))
    if isinstance(first, dict):
        return {key: zip_arrays(fn, *(t[key] for t in trees))
                for key in first}
    return fn(*trees)


def to_device(tree, device):
    """Every tensor leaf of ``tree`` moved to ``device``."""
    return map_arrays(lambda a: a.to(device), tree)


class StructuredOperator(NamedTuple):
    """Index-array form of a sparse constraint matrix K ([M, N]) — the
    reference's skew-aware two-bucket ELL, field for field (see
    ``repro/core/pdhg.py:StructuredOperator``).  Arrays are nnz-major
    (``[..., W, M]``); padding entries carry ``idx 0, val 0.0``; wide
    bucket columns feed the segments named by ``w*_ids`` and are sorted by
    descending width; ``*_fold`` maps every segment to its bucket column
    or to the zero slot ``D``.  Indices are int32; coefficients are f32,
    or bf16 / int8 after :func:`quantize_structured` (int8 with a
    per-bucket f32 dequant scale in ``*_scale``, shape ``[..., 1]``)."""

    row_idx: torch.Tensor    # [..., Wr, M] int32 column ids feeding each row
    row_val: torch.Tensor    # [..., Wr, M] f32 / bf16 / int8 coefficients
    wrow_idx: torch.Tensor   # [..., Ww, Dr] wide-row bucket column ids
    wrow_val: torch.Tensor   # [..., Ww, Dr]
    wrow_ids: torch.Tensor   # [..., Dr] int32 row fed by each bucket column
    col_idx: torch.Tensor    # [..., Wc, N] int32 row ids feeding each column
    col_val: torch.Tensor    # [..., Wc, N]
    wcol_idx: torch.Tensor   # [..., Wv, Dc] wide-column bucket row ids
    wcol_val: torch.Tensor   # [..., Wv, Dc]
    wcol_ids: torch.Tensor   # [..., Dc] int32 column fed by each bucket column
    row_fold: Optional[torch.Tensor] = None   # [..., M] int32 bucket col or Dr
    col_fold: Optional[torch.Tensor] = None   # [..., N] int32 bucket col or Dc
    row_scale: Optional[torch.Tensor] = None  # [..., 1] f32 int8 dequant scales
    wrow_scale: Optional[torch.Tensor] = None
    col_scale: Optional[torch.Tensor] = None
    wcol_scale: Optional[torch.Tensor] = None

    @property
    def coef_dtype(self) -> str:
        return str(self.row_val.dtype).removeprefix("torch.")


def _pack_ell(seg: np.ndarray, other: np.ndarray, vals: np.ndarray,
              n_seg: int, width_mult: int = 8):
    """Pack COO entries grouped by ``seg`` into nnz-major ELL
    ``(idx [W, n_seg], val [W, n_seg])``; W rounds up to ``width_mult``."""
    order = np.argsort(seg, kind="stable")
    s = seg[order].astype(np.int64)
    o = other[order]
    v = vals[order]
    starts = np.searchsorted(s, np.arange(n_seg))
    pos = np.arange(s.size) - starts[s] if s.size else np.zeros(0, np.int64)
    w = int(pos.max()) + 1 if s.size else 1
    w = max(1, -(-w // width_mult) * width_mult)
    idx = np.zeros((w, n_seg), np.int32)
    val = np.zeros((w, n_seg), np.float32)
    idx[pos, s] = o
    val[pos, s] = v
    return idx, val


def _pack_side(seg: np.ndarray, other: np.ndarray, vals: np.ndarray,
               n_seg: int):
    """One gather side as the two-bucket ELL: segments wider than
    ``max(16, 4 * median nonzero width)`` go to the wide bucket, sorted by
    descending width.  Returns (idx, val, widx, wval, wids, fold)."""
    seg = seg.astype(np.int64)
    counts = np.bincount(seg, minlength=n_seg) if seg.size \
        else np.zeros(n_seg, np.int64)
    nz = counts[counts > 0]
    med = int(np.median(nz)) if nz.size else 1
    cap = max(16, 4 * (-(-med // 8) * 8))
    wide = np.flatnonzero(counts > cap)
    wide = wide[np.argsort(-counts[wide], kind="stable")]
    is_wide = np.isin(seg, wide)
    idx, val = _pack_ell(seg[~is_wide], other[~is_wide], vals[~is_wide],
                         n_seg)
    d = max(int(wide.size), 1)
    bucket_of = np.zeros(n_seg, np.int64)
    bucket_of[wide] = np.arange(wide.size)
    widx, wval = _pack_ell(bucket_of[seg[is_wide]], other[is_wide],
                           vals[is_wide], d)
    wids = np.zeros(d, np.int32)
    wids[: wide.size] = wide
    fold = np.full(n_seg, d, np.int32)
    fold[wide] = np.arange(wide.size)
    return idx, val, widx, wval, wids, fold


def structured_from_coo(rows, cols, vals, n_rows: int, n_cols: int,
                        coef_dtype: str = "float32") -> StructuredOperator:
    """Build a :class:`StructuredOperator` (CPU tensors) from COO triplets.
    Entries may repeat (they sum) and may carry zero values (kept).
    ``coef_dtype`` selects the coefficient storage
    (:func:`quantize_structured`)."""
    rows = np.asarray(rows).ravel()
    cols = np.asarray(cols).ravel()
    vals = np.asarray(vals, np.float32).ravel()
    ri, rv, wri, wrv, wrids, rfold = _pack_side(rows, cols, vals, n_rows)
    ci, cv, wci, wcv, wcids, cfold = _pack_side(cols, rows, vals, n_cols)
    t = torch.from_numpy
    s = StructuredOperator(
        row_idx=t(ri), row_val=t(rv),
        wrow_idx=t(wri), wrow_val=t(wrv), wrow_ids=t(wrids),
        col_idx=t(ci), col_val=t(cv),
        wcol_idx=t(wci), wcol_val=t(wcv), wcol_ids=t(wcids),
        row_fold=t(rfold), col_fold=t(cfold))
    return quantize_structured(s, coef_dtype)


# coefficient storage dtypes quantize_structured accepts
COEF_DTYPES = ("float32", "bfloat16", "int8")


def _quantize_val(val: torch.Tensor, dtype: str):
    """(stored, scale) for one coefficient bucket: bf16 is a plain cast
    (round to nearest even, scale None); int8 is symmetric per bucket,
    ``scale = max(|v|, 1e-30) / 127`` in f32 and the payload
    ``round(v / scale)`` (half to even) clipped to +-127 — the
    reference's arithmetic, so payloads and scales come out bit-equal."""
    v = val.to(torch.float32)
    if dtype == "bfloat16":
        return v.to(torch.bfloat16), None
    m = torch.amax(torch.abs(v), dim=(-2, -1))
    scale = torch.clamp_min(m, 1e-30) / 127.0
    q = torch.clamp(torch.round(v / scale[..., None, None]),
                    -127, 127).to(torch.int8)
    return q, scale.reshape(v.shape[:-2] + (1,))


def quantize_structured(s: StructuredOperator,
                        coef_dtype: str = "int8") -> StructuredOperator:
    """Re-store the four coefficient arrays as ``coef_dtype``: "bfloat16"
    (plain cast) or "int8" (symmetric per-bucket quantization, dequant
    scale in the ``*_scale`` fields); "float32" is the identity.  Only
    ``fused_structured_full`` streams the quantized payload (its kernels
    dequantize in-register, accumulating in f32); every other consumer
    dequantizes first.  Quantize from an f32 operator (re-quantizing a
    quantized one raises)."""
    if coef_dtype not in COEF_DTYPES:
        raise ValueError(f"unknown coef_dtype {coef_dtype!r}; "
                         f"expected one of {COEF_DTYPES}")
    if coef_dtype == "float32":
        return s
    if s.coef_dtype != "float32":
        raise ValueError(f"operator already stores {s.coef_dtype} "
                         "coefficients; dequantize_structured first")
    rv, rs = _quantize_val(s.row_val, coef_dtype)
    wrv, wrs = _quantize_val(s.wrow_val, coef_dtype)
    cv, cs = _quantize_val(s.col_val, coef_dtype)
    wcv, wcs = _quantize_val(s.wcol_val, coef_dtype)
    return s._replace(row_val=rv, wrow_val=wrv, col_val=cv, wcol_val=wcv,
                      row_scale=rs, wrow_scale=wrs,
                      col_scale=cs, wcol_scale=wcs)


def dequantize_structured(s: StructuredOperator) -> StructuredOperator:
    """Back to plain f32 coefficient storage (scales folded in, scale
    fields cleared).  Identity for f32 operators."""
    from ..kernels.ref import _deq
    if s.coef_dtype == "float32" and s.row_scale is None:
        return s
    return s._replace(
        row_val=_deq(s.row_val, s.row_scale),
        wrow_val=_deq(s.wrow_val, s.wrow_scale),
        col_val=_deq(s.col_val, s.col_scale),
        wcol_val=_deq(s.wcol_val, s.wcol_scale),
        row_scale=None, wrow_scale=None, col_scale=None, wcol_scale=None)


def structured_to_dense(s: StructuredOperator) -> torch.Tensor:
    """Materialise the dense K ([..., M, N]) from the row-side layout
    (tests only; never on the solve path)."""
    s = dequantize_structured(s)
    n_cols = s.col_idx.shape[-1]

    def one(ri, rv, wri, wrv, wrids):
        m = ri.shape[1]
        rows = torch.arange(m).expand(ri.shape)
        k0 = torch.zeros((m, n_cols), dtype=rv.dtype)
        k0.index_put_((rows.reshape(-1), ri.reshape(-1).long()),
                      rv.reshape(-1), accumulate=True)
        wrows = wrids.expand(wri.shape)
        k0.index_put_((wrows.reshape(-1).long(), wri.reshape(-1).long()),
                      wrv.reshape(-1), accumulate=True)
        return k0

    side = (s.row_idx, s.row_val, s.wrow_idx, s.wrow_val, s.wrow_ids)
    side = tuple(a.cpu() for a in side)
    if s.row_idx.ndim == 2:
        return one(*side)
    return torch.stack([one(*(a[i] for a in side))
                        for i in range(side[0].shape[0])])


def scale_structured(s: StructuredOperator, d_r: torch.Tensor,
                     d_c: torch.Tensor) -> StructuredOperator:
    """K~ = D_r K D_c applied to the ELL payload (batched: d_r [k, M],
    d_c [k, N]).  Padded entries stay zero, so fold maps and the wide-block
    plan stay valid.  Quantized storage is dequantized first: the scaled
    products are not int8-representable, so the scaled operator is f32."""
    from ..kernels.ref import _bgather as bgather
    s = dequantize_structured(s)
    return s._replace(
        row_val=s.row_val * d_r[:, None, :] * bgather(d_c, s.row_idx),
        wrow_val=(s.wrow_val * bgather(d_r, s.wrow_ids)[:, None, :]
                  * bgather(d_c, s.wrow_idx)),
        col_val=s.col_val * d_c[:, None, :] * bgather(d_r, s.col_idx),
        wcol_val=(s.wcol_val * bgather(d_c, s.wcol_ids)[:, None, :]
                  * bgather(d_r, s.wcol_idx)))


class OperatorLP(NamedTuple):
    """LP in operator form.  ``data`` is whatever the K_mv/KT_mv callables
    need; ``structured`` is the optional ELL metadata the
    ``fused_structured`` engine runs on.  All leaves batch on ``[k]``."""

    c: torch.Tensor          # [N]
    q: torch.Tensor          # [M]    rhs for K rows
    l: torch.Tensor          # [N]
    u: torch.Tensor          # [N]
    ineq_mask: torch.Tensor  # [M] bool: True -> dual projected >= 0
    data: Any                # operator payload tree
    structured: Optional[StructuredOperator] = None


def dense_ops(lp: LinearProgram) -> OperatorLP:
    """The operator form of a dense :class:`LinearProgram`:
    ``data = (K,)`` with ``K = [G; A]``."""
    K, q, ineq = lp.stacked()
    return OperatorLP(c=lp.c, q=q, l=lp.l, u=lp.u, ineq_mask=ineq, data=(K,))


def dense_K_mv(data, x):
    (K,) = data
    return K @ x


def dense_KT_mv(data, y):
    (K,) = data
    return K.T @ y


def _pad_to(a: torch.Tensor, shape) -> torch.Tensor:
    pad = []
    for size, target in reversed(list(zip(a.shape, shape))):
        pad += [0, target - size]
    return torch.nn.functional.pad(a, pad) if any(pad) else a


def stack_ops(subs: Sequence[OperatorLP]) -> OperatorLP:
    """Stack identically-shaped sub-LPs on a leading [k] axis, padding the
    data-dependent ELL widths to the stack maximum first (padding entries
    are ``idx 0, val 0.0`` no-ops; fold maps stay lane-correct).  Lanes
    with mixed coefficient storage cannot stack (int8 next to f32): the
    whole stack is dequantized to f32 then."""
    subs = list(subs)
    structs = [s.structured for s in subs]
    bare = [s._replace(structured=None) for s in subs]
    ops = zip_arrays(lambda *xs: torch.stack(xs), *bare)
    if any(st is None for st in structs):
        return ops
    if len({st.coef_dtype for st in structs}) > 1:
        structs = [dequantize_structured(st) for st in structs]
    stacked = {}
    for f in StructuredOperator._fields:
        vals = [getattr(st, f) for st in structs]
        if any(v is None for v in vals):
            stacked[f] = None
            continue
        shape = tuple(max(v.shape[d] for v in vals)
                      for d in range(vals[0].ndim))
        stacked[f] = torch.stack([_pad_to(v, shape) for v in vals])
    return ops._replace(structured=StructuredOperator(**stacked))


def concat_stacks(stacks: Sequence[OperatorLP]) -> OperatorLP:
    """Concatenate already-stacked OperatorLPs (leading ``[k_i]`` axes) into
    one ``[sum k_i]`` stack: the cross-tenant analogue of :func:`stack_ops`,
    used by the serving dispatcher to put concurrent tenants' stacks into
    one launch.  The data-dependent trailing ELL widths and wide-bucket
    counts pad to the maximum across stacks with ``idx 0, val 0.0``
    entries; each lane's fold map keeps pointing at its own zero slot,
    which stays a zero column of the widened wide arrays.  Lanes are
    independent in :func:`solve_stacked`, so no lane's trajectory depends
    on who shares its launch.  A stack without structured metadata drops
    it from the result; mixed coefficient storage is dequantized to f32
    first (both as :func:`stack_ops`)."""
    stacks = list(stacks)
    if len(stacks) == 1:
        return stacks[0]
    structs = [s.structured for s in stacks]
    bare = [s._replace(structured=None) for s in stacks]
    ops = zip_arrays(lambda *xs: torch.cat(xs), *bare)
    if any(st is None for st in structs):
        return ops
    if len({st.coef_dtype for st in structs}) > 1:
        structs = [dequantize_structured(st) for st in structs]
    merged = {}
    for f in StructuredOperator._fields:
        vals = [getattr(st, f) for st in structs]
        if any(v is None for v in vals):
            merged[f] = None
            continue
        trail = tuple(max(v.shape[d] for v in vals)
                      for d in range(1, vals[0].ndim))
        merged[f] = torch.cat([_pad_to(v, (v.shape[0],) + trail)
                               for v in vals])
    return ops._replace(structured=StructuredOperator(**merged))


class SolveResult(NamedTuple):
    """Solver outcome as numpy arrays (the reference's fields)."""

    x: np.ndarray
    y: np.ndarray
    primal_obj: np.ndarray
    dual_obj: np.ndarray
    primal_res: np.ndarray    # relative primal infeasibility
    gap: np.ndarray           # relative duality gap
    iterations: np.ndarray
    converged: np.ndarray
    n_restarts: Optional[np.ndarray] = None   # [k] adaptive-restart count
    diverged: Optional[np.ndarray] = None     # [k] lane quarantined in-loop


# --------------------------------------------------------------------------
# step engines
# --------------------------------------------------------------------------

class StepEngine(NamedTuple):
    """Batched inner-loop math (see the module docstring): ``K``/``KT``
    products, the two product-emitting half-steps, the optional
    equilibration payload scaler ``scale_data(data, d_r, d_c)`` and the
    optional one-time ``prep(op)`` normaliser."""

    name: str
    K: Callable
    KT: Callable
    forward: Callable
    backward: Callable
    scale_data: Optional[Callable] = None
    prep: Optional[Callable] = None


# every builder made by _memoized, in definition order: the cache misses
# analysis/runtime.py's retrace_guard counts as builds
MEMOIZED: list = []


def _memoized(maxsize: int) -> Callable:
    """``functools.lru_cache`` whose misses run one at a time: a step engine
    is keyed by its identity (the serving dispatcher shares a launch only
    between tenants whose engines are the same object), and two threads
    that miss an unlocked cache together would each build their own.  The
    builder is listed in :data:`MEMOIZED`."""
    def deco(fn: Callable) -> Callable:
        cached = functools.lru_cache(maxsize=maxsize)(fn)
        lock = threading.Lock()

        @functools.wraps(fn)
        def memoized(*args, **kw):
            with lock:
                return cached(*args, **kw)

        memoized.cache_clear = cached.cache_clear
        memoized.cache_info = cached.cache_info
        MEMOIZED.append(memoized)
        return memoized
    return deco


def _engine_from_matvecs(name: str, bK: Callable, bKT: Callable,
                         scale_data: Optional[Callable] = None,
                         prep: Optional[Callable] = None) -> StepEngine:
    """Build the element-wise half-step tails from batched matvecs."""
    from ..kernels import ref

    def forward(data, x, c, l, u, tau, kty):
        x_new = ref.primal_tail(x, c, l, u, tau[:, None], kty)
        return x_new, bK(data, x_new)

    def backward(data, y, q, sigma, ineq_mask, kx_new, kx_prev):
        y_new = ref.dual_tail(y, q, sigma[:, None], ineq_mask, kx_new,
                              kx_prev)
        return y_new, bKT(data, y_new)

    return StepEngine(name, bK, bKT, forward, backward, scale_data, prep)


def _lanewise(fn: Callable) -> Callable:
    """Batched form of a per-lane matvec ``fn(data, v)``: applied lane by
    lane over the leading [k] axis (the reference vmaps it)."""
    def batched(data, v):
        return torch.stack([fn(map_arrays(lambda a, i=i: a[i], data), v[i])
                            for i in range(v.shape[0])])
    return batched


def _stacked(fn: Callable) -> Callable:
    """The batched form of a per-lane matvec: its own ``stacked`` form
    where it carries one (load balancing's), else :func:`_lanewise`."""
    return getattr(fn, "stacked", None) or _lanewise(fn)


@_memoized(maxsize=64)
def matvec_engine(K_mv: Callable = dense_K_mv,
                  KT_mv: Callable = dense_KT_mv) -> StepEngine:
    """Generic operator engine over the problem's per-lane matvecs;
    memoized on matvec identity (one engine object per matvec pair)."""
    return _engine_from_matvecs("matvec", _stacked(K_mv), _stacked(KT_mv))


@_memoized(maxsize=16)
def fused_dense_engine(kernel_backend: Optional[str] = None) -> StepEngine:
    """Dense engine: ``op.data == (K,)`` with K ``[k, M, N]`` (f32 or bf16).
    ``K``/``KT`` (the power iteration, the equilibration probes, the final
    KKT report) and the two half-steps are each ONE ``kernels/ops.py``
    call for the whole stack.  ``kernel_backend`` is the ``kernels/ops.py``
    backend (``None``: the CUDA kernel on CUDA tensors, the plain version
    on CPU tensors; "ref" forces the plain version).  Memoized, so
    repeated resolutions return the same object."""
    from ..kernels import ops as kops

    def K(data, x):
        return kops.bmatvec(data[0], x, backend=kernel_backend)

    def KT(data, y):
        return kops.bmatvec_t(data[0], y, backend=kernel_backend)

    def forward(data, x, c, l, u, tau, kty):
        return kops.fused_forward_step(data[0], x, c, l, u, tau, kty,
                                       backend=kernel_backend)

    def backward(data, y, q, sigma, ineq_mask, kx_new, kx_prev):
        return kops.fused_backward_step(data[0], y, q, sigma, ineq_mask,
                                        kx_new, kx_prev,
                                        backend=kernel_backend)

    def scale_data(data, d_r, d_c):
        (K_,) = data
        return (K_ * d_r[..., :, None] * d_c[..., None, :],)

    return StepEngine("fused", K, KT, forward, backward, scale_data)


@_memoized(maxsize=4)
def fused_structured_engine(kernel_backend: Optional[str] = None
                            ) -> StepEngine:
    """Structured engine: one ``kernels/ops.py`` call per half-step across
    the whole k-lane stack (hand-written CUDA kernel on CUDA tensors, plain
    torch on CPU tensors; ``kernel_backend="ref"`` forces the plain
    version, what ``chip_smoke.py`` holds a solve against on the card).
    ``prep`` moves ``op.structured`` into ``op.data``."""
    from ..kernels import ops as kops

    def K(data, x):
        return kops.smatvec(data, x)

    def KT(data, y):
        return kops.smatvec_t(data, y)

    def forward(data, x, c, l, u, tau, kty):
        return kops.structured_forward_step(data, x, c, l, u, tau, kty,
                                            backend=kernel_backend)

    def backward(data, y, q, sigma, ineq_mask, kx_new, kx_prev):
        return kops.structured_backward_step(data, y, q, sigma, ineq_mask,
                                             kx_new, kx_prev,
                                             backend=kernel_backend)

    def prep(op: OperatorLP) -> OperatorLP:
        return op._replace(data=dequantize_structured(op.structured),
                           structured=None)

    return StepEngine("fused_structured", K, KT, forward, backward,
                      scale_structured, prep)


@_memoized(maxsize=16)
def fused_structured_full_engine(kernel_backend: Optional[str] = None,
                                 row_plan: tuple = (),
                                 col_plan: tuple = ()) -> StepEngine:
    """Single-lane streaming engine for the **full** (k=1) problem: each
    half-step is ONE ``kernels/ops.py`` call (the hand-written CUDA kernel
    on CUDA tensors, the plain torch version on CPU tensors) that reduces
    the narrow ELL and the ragged plan of the wide bucket and folds the
    wide sums back through the fold map — no one-hot, no scatter.

    ``row_plan`` / ``col_plan`` are the ragged wide-block plans
    ``((c0, c1, wb), ...)`` of :func:`_wide_block_plans`, computed by
    :func:`resolve_engine` from the concrete operator.  ``kernel_backend``
    is the ``kernels/ops.py`` backend of the two half-steps (``None``:
    the kernel on CUDA tensors, the plain version on CPU tensors; "ref"
    forces the plain version, what ``chip_smoke.py`` holds a solve
    against on the card).  ``prep`` moves
    ``op.structured`` into ``op.data`` with quantized payloads passed
    through (the kernels dequantize in-register); equilibration scales a
    dequantized copy, whose zeros stay where the plan expects them."""
    from ..kernels import ops as kops

    def K(data, x):
        return kops.smatvec_full(data, x, plan=row_plan)

    def KT(data, y):
        return kops.smatvec_t_full(data, y, plan=col_plan)

    def forward(data, x, c, l, u, tau, kty):
        return kops.structured_full_forward_step(
            data, x, c, l, u, tau, kty, plan=row_plan, backend=kernel_backend)

    def backward(data, y, q, sigma, ineq_mask, kx_new, kx_prev):
        return kops.structured_full_backward_step(
            data, y, q, sigma, ineq_mask, kx_new, kx_prev, plan=col_plan,
            backend=kernel_backend)

    def prep(op: OperatorLP) -> OperatorLP:
        return op._replace(data=op.structured, structured=None)

    return StepEngine("fused_structured_full", K, KT, forward, backward,
                      scale_structured, prep)


# auto picks fused_structured_full only above this many stored wide-bucket
# elements (the reference's constant)
FULL_ENGINE_MIN_WIDE_ELEMS = 65_536
# column chunk the ragged wide-block plan is cut into
WIDE_BLOCK_COLS = 128


def _is_single_lane(op: OperatorLP) -> bool:
    return op.c.ndim == 1 or op.c.shape[0] == 1


def _wide_elems(s: StructuredOperator) -> int:
    return (s.wrow_idx.shape[-2] * s.wrow_idx.shape[-1]
            + s.wcol_idx.shape[-2] * s.wcol_idx.shape[-1])


def _block_widths(wval: torch.Tensor) -> torch.Tensor:
    """Per plan block (:data:`WIDE_BLOCK_COLS` bucket columns) the largest
    effective column width — the index of the column's last nonzero plus
    one, 0 for an all-zero column — computed where ``wval`` lives, with no
    host sync.  ``wval`` is one lane's ``[Ww, D]`` (or ``[1, Ww, D]``)."""
    v = wval[0] if wval.ndim == 3 else wval
    ww, d = v.shape
    rows = torch.arange(1, ww + 1, dtype=torch.int32, device=v.device)
    counts = torch.where(v != 0, rows[:, None], 0).amax(dim=0)     # [D]
    n_blocks = -(-d // WIDE_BLOCK_COLS)
    counts = torch.nn.functional.pad(counts, (0, n_blocks * WIDE_BLOCK_COLS
                                              - d))
    return counts.reshape(n_blocks, WIDE_BLOCK_COLS).amax(dim=1)


def _plan_from_widths(widths: Sequence[int], ww: int, d: int) -> tuple:
    """The ragged plan ``((c0, c1, wb), ...)``: block ``b`` covers columns
    ``[128 b, 128 (b + 1))`` at its largest width rounded up to a multiple
    of 8 (at least 8, at most the stored depth ``ww``)."""
    plan = []
    for b, wmax in enumerate(widths):
        c0 = b * WIDE_BLOCK_COLS
        c1 = min(c0 + WIDE_BLOCK_COLS, d)
        plan.append((c0, c1, min(max(8, -(-int(wmax) // 8) * 8), ww)))
    return tuple(plan) if plan else ((0, d, ww),)


def _wide_block_plans(s: StructuredOperator):
    """``(row_plan, col_plan)``: the reference's ragged wide-block plan
    (``repro/core/pdhg.py:_wide_block_plan``) of each wide bucket's
    descending-width columns: chunks of :data:`WIDE_BLOCK_COLS` columns,
    each sliced to its own largest effective width (from ``val != 0`` —
    exact, since zero coefficients contribute nothing) rounded up to a
    multiple of 8.  The widths are reduced on the payload's device; only
    the two ``[n_blocks]`` results cross to the host, in ONE sync."""
    rw, cw = _block_widths(s.wrow_val), _block_widths(s.wcol_val)
    widths = torch.cat([rw, cw]).tolist()
    (wwr, dr), (wwc, dc) = s.wrow_val.shape[-2:], s.wcol_val.shape[-2:]
    return (_plan_from_widths(widths[:rw.shape[0]], wwr, dr),
            _plan_from_widths(widths[rw.shape[0]:], wwc, dc))


def _leaves(tree) -> list:
    out: list = []
    map_arrays(out.append, tree)
    return out


def is_dense_ops(op: OperatorLP) -> bool:
    """True iff ``op.data`` is a single dense [..., M, N] matrix."""
    leaves = _leaves(op.data)
    if len(leaves) != 1:
        return False
    K = leaves[0]
    return (K.ndim == op.c.ndim + 1
            and K.shape[-1] == op.c.shape[-1]
            and K.shape[-2] == op.q.shape[-1])


def select_engine(op: OperatorLP, K_mv: Callable = dense_K_mv,
                  KT_mv: Callable = dense_KT_mv) -> str:
    """``engine="auto"`` rule, as the reference words it: a
    ``preferred_engine`` attribute on ``K_mv`` wins outright; ``fused``
    needs dense data AND the dense matvecs AND the accelerator (the
    reference's TPU; here the CUDA device); operators carrying
    :class:`StructuredOperator` metadata take ``fused_structured`` —
    or, when single-lane with fold maps and at least
    :data:`FULL_ENGINE_MIN_WIDE_ELEMS` wide-bucket elements,
    ``fused_structured_full``; everything else takes ``matvec``."""
    pref = getattr(K_mv, "preferred_engine", None)
    if pref is not None:
        return pref
    dense = (K_mv is dense_K_mv and KT_mv is dense_KT_mv and is_dense_ops(op))
    if dense and op.c.device.type == "cuda":
        return "fused"
    if op.structured is not None:
        s = op.structured
        if (_is_single_lane(op) and s.row_fold is not None
                and _wide_elems(s) >= FULL_ENGINE_MIN_WIDE_ELEMS):
            return "fused_structured_full"
        return "fused_structured"
    return "matvec"


# the engine spec strings resolve_engine accepts — what ExecConfig validates
ENGINE_NAMES = ("auto", "matvec", "fused", "fused_structured",
                "fused_structured_full")

def engine_name(engine: Union[str, "StepEngine"]) -> str:
    return engine if isinstance(engine, str) else engine.name


def resolve_engine(engine: Union[None, str, StepEngine], op: OperatorLP,
                   K_mv: Callable = dense_K_mv,
                   KT_mv: Callable = dense_KT_mv) -> StepEngine:
    """Normalise an engine spec to a :class:`StepEngine`; an engine whose
    operator layout does not fit raises ``ValueError`` (no other engine is
    substituted).  For ``fused_structured_full`` this is also where the
    ragged wide-block plans are computed from the concrete operator (one
    host sync)."""
    if isinstance(engine, StepEngine):
        return engine
    if engine is None or engine == "auto":
        engine = select_engine(op, K_mv, KT_mv)
    if engine == "matvec":
        return matvec_engine(K_mv, KT_mv)
    if engine == "fused":
        if not is_dense_ops(op):
            raise ValueError(
                "engine='fused' needs dense operator data (op.data == (K,) "
                "with K [..., M, N]); structured operators use "
                "engine='matvec' or 'fused_structured'")
        return fused_dense_engine()
    if engine == "fused_structured":
        if op.structured is None:
            raise ValueError(
                "engine='fused_structured' needs op.structured "
                "(StructuredOperator index metadata attached by the "
                "problem's build_sub); operators without it use "
                "engine='matvec'")
        return fused_structured_engine()
    if engine == "fused_structured_full":
        s = op.structured
        if s is None or s.row_fold is None:
            raise ValueError(
                "engine='fused_structured_full' needs op.structured with "
                "fold maps (operators built by structured_from_coo); "
                "operators without it use engine='matvec'")
        if not _is_single_lane(op):
            raise ValueError(
                "engine='fused_structured_full' streams the single-lane "
                "full problem (k=1); stacked sub-problems use "
                "engine='fused_structured'")
        return fused_structured_full_engine(None, *_wide_block_plans(s))
    raise ValueError(f"unknown engine {engine!r}; expected 'auto', "
                     "'matvec', 'fused', 'fused_structured', "
                     "'fused_structured_full', or a StepEngine")


# --------------------------------------------------------------------------
# scaling helpers
# --------------------------------------------------------------------------

def scale_operator(op: OperatorLP, d_r: torch.Tensor, d_c: torch.Tensor,
                   data: Any = None) -> OperatorLP:
    """K~ = D_r K D_c on the LP fields; BIG-sentinel bounds stay as they
    are; ``op.structured`` is dropped (it describes the unscaled K)."""
    keep_l = torch.abs(op.l) >= 0.5 * BIG
    keep_u = torch.abs(op.u) >= 0.5 * BIG
    return OperatorLP(
        c=op.c * d_c, q=op.q * d_r,
        l=torch.where(keep_l, op.l, op.l / d_c),
        u=torch.where(keep_u, op.u, op.u / d_c),
        ineq_mask=op.ineq_mask,
        data=op.data if data is None else data,
        structured=None)


def scale_warm_start(x: torch.Tensor, y: torch.Tensor, d_r, d_c):
    """Original-space iterates -> scaled space (inverse of unscale)."""
    return x / d_c, y / d_r


def unscale_solution(x: torch.Tensor, y: torch.Tensor, d_r, d_c):
    """Scaled-space iterates -> original space: x = d_c x~, y = d_r y~."""
    return d_c * x, d_r * y


# --------------------------------------------------------------------------
# internals (batched over the leading [k] axis)
# --------------------------------------------------------------------------

def _vnorm(a: torch.Tensor) -> torch.Tensor:
    """Per-sub-problem 2-norm: [k, n] -> [k], each lane's the same whatever
    the lane count (``kernels/ref.py:row_reduce``)."""
    return row_reduce(norm_last, a)


def _lane_sum(a: torch.Tensor) -> torch.Tensor:
    """Per-sub-problem sum: [k, n] -> [k], as :func:`_vnorm`."""
    return row_reduce(sum_last, a)


def _bcast(cond: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return cond.reshape(cond.shape + (1,) * (like.ndim - cond.ndim))


def _power_iteration(engine: StepEngine, data, k: int, n_var: int,
                     device, iters: int = 30):
    """||K||_2 per lane via power iteration on K^T K."""
    v = torch.full((k, n_var), float(1.0 / np.sqrt(np.float32(n_var))),
                   dtype=torch.float32, device=device)
    for _ in range(iters):
        w = engine.KT(data, engine.K(data, v))
        v = w / (_vnorm(w)[:, None] + 1e-30)
    return torch.sqrt(_vnorm(engine.KT(data, engine.K(data, v)))) + 1e-12


def _kkt_from_products(op: OperatorLP, x, y, kx, kty):
    """(primal_res_rel, gap_rel, primal_obj, dual_obj), each [k], from
    the products ``kx = K x`` / ``kty = K^T y``."""
    resid = kx - op.q
    prim_viol = torch.where(op.ineq_mask, torch.clamp_min(resid, 0.0), resid)
    q_eff = torch.where(torch.abs(op.q) >= 0.5 * BIG,
                        torch.zeros_like(op.q), op.q)
    prim_res = _vnorm(prim_viol) / (1.0 + _vnorm(q_eff))
    r = op.c + kty
    p_obj = _lane_sum(op.c * x)
    d_obj = (-_lane_sum(op.q * y)
             + _lane_sum(torch.minimum(op.l * r, op.u * r)))
    gap = torch.abs(p_obj - d_obj) / (1.0 + torch.abs(p_obj)
                                      + torch.abs(d_obj))
    return prim_res, gap, p_obj, d_obj


def _kkt(op: OperatorLP, engine: StepEngine, x, y):
    """KKT scores via fresh operator passes."""
    return _kkt_from_products(op, x, y, engine.K(op.data, x),
                              engine.KT(op.data, y))


class _State(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    kx: torch.Tensor          # carried K x
    kty: torch.Tensor         # carried K^T y
    x_sum: torch.Tensor
    y_sum: torch.Tensor
    kx_sum: torch.Tensor      # running product sums (linearity of K)
    kty_sum: torch.Tensor
    avg_n: torch.Tensor       # [k] iterations accumulated since restart
    x_anchor: torch.Tensor
    y_anchor: torch.Tensor
    omega: torch.Tensor       # [k] primal weight
    last_score: torch.Tensor  # [k]
    it: torch.Tensor          # [k] int32
    done: torch.Tensor        # [k] bool
    n_restarts: torch.Tensor  # [k] int32
    prim_res: torch.Tensor
    gap: torch.Tensor
    best_score: torch.Tensor  # [k]
    diverged: torch.Tensor    # [k] bool


def rademacher_probes(iters: int, n_probes: int, n_var: int, n_con: int):
    """Rademacher probe pairs ``[(vs [n_probes, n_var], us [n_probes,
    n_con]), ...]`` (one pair per equilibration sweep, CPU f32) drawn from
    a ``torch.Generator`` seeded 7.  The reference draws its probes from
    ``jax.random.PRNGKey(7)``; those bits cannot be reproduced here, so
    parity tests replace this helper with the reference's probes."""
    gen = torch.Generator().manual_seed(7)

    def draw(n):
        bits = torch.randint(0, 2, (n_probes, n), generator=gen)
        return bits.to(torch.float32) * 2.0 - 1.0

    return [(draw(n_var), draw(n_con)) for _ in range(iters)]


def _to_device(a: torch.Tensor, device) -> torch.Tensor:
    """A host tensor on ``device``: onto a card through pinned memory, so
    the copy is queued on the stream without a host sync (a pageable copy
    waits for it), with the same bits."""
    if torch.device(device).type != "cuda":
        return a.to(device)
    return a.pin_memory().to(device, non_blocking=True)


def _equilibrate(engine: StepEngine, op: OperatorLP,
                 iters: int = 2, n_probes: int = 4):
    """Operator-form Ruiz equilibration from matvec probes (Hutchinson);
    the same probe vectors are shared across the k lanes."""
    n_var = op.c.shape[-1]
    n_con = op.q.shape[-1]
    d_r = torch.ones_like(op.q)
    d_c = torch.ones_like(op.c)
    dev = op.c.device
    for vs, us in rademacher_probes(iters, n_probes, n_var, n_con):
        vs, us = _to_device(vs, dev), _to_device(us, dev)
        rows = torch.stack([torch.square(d_r * engine.K(op.data, d_c * v))
                            for v in vs]).mean(dim=0)
        cols = torch.stack([torch.square(d_c * engine.KT(op.data, d_r * u))
                            for u in us]).mean(dim=0)
        rn, cn = torch.sqrt(rows), torch.sqrt(cols)
        d_r = d_r / torch.sqrt(torch.where(rn > 1e-8, rn,
                                           torch.ones_like(rn)))
        d_c = d_c / torch.sqrt(torch.where(cn > 1e-8, cn,
                                           torch.ones_like(cn)))
    return d_r, d_c


def _as_f32(a, device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def _np(a: torch.Tensor) -> np.ndarray:
    return a.detach().cpu().numpy()


def solve_stacked(
    op: OperatorLP,
    engine: Union[None, str, StepEngine] = None,
    K_mv: Callable = dense_K_mv,
    KT_mv: Callable = dense_KT_mv,
    *,
    max_iters: int = 20_000,
    check_every: int = 40,
    tol_primal: float = 1e-4,
    tol_gap: float = 1e-4,
    eta: float = 0.9,
    omega0: float = 1.0,
    equilibrate: bool = False,
    warm_x=None,
    warm_y=None,
    warm_mask=None,
    kkt: str = "inloop",
    divergence_ratio: float = 1e4,
) -> SolveResult:
    """Solve a STACK of k LPs at once on the device ``op`` lives on (every
    leaf has a leading [k] axis; the numpy result carries the same axis).
    Per-lane step sizes, restarts, primal weights, termination and the
    divergence guard are the reference's (``repro/core/pdhg.py:
    solve_stacked``).  ``warm_mask`` ([k] bool) starts False lanes cold.
    ``kkt="standalone"`` re-derives the current candidate's products with
    fresh operator passes each check (the verification mode).

    One host sync per ``check_every`` chunk decides whether to go on."""
    if kkt not in ("inloop", "standalone"):
        raise ValueError(f"unknown kkt mode {kkt!r}; "
                         "expected 'inloop' or 'standalone'")
    eng = resolve_engine(engine, op, K_mv, KT_mv)
    if eng.prep is not None:
        op = eng.prep(op)
    k = op.c.shape[0]
    n_var = op.c.shape[-1]
    dev = op.c.device

    op_run, eng_run = op, eng
    if equilibrate:
        d_r, d_c = _equilibrate(eng, op)
        if eng.scale_data is not None:
            op_run = scale_operator(op, d_r, d_c,
                                    data=eng.scale_data(op.data, d_r, d_c))
        else:
            op_run = scale_operator(op, d_r, d_c)
            eng_run = _engine_from_matvecs(
                eng.name + "_scaled",
                lambda data, x: d_r * eng.K(data, d_c * x),
                lambda data, y: d_c * eng.KT(data, d_r * y))
        # warm iterates arrive in ORIGINAL space — map into scaled space
        if warm_x is not None:
            warm_x = _as_f32(warm_x, dev) / d_c
        if warm_y is not None:
            warm_y = _as_f32(warm_y, dev) / d_r

    knorm = _power_iteration(eng_run, op_run.data, k, n_var, dev)   # [k]

    cold_x = torch.minimum(torch.maximum(torch.zeros_like(op_run.c),
                                         op_run.l), op_run.u)
    cold_y = torch.zeros_like(op_run.q)
    x0 = cold_x if warm_x is None else _as_f32(warm_x, dev)
    y0 = cold_y if warm_y is None else _as_f32(warm_y, dev)
    if warm_mask is not None and (warm_x is not None or warm_y is not None):
        m = torch.as_tensor(warm_mask, dtype=torch.bool,
                            device=dev)[:, None]
        x0 = torch.where(m, x0, cold_x)
        y0 = torch.where(m, y0, cold_y)
    kx0 = eng_run.K(op_run.data, x0)
    kty0 = eng_run.KT(op_run.data, y0)

    def chunk(state: _State) -> _State:
        tau = eta / (state.omega * knorm)          # [k]
        sigma = eta * state.omega / knorm          # [k]
        x, y, kx, kty = state.x, state.y, state.kx, state.kty
        xs, ys = state.x_sum.clone(), state.y_sum.clone()
        kxs, ktys = state.kx_sum.clone(), state.kty_sum.clone()
        for _ in range(check_every):
            x_new, kx_new = eng_run.forward(op_run.data, x, op_run.c,
                                            op_run.l, op_run.u, tau, kty)
            y_new, kty_new = eng_run.backward(op_run.data, y, op_run.q,
                                              sigma, op_run.ineq_mask,
                                              kx_new, kx)
            x, y, kx, kty = x_new, y_new, kx_new, kty_new
            xs.add_(x)
            ys.add_(y)
            kxs.add_(kx)
            ktys.add_(kty)
        avg_n = state.avg_n + check_every

        # candidate = better of {current, running average}; the average's
        # products are the running sums (linearity), in both KKT modes
        if kkt == "standalone":
            kx_cur = eng_run.K(op_run.data, x)
            kty_cur = eng_run.KT(op_run.data, y)
        else:
            kx_cur, kty_cur = kx, kty
        nrm = avg_n[:, None]
        x_avg, y_avg = xs / nrm, ys / nrm
        kx_avg, kty_avg = kxs / nrm, ktys / nrm
        pr_c, gap_c, _, _ = _kkt_from_products(op_run, x, y, kx_cur, kty_cur)
        pr_a, gap_a, _, _ = _kkt_from_products(op_run, x_avg, y_avg,
                                               kx_avg, kty_avg)
        score_c = pr_c + gap_c
        score_a = pr_a + gap_a
        use_avg = score_a < score_c                # [k]
        sel = use_avg[:, None]
        x_r = torch.where(sel, x_avg, x)
        y_r = torch.where(sel, y_avg, y)
        kx_r = torch.where(sel, kx_avg, kx_cur)
        kty_r = torch.where(sel, kty_avg, kty_cur)
        pr = torch.where(use_avg, pr_a, pr_c)
        gap = torch.where(use_avg, gap_a, gap_c)
        score = torch.minimum(score_a, score_c)

        # divergence guard: non-finite score, or blow-up past the best
        blown = (~torch.isfinite(score)) | (
            score > divergence_ratio * torch.clamp_min(state.best_score,
                                                       1e-12))
        diverged = state.diverged | (blown & ~state.done)
        best_score = torch.minimum(
            state.best_score,
            torch.where(torch.isfinite(score), score,
                        torch.full_like(score, float("inf"))))

        # adaptive restart only on sufficient KKT decay
        restart = (score < 0.4 * state.last_score) | (
            avg_n >= 16 * check_every)

        # primal weight update at restarts (PDLP eq. 10, smoothed)
        dx = _vnorm(x_r - state.x_anchor)
        dy = _vnorm(y_r - state.y_anchor)
        safe = (dx > 1e-12) & (dy > 1e-12)
        ratio = torch.where(safe, dy / torch.clamp_min(dx, 1e-12),
                            torch.ones_like(dx))
        omega_new = torch.exp(
            0.5 * torch.log(torch.clamp(ratio, 1e-4, 1e4))
            + 0.5 * torch.log(state.omega))

        conv = (pr < tol_primal) & (gap < tol_gap) & ~state.diverged
        done = state.done | conv

        def pick(on_restart, no_restart):
            return torch.where(_bcast(restart, on_restart), on_restart,
                               no_restart)

        # freeze finished AND quarantined lanes: batch peers keep going
        frozen = state.done | state.diverged

        def keep(new, old):
            return torch.where(_bcast(frozen, new), old, new)

        zero = torch.zeros_like
        return _State(
            x=keep(pick(x_r, x), state.x),
            y=keep(pick(y_r, y), state.y),
            kx=keep(pick(kx_r, kx_cur), state.kx),
            kty=keep(pick(kty_r, kty_cur), state.kty),
            x_sum=keep(pick(zero(xs), xs), state.x_sum),
            y_sum=keep(pick(zero(ys), ys), state.y_sum),
            kx_sum=keep(pick(zero(kxs), kxs), state.kx_sum),
            kty_sum=keep(pick(zero(ktys), ktys), state.kty_sum),
            avg_n=keep(pick(zero(avg_n), avg_n), state.avg_n),
            x_anchor=keep(pick(x_r, state.x_anchor), state.x_anchor),
            y_anchor=keep(pick(y_r, state.y_anchor), state.y_anchor),
            omega=keep(pick(omega_new, state.omega), state.omega),
            last_score=keep(pick(score, state.last_score), state.last_score),
            it=state.it + torch.where(frozen, 0, check_every).to(torch.int32),
            done=done,
            n_restarts=state.n_restarts + torch.where(
                frozen | ~restart, 0, 1).to(torch.int32),
            prim_res=keep(pr, state.prim_res), gap=keep(gap, state.gap),
            best_score=keep(best_score, state.best_score),
            diverged=diverged,
        )

    def full(value, dtype=torch.float32):
        return torch.full((k,), value, dtype=dtype, device=dev)

    state = _State(
        x=x0, y=y0, kx=kx0, kty=kty0,
        x_sum=torch.zeros_like(x0), y_sum=torch.zeros_like(y0),
        kx_sum=torch.zeros_like(kx0), kty_sum=torch.zeros_like(kty0),
        avg_n=full(0.0), x_anchor=x0, y_anchor=y0,
        omega=full(omega0), last_score=full(float("inf")),
        it=full(0, torch.int32), done=full(False, torch.bool),
        n_restarts=full(0, torch.int32),
        prim_res=full(float("inf")), gap=full(float("inf")),
        best_score=full(float("inf")), diverged=full(False, torch.bool),
    )

    # the loop's one host sync per chunk
    while bool(torch.any(~state.done & ~state.diverged
                         & (state.it < max_iters))):
        state = chunk(state)

    x_fin, y_fin = state.x, state.y
    if equilibrate:
        x_fin, y_fin = unscale_solution(x_fin, y_fin, d_r, d_c)
    pr, gap, p_obj, d_obj = _kkt(op, eng, x_fin, y_fin)
    return SolveResult(
        x=_np(x_fin), y=_np(y_fin), primal_obj=_np(p_obj),
        dual_obj=_np(d_obj), primal_res=_np(pr), gap=_np(gap),
        iterations=_np(state.it), converged=_np(state.done),
        n_restarts=_np(state.n_restarts), diverged=_np(state.diverged))


# the keyword names a solver_kw dict may carry — what ExecConfig validates
SOLVER_KW_NAMES = frozenset(
    name for name, p in inspect.signature(solve_stacked).parameters.items()
    if p.kind is inspect.Parameter.KEYWORD_ONLY
    and not name.startswith("warm_"))


def solve(
    op: OperatorLP,
    K_mv: Callable = dense_K_mv,
    KT_mv: Callable = dense_KT_mv,
    *,
    max_iters: int = 20_000,
    check_every: int = 40,
    tol_primal: float = 1e-4,
    tol_gap: float = 1e-4,
    eta: float = 0.9,
    omega0: float = 1.0,
    equilibrate: bool = False,
    warm_x=None,
    warm_y=None,
    warm_mask=None,
    engine: Union[None, str, StepEngine] = "matvec",
    kkt: str = "inloop",
    divergence_ratio: float = 1e4,
) -> SolveResult:
    """Solve one LP: a k=1 stack through :func:`solve_stacked`."""
    opb = map_arrays(lambda a: a[None], op)
    dev = op.c.device
    wx = None if warm_x is None else _as_f32(warm_x, dev)[None]
    wy = None if warm_y is None else _as_f32(warm_y, dev)[None]
    wm = (None if warm_mask is None
          else torch.as_tensor(warm_mask, dtype=torch.bool).reshape(1))
    res = solve_stacked(
        opb, engine=engine, K_mv=K_mv, KT_mv=KT_mv,
        max_iters=max_iters, check_every=check_every,
        tol_primal=tol_primal, tol_gap=tol_gap, eta=eta, omega0=omega0,
        equilibrate=equilibrate, warm_x=wx, warm_y=wy, warm_mask=wm, kkt=kkt,
        divergence_ratio=divergence_ratio)
    return map_arrays(lambda a: a[0], res)


# --------------------------------------------------------------------------
# Ruiz equilibration (dense path) and the dense convenience wrappers
# --------------------------------------------------------------------------

def ruiz_equilibrate(op: OperatorLP, iters: int = 8):
    """``(scaled_op, d_row, d_col)`` with K~ = D_r K D_c equilibrated by
    ``iters`` Ruiz sweeps (inf-norm, square roots) over the dense K of ONE
    LP (``op.data == (K,)``, K ``[M, N]``).  Recover original-space
    solutions as ``x = d_col * x~``, ``y = d_row * y~``
    (:func:`unscale_solution`)."""
    (K,) = op.data
    d_r = torch.ones(K.shape[0], dtype=torch.float32, device=K.device)
    d_c = torch.ones(K.shape[1], dtype=torch.float32, device=K.device)
    one = torch.ones((), dtype=torch.float32, device=K.device)
    for _ in range(iters):
        Ks = K * d_r[:, None] * d_c[None, :]
        rn = torch.sqrt(torch.amax(torch.abs(Ks), dim=1))
        cn = torch.sqrt(torch.amax(torch.abs(Ks), dim=0))
        d_r = d_r / torch.where(rn > 1e-12, rn, one)
        d_c = d_c / torch.where(cn > 1e-12, cn, one)
    Ks = K * d_r[:, None] * d_c[None, :]
    return scale_operator(op, d_r, d_c, data=(Ks,)), d_r, d_c


def solve_dense(lp: LinearProgram, max_iters: int = 20_000,
                tol_primal: float = 1e-4, tol_gap: float = 1e-4
                ) -> SolveResult:
    """Solve one dense :class:`LinearProgram` (on its device): Ruiz
    equilibration, then :func:`solve` with the matvec engine; objective and
    residuals are reported in the ORIGINAL space."""
    op = dense_ops(lp)
    sop, d_r, d_c = ruiz_equilibrate(op)
    res = solve(sop, dense_K_mv, dense_KT_mv, max_iters=max_iters,
                tol_primal=tol_primal, tol_gap=tol_gap)
    dev = lp.c.device
    x, y = unscale_solution(_as_f32(res.x, dev), _as_f32(res.y, dev), d_r,
                            d_c)
    pr, gap, p_obj, d_obj = _kkt(map_arrays(lambda a: a[None], op),
                                 matvec_engine(), x[None], y[None])
    return SolveResult(x=_np(x), y=_np(y), primal_obj=_np(p_obj[0]),
                       dual_obj=_np(d_obj[0]), primal_res=_np(pr[0]),
                       gap=_np(gap[0]), iterations=res.iterations,
                       converged=res.converged, n_restarts=res.n_restarts,
                       diverged=res.diverged)


def solve_batched(op_batched: OperatorLP, K_mv: Callable = dense_K_mv,
                  KT_mv: Callable = dense_KT_mv, **kw) -> SolveResult:
    """Independent solves of a stack of LPs — POP's map step on one device.
    The reference vmaps :func:`solve`; here the stack is ONE
    :func:`solve_stacked` with :func:`solve`'s default engine (``matvec``,
    unless ``kw`` names another), where every lane keeps its own step
    sizes, restarts and termination."""
    kw.setdefault("engine", "matvec")
    return solve_stacked(op_batched, K_mv=K_mv, KT_mv=KT_mv, **kw)
