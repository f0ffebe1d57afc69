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
``pdhg._wide_block_plans``.  Its host path is kept short, without dropping
a check:

* an operator side (its seven ELL tensors) is checked once — device,
  dtype, contiguity, every shape, the fold map's values (one device sync)
  — and packed into one :class:`FullSide` struct the C side reads through
  a single pointer (:func:`side_pack`), cached by the tensors' ids and
  ``_version`` s (an in-place change re-checks; each tensor's ``weakref``
  drops the pack when the operator is freed);
* the plan is checked, laid out (:func:`plan_layout`) and copied to the
  device once per operator and plan object, into the same pack, with no
  wide tile at all where no segment folds onto the bucket;
* each group of 4 segments' stored width (:func:`group_widths`) is
  reduced on the device once per operator into the pack: the backward
  kernel's narrow reduce stops there instead of at the padded W;
* each call checks only its vectors, allocates its outputs uninitialised
  (``new_empty`` of a checked vector: the ``torch.empty`` of its dtype and
  device) and takes the pack's scratch of wide partial sums for its CUDA
  stream (allocated the same way once per stream), launches on the
  current stream, raises on a nonzero ``cudaGetLastError`` and adds one to
  its entry in :data:`LAUNCHES` and the CUDA launches it made to
  :data:`CUDA_LAUNCHES`.

Each half-step is a persistent cooperative kernel: the forward one
launched alone (``VARIANT`` 1, the default) or after a tail launch
(``VARIANT`` 2), the backward one alone (see the source's note).
"""

from __future__ import annotations

import ctypes
import weakref

import torch

from . import build as _build

# calls of each wrapper since the counts were last set to 0
LAUNCHES = {"structured_full_forward_step": 0,
            "structured_full_backward_step": 0}
# CUDA kernel launches those calls made (the C side reports them)
CUDA_LAUNCHES = {"structured_full_forward_step": 0,
                 "structured_full_backward_step": 0}

# the kernels' block size, rows per thread of a wide tile and most plan
# blocks (the source's kThreads, kWideIters and kMaxPlanBlocks)
THREADS = 256
WIDE_ITERS = 16
MAX_PLAN_BLOCKS = 4010
# the cooperative kernels' narrow split, their blocks per SM and their
# shared memory (the source's kNarrowWarps, kRowsPerLane, kCoopBlocksPerSM,
# kCoopBackwardBlocksPerSM and kCoopSmemMax)
NARROW_WARPS = THREADS // 32
ROWS_PER_LANE = 4
COOP_BLOCKS_PER_SM = 6
COOP_BACKWARD_BLOCKS_PER_SM = 5
COOP_SMEM_MAX = 16 * MAX_PLAN_BLOCKS
# the forward step: 1 = one cooperative launch, 2 = the tail launch, then
# the cooperative launch (1-2 us faster on the device, but one launch more
# for the host, which sets the pace of the solve loop; PERF.md)
VARIANT = 1

# coefficient storage codes of the C interface
_COEF = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_F = torch.float32
_STEP = torch.Size((1,))

_lib = None
# checked operator sides: id(first tensor) -> Pack
_packs: dict = {}


class FullSide(ctypes.Structure):
    """One side of the single-lane operator and its plan as the C side
    reads it (the source's ``struct FullSide``)."""
    _fields_ = [("idx", ctypes.c_void_p), ("val", ctypes.c_void_p),
                ("scale", ctypes.c_void_p), ("widx", ctypes.c_void_p),
                ("wval", ctypes.c_void_p), ("wscale", ctypes.c_void_p),
                ("fold", ctypes.c_void_p), ("plan", ctypes.c_void_p),
                ("gw", ctypes.c_void_p), ("coef", ctypes.c_int32),
                ("w", ctypes.c_int32), ("s_len", ctypes.c_int32),
                ("d", ctypes.c_int32),
                ("n_blocks", ctypes.c_int32), ("tc", ctypes.c_int32),
                ("n_tiles", ctypes.c_int32), ("n_chunks", ctypes.c_int32),
                ("vec", ctypes.c_int32), ("launches", ctypes.c_int32)]


class Pack:
    """A checked operator side with its plan: the struct, its address,
    the device, the shapes a call must bring, whether any segment folds
    onto the wide bucket, the group widths' and the plan's device
    tensors."""
    __slots__ = ("struct", "addr", "ids", "versions", "refs", "device",
                 "cuda", "dev_index", "v_len", "s_len", "d", "ww",
                 "vec_shape", "out_shape", "part_shape", "has_wide", "gw",
                 "plan", "plan_t", "scratch", "__weakref__")


def library() -> ctypes.CDLL:
    """The kernels' shared library, built if needed, with its C
    signatures declared."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _build.load("structured_full_pdhg_step")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.structured_full_forward_step.argtypes = [p] * 10 + [i, i, p]
    lib.structured_full_forward_step.restype = i
    lib.structured_full_backward_step.argtypes = [p] * 10 + [i, p]
    lib.structured_full_backward_step.restype = i
    lib.structured_full_pdhg_error_string.argtypes = [i]
    lib.structured_full_pdhg_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


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


def plan_rows(plan: tuple, d: int, ww: int, tc: int) -> list:
    """The plan as the kernels read it: rows ``(c0, c1, wb, first tile)``,
    the last the number of the block's first wide tile."""
    plan = plan or ((0, d, ww),)
    rows, first = [], 0
    chunk_rows = (THREADS // tc) * WIDE_ITERS
    for c0, c1, wb in plan:
        rows.append((c0, c1, wb, first))
        first += -(-(c1 - c0) // tc) * -(-wb // chunk_rows)
    return rows


def group_widths(val: torch.Tensor) -> torch.Tensor:
    """int32 ``[ceil(S / 4)]`` of one lane's narrow ``[1, W, S]``
    coefficients: for each group of 4 consecutive segments the largest
    stored width, the position of a segment's last nonzero coefficient plus
    one (0 for a group with none), reduced where ``val`` lives.  The packer
    front-packs every segment, so every slot past it is padding (idx 0,
    val 0); a stored 0 before it is kept, and one after it adds exactly 0
    for a finite gathered value."""
    v = val[0]
    w, s_len = v.shape
    pos = torch.arange(1, w + 1, dtype=torch.int32, device=v.device)
    last = torch.where(v != 0, pos[:, None], 0).amax(dim=0)          # [S]
    last = torch.nn.functional.pad(last, (0, -s_len % ROWS_PER_LANE))
    return last.reshape(-1, ROWS_PER_LANE).amax(dim=1).contiguous()


def _dropper(key):
    """A weakref callback that drops the pack under ``key`` (bound to the
    cache itself, which outlives the module's globals at exit)."""
    pop = _packs.pop
    return lambda _ref: pop(key, None)


def _check_side(name, side, v_len):
    """Raise unless ``side`` = (idx, val, scale, widx, wval, wscale, fold)
    is one lane on one device: contiguous [1, W, S] int32 indices and
    coefficients of one storage type, [1, Ww, D] likewise, [1, S] int32
    fold values in ``[0, D]`` (one device sync) and [1, 1] f32 scales for
    int8 storage (none otherwise).  Returns whether any segment folds onto
    the bucket (a fold value below D)."""
    idx, val, scale, widx, wval, wscale, fold = side
    dev = idx.device
    int8 = val.dtype == torch.int8
    want = (torch.int32, val.dtype, _F, torch.int32, val.dtype, _F,
            torch.int32)
    for t, dt in zip(side, want):
        if t is not None and (t.device != dev or t.dtype != dt
                              or not t.is_contiguous()):
            raise ValueError(
                f"{name}: operator tensor must be a contiguous {dt} tensor "
                f"on {dev}; got {t.dtype} on {t.device} "
                f"(contiguous={t.is_contiguous()})")
    _, w, s_len = idx.shape if idx.ndim == 3 else (0, 0, -1)
    _, ww, d = widx.shape if widx.ndim == 3 else (0, 0, -1)
    ok = (idx.shape[0] == 1 and s_len >= 0 and val.shape == idx.shape
          and widx.shape[0] == 1 and d >= 1 and wval.shape == widx.shape
          and val.dtype in _COEF and fold is not None
          and fold.shape == (1, s_len) and v_len >= 0
          and all(sc is not None and sc.shape == (1, 1)
                  if int8 else sc is None for sc in (scale, wscale)))
    if not ok:
        got = [None if a is None else (tuple(a.shape), str(a.dtype))
               for a in side]
        raise ValueError(
            f"{name}: operands do not fit one lane of {v_len} vector "
            f"entries and {s_len} output segments: side "
            f"{got}"
            " (f32, bf16 or int8 coefficients; int8 needs its [1, 1] "
            "scales, the others none)")
    lo, hi = torch.stack([fold.min(), fold.max()]).tolist() if s_len else (
        0, 0)
    if lo < 0 or hi > d:
        raise ValueError(f"{name}: fold map values span [{lo}, {hi}], "
                         f"outside [0, {d}]")
    return lo < d


def side_pack(name, side, v_len: int, plan) -> Pack:
    """The checked, packed operator side with ``plan`` laid out, from the
    cache while its tensors live unmodified (the plan re-laid only when
    another plan object comes); ``v_len`` is the length of the vectors it
    gathers from."""
    key = id(side[0])
    p = _packs.get(key)
    if (p is None or p.ids != tuple(map(id, side))
            or p.versions != tuple([t._version for t in side
                                    if t is not None])
            or p.v_len != v_len):
        p = _new_pack(name, side, v_len)
        _packs[key] = p
    if p.plan is not plan:
        _set_plan(p, plan)
    return p


def _new_pack(name, side, v_len):
    has_wide = _check_side(name, side, v_len)
    idx, val, scale, widx, wval, wscale, fold = side
    key = id(idx)
    _, w, s_len = idx.shape
    _, ww, d = widx.shape
    ptr = lambda t: 0 if t is None else t.data_ptr()
    vec = (s_len % 4 == 0 and idx.data_ptr() % 16 == 0
           and val.data_ptr() % (4 * val.element_size()) == 0)
    p = Pack()
    p.gw = group_widths(val)
    p.struct = FullSide(ptr(idx), ptr(val), ptr(scale), ptr(widx),
                        ptr(wval), ptr(wscale), ptr(fold), 0, ptr(p.gw),
                        _COEF[val.dtype], w, s_len, d, 0, 0, 0, 0, int(vec),
                        0)
    p.addr = ctypes.addressof(p.struct)
    p.ids = tuple(map(id, side))
    p.versions = tuple([t._version for t in side if t is not None])
    p.refs = tuple(weakref.ref(t, _dropper(key))
                   for t in side if t is not None)
    p.device = idx.device
    p.cuda = idx.is_cuda
    p.dev_index = idx.get_device()
    p.v_len, p.s_len, p.d, p.ww = v_len, s_len, d, ww
    p.has_wide = has_wide
    p.vec_shape = torch.Size((1, v_len))
    p.out_shape = torch.Size((1, s_len))
    p.plan, p.plan_t = None, None
    return p


def _set_plan(p: Pack, plan) -> None:
    """Check and lay out ``plan`` for ``p``'s bucket and copy its rows to
    the pack's device; a bucket that no segment folds onto gets no tile."""
    plan_t = tuple(plan)
    tc, n_tiles, n_chunks = plan_layout(plan_t, p.d, p.ww)
    if not p.has_wide:
        n_tiles = 0
    rows = plan_rows(plan_t, p.d, p.ww, tc)
    p.plan_t = torch.tensor(rows, dtype=torch.int32, device=p.device)
    st = p.struct
    st.plan = p.plan_t.data_ptr()
    st.n_blocks, st.tc, st.n_tiles, st.n_chunks = (len(rows), tc, n_tiles,
                                                   n_chunks)
    p.part_shape = torch.Size((max(n_chunks, 1), p.d))
    p.scratch = {}
    p.plan = plan


def vector_ptrs(name, p: Pack, vecs, dtypes):
    """data_ptr()s of a call's vectors after checking each one's dtype,
    device, contiguity and shape ([1, v_len], the step size [1])."""
    if not p.cuda:
        raise ValueError(f"{name}: the kernel needs CUDA tensors; the "
                         f"operator lies on {p.device}")
    dev, shape = p.dev_index, p.vec_shape
    out = []
    last = len(vecs) - 1
    for i, (v, dt) in enumerate(zip(vecs, dtypes)):
        if i == last:
            shape = _STEP
        if (v.dtype is not dt or v.shape != shape or not v.is_contiguous()
                or v.get_device() != dev):
            _bad_vector(name, p, v, dt, shape)
        out.append(v.data_ptr())
    return out


def _bad_vector(name, p, v, dt, shape):
    if v.shape != shape:
        raise ValueError(
            f"{name}: operands do not fit one lane of {p.v_len} vector "
            f"entries: got {tuple(v.shape)}, want {tuple(shape)}")
    if v.dtype != dt or not v.is_cuda or not v.is_contiguous():
        raise ValueError(
            f"{name}: kernel operand must be a contiguous CUDA {dt} tensor; "
            f"got {v.dtype} on {v.device} (contiguous={v.is_contiguous()})")
    raise ValueError(f"{name}: operand on {v.device}, the operator on "
                     f"{p.device}")


def _raise(lib, name, err):
    msg = lib.structured_full_pdhg_error_string(err).decode()
    raise RuntimeError(f"{name}: CUDA launch failed ({err}: {msg})")


def _stream(p) -> int:
    """The current CUDA stream of the pack's device, as an integer."""
    return torch._C._cuda_getCurrentRawStream(p.dev_index)


def forward_checks(s, x, c, l, u, tau, kty, plan):
    """(pack, vector pointers) of a forward call."""
    name = "structured_full_forward_step"
    p = side_pack(name, (s.row_idx, s.row_val, s.row_scale, s.wrow_idx,
                         s.wrow_val, s.wrow_scale, s.row_fold),
                  s.col_idx.shape[-1], plan)
    return p, vector_ptrs(name, p, (x, c, l, u, kty, tau), (_F,) * 6)


def backward_checks(s, y, q, sigma, ineq_mask, kx_new, kx_prev, plan):
    """(pack, vector pointers) of a backward call."""
    name = "structured_full_backward_step"
    if ineq_mask.dtype != torch.bool:
        raise ValueError(f"{name}: ineq_mask must be bool, got "
                         f"{ineq_mask.dtype}")
    p = side_pack(name, (s.col_idx, s.col_val, s.col_scale, s.wcol_idx,
                         s.wcol_val, s.wcol_scale, s.col_fold),
                  s.row_idx.shape[-1], plan)
    return p, vector_ptrs(name, p, (y, q, ineq_mask, kx_new, kx_prev, sigma),
                          (_F, _F, torch.bool, _F, _F, _F))


def alloc(p, like):
    """(partial sums, v_new, out) of a call.  The outputs are new:
    ``new_empty`` of ``like``, a checked f32 vector of the call (the
    ``torch.empty`` of its dtype and device).  The partial sums are scratch
    that a call's kernels write and read before its last one ends, so the
    pack keeps one per CUDA stream, allocated the same way on the stream's
    first call: the stream's next call runs after this one."""
    stream = _stream(p)
    partial = p.scratch.get(stream)
    if partial is None:
        partial = p.scratch[stream] = like.new_empty(p.part_shape)
    return partial, like.new_empty(p.vec_shape), like.new_empty(p.out_shape)


def forward_call(p, ptrs, partial, x_new, kx, variant):
    name = "structured_full_forward_step"
    lib = library()
    err = lib.structured_full_forward_step(
        p.addr, *ptrs, partial.data_ptr(), x_new.data_ptr(), kx.data_ptr(),
        p.v_len, variant, _stream(p))
    if err != 0:
        _raise(lib, name, err)
    LAUNCHES[name] += 1
    CUDA_LAUNCHES[name] += p.struct.launches


def backward_call(p, ptrs, partial, y_new, kty):
    name = "structured_full_backward_step"
    lib = library()
    err = lib.structured_full_backward_step(
        p.addr, *ptrs, partial.data_ptr(), y_new.data_ptr(), kty.data_ptr(),
        p.v_len, _stream(p))
    if err != 0:
        _raise(lib, name, err)
    LAUNCHES[name] += 1
    CUDA_LAUNCHES[name] += p.struct.launches


def structured_full_forward_step(s, x, c, l, u, tau, kty, plan=()):
    """(x_new [1, N], kx [1, M]) for the row side of the single-lane
    operator ``s``; x/c/l/u/kty [1, N] f32, tau [1] f32."""
    p, ptrs = forward_checks(s, x, c, l, u, tau, kty, plan)
    partial, x_new, kx = alloc(p, x)
    forward_call(p, ptrs, partial, x_new, kx, VARIANT)
    return x_new, kx


def structured_full_backward_step(s, y, q, sigma, ineq_mask, kx_new,
                                  kx_prev, plan=()):
    """(y_new [1, M], kty [1, N]) for the column side of ``s``;
    y/q/kx_new/kx_prev [1, M] f32, ineq_mask [1, M] bool, sigma [1] f32."""
    p, ptrs = backward_checks(s, y, q, sigma, ineq_mask, kx_new, kx_prev,
                              plan)
    partial, y_new, kty = alloc(p, y)
    backward_call(p, ptrs, partial, y_new, kty)
    return y_new, kty
