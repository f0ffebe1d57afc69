"""Load and launch the hand-written CUDA structured PDHG half-steps
(``csrc/structured_pdhg_step.cu``) — the port of the lane kernels of
``repro/kernels/structured_pdhg_step.py`` (``structured_forward_step``
:110, ``structured_backward_step`` :141).

The library is built at first use by :mod:`.build` (``nvcc`` for
``sm_90a``, loaded with ``ctypes``); nothing is built when this module is
imported, and a build failure raises.

The host path of a call is kept short, without dropping a check:

* an operator side (its five ELL tensors) is checked once — device,
  dtype, contiguity, every shape, the bucket ids' range — and packed with
  its sizes and its real bucket columns sorted by segment into one
  :class:`LaneSide` struct that the C side reads through a single pointer
  (:func:`side_pack`).  The pack is cached by the
  tensors' ids and ``_version`` s, so an in-place change re-checks, and
  each tensor's ``weakref`` drops it when the operator is freed;
* each call checks only its vectors (dtype, device, contiguity, shape),
  allocates its outputs uninitialised (``new_empty`` of a checked vector:
  the ``torch.empty`` of its dtype and device), launches on the current
  stream, raises on a nonzero ``cudaGetLastError`` and adds one to its
  entry in :data:`LAUNCHES` and the CUDA launches it made to
  :data:`CUDA_LAUNCHES`.

Each half-step makes one CUDA launch of :data:`CLUSTER` blocks per lane,
each holding the lane's whole tail in shared memory, or, for a lane too
large for that (:func:`lane_local`), a thread-block cluster of them over
the stored tail; each block reduces its share of the segments and the wide
bucket columns of its segments, whole.  Both need a Hopper card (see the
source's note).
"""

from __future__ import annotations

import ctypes
import weakref

import torch

from . import build as _build

# calls of each wrapper since the counts were last set to 0
LAUNCHES = {"structured_forward_step": 0, "structured_backward_step": 0}
# CUDA kernel launches those calls made (the C side reports them)
CUDA_LAUNCHES = {"structured_forward_step": 0,
                 "structured_backward_step": 0}

# the lane kernels' block size, their most blocks a lane, the narrow
# entries a thread loads ahead of their gathers and the dynamic shared
# memory a block may hold (the source's kClusterThreads, kMaxCluster,
# kGatherBatch and kLaneSmemBytes)
CLUSTER_THREADS = 512
MAX_CLUSTER = 16
GATHER_BATCH = 8
LANE_SMEM_BYTES = 227 * 1024 - 4 * CLUSTER_THREADS
# both kernels' blocks a lane (a cluster where the lane does not fit a
# block's shared memory): the fastest of 4, 8 and 16 on the device at the
# main-path shape, for each half-step (PERF.md)
CLUSTER = 16

_F, _I = torch.float32, torch.int32


class LaneSide(ctypes.Structure):
    """One ELL side of a stacked operator as the C side reads it (the
    source's ``struct LaneSide``)."""
    _fields_ = [("idx", ctypes.c_void_p), ("val", ctypes.c_void_p),
                ("widx", ctypes.c_void_p), ("wval", ctypes.c_void_p),
                ("wids", ctypes.c_void_p), ("wsort", ctypes.c_void_p),
                ("nreal", ctypes.c_void_p), ("k", ctypes.c_int32),
                ("v_len", ctypes.c_int32), ("s_len", ctypes.c_int32),
                ("w", ctypes.c_int32), ("ww", ctypes.c_int32),
                ("d", ctypes.c_int32), ("launches", ctypes.c_int32)]


class Pack:
    """A checked operator side: the struct, its address, the device, the
    vector shapes a call must bring and the bucket columns sorted by
    segment."""
    __slots__ = ("struct", "addr", "ids", "versions", "refs", "device",
                 "cuda", "dev_index", "k", "v_len", "s_len", "d",
                 "vec_shape", "out_shape", "step_shape", "order",
                 "__weakref__")


_lib = None
# checked operator sides: id(first tensor) -> Pack
_packs: dict = {}


def library() -> ctypes.CDLL:
    """The kernels' shared library, built if needed, with its C
    signatures declared."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _build.load("structured_pdhg_step")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.structured_forward_step.argtypes = [p] * 9 + [i, i, p]
    lib.structured_forward_step.restype = i
    lib.structured_backward_step.argtypes = [p] * 9 + [i, i, p]
    lib.structured_backward_step.restype = i
    lib.structured_pdhg_error_string.argtypes = [i]
    lib.structured_pdhg_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def wide_order(wids: torch.Tensor, wval: torch.Tensor, s_len: int):
    """``(wsort [k, D], nreal [k])`` int32: each lane's wide bucket columns
    sorted by the segment they add onto, and how many of them are real.  A
    padded bucket column (id 0, every value 0.0) adds nothing and sorts
    last, so a lane's real columns come first in segment order; columns
    that share a segment sit side by side in column order (the sort is
    stable), and the kernel adds them onto it in that order."""
    k, d = wids.shape
    real = (wval != 0).any(dim=1)                                  # [k, D]
    cols = torch.arange(d, device=wids.device)
    key = torch.where(real, wids.long(), s_len + cols)
    wsort = torch.argsort(key, dim=1, stable=True).to(torch.int32)
    return wsort.contiguous(), real.sum(dim=1).to(torch.int32)


def _check_side(name, side, v_len):
    """Raise unless ``side`` = (idx, val, widx, wval, wids) is one device's
    contiguous [k, W, S] int32 / f32, [k, Ww, D] int32 / f32 and [k, D]
    int32 with bucket ids in ``[0, S)`` (one device sync)."""
    idx, val, widx, wval, wids = side
    dev = idx.device
    for t, dt in zip(side, (_I, _F, _I, _F, _I)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(
                f"{name}: operator tensor must be a contiguous {dt} tensor "
                f"on {dev}; got {t.dtype} on {t.device} "
                f"(contiguous={t.is_contiguous()})")
    d = wids.shape[-1] if wids.ndim == 2 else -1
    k = idx.shape[0] if idx.ndim == 3 else -1
    ok = (idx.ndim == 3 and val.shape == idx.shape and widx.ndim == 3
          and widx.shape[0] == k and widx.shape[2] == d
          and wval.shape == widx.shape and wids.shape == (k, d)
          and v_len >= 0)
    if not ok:
        raise ValueError(
            f"{name}: operand shapes do not fit one side of a stacked "
            f"operator: side {[tuple(a.shape) for a in side]}")
    if wids.numel():
        lo, hi = torch.stack([wids.min(), wids.max()]).tolist()
        if lo < 0 or hi >= idx.shape[2]:
            raise ValueError(f"{name}: wide bucket ids span [{lo}, {hi}], "
                             f"outside [0, {idx.shape[2]})")


def _dropper(key):
    """A weakref callback that drops the pack under ``key`` (bound to the
    cache itself, which outlives the module's globals at exit)."""
    pop = _packs.pop
    return lambda _ref: pop(key, None)


def side_pack(name, side, v_len: int) -> Pack:
    """The checked, packed operator side with its sorted bucket columns,
    from the cache while its tensors live unmodified; ``v_len`` is the
    length of the lane vectors the side gathers from."""
    key = id(side[0])
    p = _packs.get(key)
    if (p is not None and p.ids == tuple(map(id, side))
            and p.versions == tuple([t._version for t in side])
            and p.v_len == v_len):
        return p
    _check_side(name, side, v_len)
    idx, val, widx, wval, wids = side
    k, w, s_len = idx.shape
    ww, d = widx.shape[1:]
    p = Pack()
    p.order = wide_order(wids, wval, s_len)
    wsort, nreal = p.order
    p.struct = LaneSide(
        idx.data_ptr(), val.data_ptr(), widx.data_ptr(), wval.data_ptr(),
        wids.data_ptr(), wsort.data_ptr(), nreal.data_ptr(), k, v_len,
        s_len, w, ww, d, 0)
    p.addr = ctypes.addressof(p.struct)
    p.ids = tuple(map(id, side))
    p.versions = tuple([t._version for t in side])
    p.refs = tuple(weakref.ref(t, _dropper(key))
                   for t in side)
    p.device = idx.device
    p.cuda = idx.is_cuda
    p.dev_index = idx.get_device()
    p.k, p.v_len, p.s_len, p.d = k, v_len, s_len, d
    p.vec_shape = torch.Size((k, v_len))
    p.out_shape = torch.Size((k, s_len))
    p.step_shape = torch.Size((k,))
    _packs[key] = p
    return p


def vector_ptrs(name, p: Pack, vecs, dtypes):
    """data_ptr()s of a call's vectors after checking each one's dtype,
    device, contiguity and shape ([k, v_len], the step size [k])."""
    if not p.cuda:
        raise ValueError(f"{name}: the kernel needs CUDA tensors; the "
                         f"operator lies on {p.device}")
    dev, shape = p.dev_index, p.vec_shape
    out = []
    last = len(vecs) - 1
    for i, (v, dt) in enumerate(zip(vecs, dtypes)):
        if i == last:
            shape = p.step_shape
        if (v.dtype is not dt or v.shape != shape or not v.is_contiguous()
                or v.get_device() != dev):
            _bad_vector(name, p, v, dt, shape)
        out.append(v.data_ptr())
    return out


def _bad_vector(name, p, v, dt, shape):
    if v.shape != shape:
        raise ValueError(
            f"{name}: operand shapes do not fit k={p.k}, {p.v_len} vector "
            f"entries: got {tuple(v.shape)}, want {tuple(shape)}")
    if v.dtype != dt or not v.is_cuda or not v.is_contiguous():
        raise ValueError(
            f"{name}: kernel operand must be a contiguous CUDA {dt} tensor; "
            f"got {v.dtype} on {v.device} (contiguous={v.is_contiguous()})")
    raise ValueError(f"{name}: operand on {v.device}, the operator on "
                     f"{p.device}")


def _raise(lib, name, err):
    msg = lib.structured_pdhg_error_string(err).decode()
    raise RuntimeError(f"{name}: CUDA launch failed ({err}: {msg})")


def _stream(p) -> int:
    """The current CUDA stream of the pack's device, as an integer."""
    return torch._C._cuda_getCurrentRawStream(p.dev_index)


def forward_checks(s, x, c, l, u, tau, kty):
    """(pack, vector pointers) of a forward call."""
    name = "structured_forward_step"
    p = side_pack(name, (s.row_idx, s.row_val, s.wrow_idx, s.wrow_val,
                         s.wrow_ids), s.col_idx.shape[-1])
    return p, vector_ptrs(name, p, (x, c, l, u, kty, tau), (_F,) * 6)


def forward_call(p, ptrs, x_new, kx, cluster):
    lib = library()
    err = lib.structured_forward_step(
        p.addr, *ptrs, x_new.data_ptr(), kx.data_ptr(), cluster,
        int(lane_local(p)), _stream(p))
    if err != 0:
        _raise(lib, "structured_forward_step", err)
    LAUNCHES["structured_forward_step"] += 1
    CUDA_LAUNCHES["structured_forward_step"] += p.struct.launches


def forward_alloc(p, like):
    """(x_new, kx) of a forward call: ``torch.empty`` in f32 on the device
    of ``like``, a checked f32 vector of the call (``new_empty`` skips
    parsing a dtype and a device)."""
    return like.new_empty(p.vec_shape), like.new_empty(p.out_shape)


def structured_forward_step(s, x, c, l, u, tau, kty):
    """(x_new [k, N], kx [k, M]) for the row side of ``s`` (batched
    StructuredOperator); x/c/l/u/kty [k, N] f32, tau [k] f32."""
    p, ptrs = forward_checks(s, x, c, l, u, tau, kty)
    x_new, kx = forward_alloc(p, x)
    forward_call(p, ptrs, x_new, kx, CLUSTER)
    return x_new, kx


def backward_checks(s, y, q, sigma, ineq_mask, kx_new, kx_prev):
    """(pack, vector pointers) of a backward call."""
    name = "structured_backward_step"
    if ineq_mask.dtype != torch.bool:
        raise ValueError(f"{name}: ineq_mask must be bool, got "
                         f"{ineq_mask.dtype}")
    p = side_pack(name, (s.col_idx, s.col_val, s.wcol_idx, s.wcol_val,
                         s.wcol_ids), s.row_idx.shape[-1])
    return p, vector_ptrs(name, p, (y, q, ineq_mask, kx_new, kx_prev, sigma),
                          (_F, _F, torch.bool, _F, _F, _F))


def lane_local(p: Pack) -> bool:
    """The lane kernels' shape rule: a lane whose tail (``v_len`` entries:
    N forward, M backward) fits a block's shared memory takes the instance
    whose blocks each hold the whole tail; a larger lane takes the cluster
    instance."""
    return 4 * p.v_len <= LANE_SMEM_BYTES


def backward_alloc(p, like):
    """(y_new, kty) of a backward call, like :func:`forward_alloc`."""
    return like.new_empty(p.vec_shape), like.new_empty(p.out_shape)


def backward_call(p, ptrs, y_new, kty, cluster):
    lib = library()
    err = lib.structured_backward_step(
        p.addr, *ptrs, y_new.data_ptr(), kty.data_ptr(), cluster,
        int(lane_local(p)), _stream(p))
    if err != 0:
        _raise(lib, "structured_backward_step", err)
    LAUNCHES["structured_backward_step"] += 1
    CUDA_LAUNCHES["structured_backward_step"] += p.struct.launches


def structured_backward_step(s, y, q, sigma, ineq_mask, kx_new, kx_prev):
    """(y_new [k, M], kty [k, N]) for the column side of ``s``;
    y/q/kx_new/kx_prev [k, M] f32, ineq_mask [k, M] bool, sigma [k] f32."""
    p, ptrs = backward_checks(s, y, q, sigma, ineq_mask, kx_new, kx_prev)
    y_new, kty = backward_alloc(p, y)
    backward_call(p, ptrs, y_new, kty, CLUSTER)
    return y_new, kty
