"""Load and launch the hand-written CUDA dense matvecs
(``csrc/pdhg_matvec.cu``) — the port of ``repro/kernels/pdhg_matvec.py``
(``bmatvec`` :67, ``bmatvec_t`` :89).

The library is built at first use by :mod:`.build` (``nvcc`` for
``sm_90a``, loaded with ``ctypes``); nothing is built when this module is
imported, and a build failure raises.

Each kernel streams whole-row slabs of ``A`` through a ring of
shared-memory stages (1-D bulk copies and ``mbarrier``s) in one CUDA
launch a call; :func:`stream_plan` gives each block its rows, from the
shape alone.  Each wrapper checks device, dtype, shape and contiguity,
allocates its outputs (and ``bmatvec_t``'s block partials) with
``torch.empty``, launches on the current stream, raises on a nonzero
``cudaGetLastError`` and then adds one to its entry in :data:`LAUNCHES`
and the CUDA launches the call made to :data:`CUDA_LAUNCHES`.  ``A`` is
``[k, M, N]`` f32 or bf16; the vectors are f32.  The helpers here are
shared with :mod:`.fused_pdhg_step`, whose kernels (``csrc/
dense_pdhg.cuh``) keep their own products.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from . import build as _build

# calls of each wrapper, and the CUDA launches they made, since the counts
# were last set to 0
LAUNCHES = {"bmatvec": 0, "bmatvec_t": 0}
CUDA_LAUNCHES = {"bmatvec": 0, "bmatvec_t": 0}

# the fused half-steps' block size (dense_pdhg.cuh's kThreads); their
# column pass cuts M into chunks (col_chunks) so that at least about
# TARGET_BLOCKS blocks share the card, chunks of at least MIN_CHUNK_ROWS
# rows and at most MAX_CHUNK_ROWS (the chunk of the row vector a block
# stages in shared memory, 16 KB)
THREADS = 256
TARGET_BLOCKS = 2048
MIN_CHUNK_ROWS = 32
MAX_CHUNK_ROWS = 4096

# the matvec stream (csrc/pdhg_matvec.cu): consumer threads (the block
# adds one producer warp), the ring's depth and stage bytes, the widest
# column slab in floats, blocks resident on one SM
CONSUMERS = 256
DEPTH = 2
STAGE_BYTES = 16_384
SLAB_FLOATS = 8_192
BLOCKS_PER_SM = 2
# the H100 SXM's SMs: the plan fills them, from the shape alone, on any
# card
SMS = 132
# bmatvec's blocks stream about this many bytes of A each (whole rows):
# many waves of short blocks, which the card hands out as SMs free up
ROW_BLOCK_BYTES = 65_536
# bmatvec_t's grid is one wave (its blocks' partials are added at the
# end), each block at least this many rows where M allows, so that the
# [N] partials a block writes, and the lane's last block adds, stay small
# beside its share of A.  With f32 A a block takes chunks of about
# COL_CHUNK_BYTES, every `blocks`-th one, so that the blocks of a lane
# stream neighbouring rows at a time (measured faster than one contiguous
# range a block in f32, slower in bf16, which keeps one range a block)
MIN_COL_ROWS = 32
COL_CHUNK_BYTES = {4: 131_072, 2: 0}
# shared memory of one SM, what the card keeps back for each block, and
# the kernels' static shared memory (barriers, warp sums) at most
SM_SMEM_BYTES = 233_472
BLOCK_RESERVED_BYTES = 1_024
STATIC_SMEM_BYTES = 256

# coefficient storage codes of the C interface
COEF = {torch.float32: 0, torch.bfloat16: 1}

_F = torch.float32
_lib = None
# bmatvec_t's tickets (int32) per (device, stream), all 0 between launches
_tickets: dict = {}


class StreamPlan(NamedTuple):
    """How one launch of a matvec kernel cuts ``A [k, M, N]``: ``blocks``
    blocks a lane, block ``j`` owning the chunks ``j, j + blocks, ...`` of
    ``chunk_rows`` rows (:func:`block_rows`); columns in
    ``n_slabs`` slabs of ``slab_width``; the ring's ``depth`` stages of
    ``stage_bytes``; ``smem_bytes`` of dynamic shared memory a block; for
    ``bmatvec_t``, ``group`` consecutive blocks whose partials the last of
    them adds before the lane's last group adds the group sums."""
    blocks: int
    chunk_rows: int
    n_slabs: int
    slab_width: int
    stage_bytes: int
    depth: int
    smem_bytes: int
    group: int

    @property
    def n_groups(self) -> int:
        return -(-self.blocks // self.group)


def slabs(n: int):
    """``(n_slabs, slab_width)``: the fewest slabs of at most
    :data:`SLAB_FLOATS` columns, of equal width but the last."""
    if n <= 0:
        return 1, 0
    count = -(-n // SLAB_FLOATS)
    return count, -(-n // count)


def stream_plan(k: int, m: int, n: int, transposed: bool = False,
                elem_bytes: int = 4) -> StreamPlan:
    """The plan of ``bmatvec`` (or, ``transposed``, ``bmatvec_t``) at
    ``[k, m, n]`` with ``elem_bytes`` of A an element.  Blocks a lane: at
    least enough to put :data:`BLOCKS_PER_SM` on each of :data:`SMS` SMs,
    at most one a row; ``bmatvec`` cuts a lane into blocks of about
    :data:`ROW_BLOCK_BYTES`, ``bmatvec_t`` keeps that one wave, with
    :data:`MIN_COL_ROWS` rows a block where M allows, in interleaved
    chunks of :data:`COL_CHUNK_BYTES` (f32).  Depends on the shape only,
    so every sum is taken in the same order on every call."""
    blocks = SMS * BLOCKS_PER_SM // max(k, 1)
    if transposed:
        blocks = min(blocks, m // MIN_COL_ROWS)
    else:
        blocks = max(blocks, -(-m * n * elem_bytes // ROW_BLOCK_BYTES))
    blocks = max(1, min(blocks, m))
    chunk = -(-m // blocks)
    if transposed and COL_CHUNK_BYTES[elem_bytes] and n > 0:
        chunk = min(chunk, COL_CHUNK_BYTES[elem_bytes] // (n * elem_bytes))
    chunk = max(chunk, 1)
    blocks = min(blocks, max(1, -(-m // chunk)))
    n_slabs, width = slabs(n)
    # about sqrt(blocks) partials added at each of the two levels
    group = math.isqrt(blocks - 1) + 1 if transposed else 1
    return StreamPlan(blocks, chunk, n_slabs, width, STAGE_BYTES, DEPTH,
                      DEPTH * STAGE_BYTES + 4 * width, group)


def block_rows(m: int, plan: StreamPlan):
    """The rows of each block of a lane, in block order, each block's as
    its chunks ``[(lo, hi), ...]`` in the order it streams them (the
    source's ``Share``)."""
    r, b = plan.chunk_rows, plan.blocks
    total = -(-m // r)
    return [[(c * r, min(m, (c + 1) * r)) for c in range(j, total, b)]
            for j in range(b)]


def library() -> ctypes.CDLL:
    """The kernels' shared library, built if needed, with its C
    signatures declared."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _build.load("pdhg_matvec")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bmatvec.argtypes = [i, p, p, p, i, i, i, i, i, p, p]
    lib.bmatvec.restype = i
    lib.bmatvec_t.argtypes = [i, p, p, p, p, p, i, i, i, i, i, i, p, p]
    lib.bmatvec_t.restype = i
    lib.pdhg_matvec_error_string.argtypes = [i]
    lib.pdhg_matvec_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def col_chunks(k: int, m: int, n: int):
    """``(chunk_rows, n_chunks)`` of the column pass over ``[k, m, n]``:
    enough chunks that the grid holds about :data:`TARGET_BLOCKS` blocks,
    each chunk between :data:`MIN_CHUNK_ROWS` and :data:`MAX_CHUNK_ROWS`
    rows, none of them empty.  Depends on the shape only, so the sum
    order, and the result, is the same on every call."""
    tiles = max(1, -(-n // THREADS)) * max(k, 1)
    want = -(-TARGET_BLOCKS // tiles)
    n_chunks = max(1, min(want, -(-m // MIN_CHUNK_ROWS)),
                   -(-m // MAX_CHUNK_ROWS))
    rows = -(-m // n_chunks)
    return rows, (-(-m // rows) if rows else 1)


def check_operands(name: str, A, vecs, vec_dtypes=None):
    """``(k, M, N)`` after checking ``A`` (a contiguous CUDA ``[k, M, N]``
    f32/bf16 tensor) and each ``(tensor, length)`` of ``vecs``: a
    contiguous CUDA ``[k, length]`` tensor of its dtype (f32 unless
    ``vec_dtypes`` says otherwise), or ``[k]`` where the length is None."""
    if (A.ndim != 3 or not A.is_cuda or A.dtype not in COEF
            or not A.is_contiguous()):
        raise ValueError(
            f"{name}: A must be a contiguous CUDA [k, M, N] float32 or "
            f"bfloat16 tensor; got {A.dtype} {tuple(A.shape)} on {A.device} "
            f"(contiguous={A.is_contiguous()})")
    k, m, n = A.shape
    lengths = {"M": m, "N": n}
    dtypes = vec_dtypes or (_F,) * len(vecs)
    for (v, length), dt in zip(vecs, dtypes):
        shape = (k,) if length is None else (k, lengths[length])
        if (tuple(v.shape) != shape or not v.is_cuda or v.dtype != dt
                or not v.is_contiguous() or v.device != A.device):
            raise ValueError(
                f"{name}: operand must be a contiguous CUDA {dt} tensor of "
                f"shape {shape} on {A.device} (A is [{k}, {m}, {n}]); got "
                f"{v.dtype} {tuple(v.shape)} on {v.device} "
                f"(contiguous={v.is_contiguous()})")
    return k, m, n


def raise_on_error(lib, err_fn: str, name: str, err: int) -> None:
    if err != 0:
        msg = getattr(lib, err_fn)(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({err}: {msg})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def tickets(device: torch.device, stream: int, count: int) -> torch.Tensor:
    """The zeroed int32 tickets (at least ``count``) of ``bmatvec_t`` on
    this device and stream: each launch leaves them 0 again, so launches on
    one stream share them and launches on two streams never do."""
    key = (device.index, stream)
    t = _tickets.get(key)
    if t is None or t.numel() < count:
        t = _tickets[key] = torch.zeros(max(count, 1), dtype=torch.int32,
                                        device=device)
    return t


def bmatvec(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y [k, M] = A [k, M, N] x [k, N] (f32 accumulation)."""
    k, m, n = check_operands("bmatvec", A, ((x, "N"),))
    lib = library()
    plan = stream_plan(k, m, n, elem_bytes=A.element_size())
    y = torch.empty((k, m), dtype=_F, device=A.device)
    launches = ctypes.c_int(0)
    err = lib.bmatvec(COEF[A.dtype], A.data_ptr(), x.data_ptr(),
                      y.data_ptr(), k, m, n, plan.blocks, plan.chunk_rows,
                      ctypes.byref(launches), stream_of(A))
    raise_on_error(lib, "pdhg_matvec_error_string", "bmatvec", err)
    LAUNCHES["bmatvec"] += 1
    CUDA_LAUNCHES["bmatvec"] += launches.value
    return y


def bmatvec_t(A: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x [k, N] = A^T y [k, M], reading A untransposed."""
    k, m, n = check_operands("bmatvec_t", A, ((y, "M"),))
    lib = library()
    plan = stream_plan(k, m, n, True, A.element_size())
    stream = stream_of(A)
    x = torch.empty((k, n), dtype=_F, device=A.device)
    if plan.blocks > 1:
        part = torch.empty((k, plan.blocks, (n + 3) & ~3), dtype=_F,
                           device=A.device)
        ticket = tickets(A.device, stream, k * (1 + plan.n_groups))
    else:
        part = ticket = x
    launches = ctypes.c_int(0)
    err = lib.bmatvec_t(COEF[A.dtype], A.data_ptr(), y.data_ptr(),
                        part.data_ptr(), ticket.data_ptr(), x.data_ptr(), k,
                        m, n, plan.blocks, plan.chunk_rows, plan.group,
                        ctypes.byref(launches), stream)
    raise_on_error(lib, "pdhg_matvec_error_string", "bmatvec_t", err)
    LAUNCHES["bmatvec_t"] += 1
    CUDA_LAUNCHES["bmatvec_t"] += launches.value
    return x
