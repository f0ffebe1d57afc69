"""Load and launch the hand-written CUDA dense matvecs
(``csrc/pdhg_matvec.cu``, kernels in ``csrc/dense_pdhg.cuh``) — the port of
``repro/kernels/pdhg_matvec.py`` (``bmatvec`` :67, ``bmatvec_t`` :89).

The library is built at first use by :mod:`.build` (``nvcc`` for
``sm_90a``, loaded with ``ctypes``); nothing is built when this module is
imported, and a build failure raises.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs (and the column pass's chunk partials) with ``torch.empty``,
launches on the current stream, raises on a nonzero ``cudaGetLastError``
and then adds one to its entry in :data:`LAUNCHES`.  ``A`` is
``[k, M, N]`` f32 or bf16; the vectors are f32.  The helpers here are
shared with :mod:`.fused_pdhg_step`, whose kernels reuse the products.
"""

from __future__ import annotations

import ctypes

import torch

from . import build as _build

# launches of each wrapper since the counts were last set to 0
LAUNCHES = {"bmatvec": 0, "bmatvec_t": 0}

# the kernels' block size (the source's kThreads)
THREADS = 256
# the column pass cuts M into chunks so that at least about this many
# blocks share the card, chunks of at least MIN_CHUNK_ROWS rows and at most
# MAX_CHUNK_ROWS (the chunk of the row vector a block stages in shared
# memory, 16 KB)
TARGET_BLOCKS = 2048
MIN_CHUNK_ROWS = 32
MAX_CHUNK_ROWS = 4096

# coefficient storage codes of the C interface
COEF = {torch.float32: 0, torch.bfloat16: 1}

_F = torch.float32
_lib = None


def library() -> ctypes.CDLL:
    """The kernels' shared library, built if needed, with its C
    signatures declared."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _build.load("pdhg_matvec")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bmatvec.argtypes = [i, p, p, p, i, i, i, p]
    lib.bmatvec.restype = i
    lib.bmatvec_t.argtypes = [i, p, p, p, p] + [i] * 5 + [p]
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


def bmatvec(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y [k, M] = A [k, M, N] x [k, N] (f32 accumulation)."""
    k, m, n = check_operands("bmatvec", A, ((x, "N"),))
    lib = library()
    y = torch.empty((k, m), dtype=_F, device=A.device)
    err = lib.bmatvec(COEF[A.dtype], A.data_ptr(), x.data_ptr(),
                      y.data_ptr(), k, m, n, stream_of(A))
    raise_on_error(lib, "pdhg_matvec_error_string", "bmatvec", err)
    LAUNCHES["bmatvec"] += 1
    return y


def bmatvec_t(A: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x [k, N] = A^T y [k, M], reading A untransposed."""
    k, m, n = check_operands("bmatvec_t", A, ((y, "M"),))
    lib = library()
    rows, n_chunks = col_chunks(k, m, n)
    x = torch.empty((k, n), dtype=_F, device=A.device)
    part = (torch.empty((k, n_chunks, n), dtype=_F, device=A.device)
            if n_chunks > 1 else x)
    err = lib.bmatvec_t(COEF[A.dtype], A.data_ptr(), y.data_ptr(),
                        part.data_ptr(), x.data_ptr(), k, m, n, rows,
                        n_chunks, stream_of(A))
    raise_on_error(lib, "pdhg_matvec_error_string", "bmatvec_t", err)
    LAUNCHES["bmatvec_t"] += 1
    return x
