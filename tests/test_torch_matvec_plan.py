"""The Python side of the dense matvecs' stream plan
(``repro_torch.kernels.pdhg_matvec``), on the CPU.

``bmatvec`` and ``bmatvec_t`` run on the card only (``csrc/pdhg_matvec.cu``,
held against their plain versions in ``tests/test_torch_cuda.py``); here:

* the plan gives every row of every lane to exactly one block, in order,
  at the main path's densified stack and at shapes that stress each rule;
* a block's ring and slab fit its share of an SM's shared memory;
* the wrapper's constants are the source's;
* a plain emulation of ``bmatvec_t``'s order (each block's rows added in
  row order, the blocks' partials added in block order) agrees with the
  reference's interpret-mode kernel at 1e-5 on the shapes of
  ``tests/test_kernels.py``."""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro_torch.kernels import pdhg_matvec as mv

SOURCE = Path(mv.__file__).parent / "csrc" / "pdhg_matvec.cu"

# the densified main-path stack, a row longer than a stage (several
# slabs), byte offsets past 2^32, k beyond the grid, M = 1, M = 0, N = 0,
# and the reference's kernel-test shapes
PLAN_SHAPES = [(8, 4_099, 6_145), (1, 64, 80_000), (2, 20_000, 30_000),
               (300, 5, 7), (4, 1, 1_000), (1, 500, 700), (3, 0, 9),
               (2, 7, 0), (1, 128, 128), (2, 256, 256), (3, 300, 180),
               (4, 64, 512), (2, 512, 64), (8, 129, 257)]
KERNEL_TEST_SHAPES = [(1, 128, 128), (2, 256, 256), (3, 300, 180),
                      (4, 64, 512), (2, 512, 64), (8, 129, 257)]


def _rows_of(blocks):
    """Each block's rows, in the order it streams them."""
    return [[r for lo, hi in chunks for r in range(lo, hi)]
            for chunks in blocks]


@pytest.mark.parametrize("transposed", [False, True], ids=["rows", "cols"])
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_plan_covers_every_row_once_in_order(shape, transposed):
    k, m, n = shape
    plan = mv.stream_plan(k, m, n, transposed)
    rows = _rows_of(mv.block_rows(m, plan))
    assert len(rows) == plan.blocks >= 1
    assert sorted(r for block in rows for r in block) == list(range(m))
    assert all(block == sorted(block) for block in rows)
    if m > 0:
        assert all(rows)
    sizes = [len(block) for block in rows]
    wave = mv.SMS * mv.BLOCKS_PER_SM
    if transposed:
        # one wave: at most BLOCKS_PER_SM blocks an SM
        if k <= wave:
            assert k * plan.blocks <= wave
        if m >= 2 * mv.MIN_COL_ROWS:
            # the last block may hold the lane's short last chunk
            assert min(sizes[:-1]) >= mv.MIN_COL_ROWS
    elif m > 0:
        # one chunk a block: at least a wave where M allows, blocks of at
        # most about ROW_BLOCK_BYTES beyond it
        assert all(len(chunks) == 1 for chunks in mv.block_rows(m, plan))
        assert plan.blocks >= max(1, min(m, wave // max(k, 1)) // 2)
        if wave // k < plan.blocks < m:
            assert (max(sizes) - 1) * n * 4 <= mv.ROW_BLOCK_BYTES


def test_plan_at_the_densified_stack():
    """[8, 4,099, 6,145]: bmatvec_t's 33 blocks a lane fill 264 = 2 x 132
    SMs in one wave, in groups of 6, each block 120-130 rows, in chunks of
    5 rows (123 KB) with f32 A and in one range of 125 rows (the last 99)
    with bf16; bmatvec's blocks of 3 rows (f32) or 6 (bf16) come in many
    waves; one slab holds a whole row of x."""
    for transposed, elem_bytes, blocks, chunk, rows in (
            (True, 4, 33, 5, range(120, 131)),
            (True, 2, 33, 125, {125, 99}),
            (False, 4, 1_367, 3, {3, 1}),
            (False, 2, 684, 6, {6, 1})):
        plan = mv.stream_plan(8, 4_099, 6_145, transposed, elem_bytes)
        assert (plan.blocks, plan.chunk_rows) == (blocks, chunk)
        assert plan.n_slabs == 1 and plan.slab_width == 6_145
        assert plan.group == (6 if transposed else 1)
        sizes = {len(b) for b in _rows_of(mv.block_rows(4_099, plan))}
        assert sizes <= set(rows)


def test_cuda_test_shapes_take_their_branches():
    """The shapes of the CUDA tests reach what they are named for
    (``tests/test_torch_cuda.py``: STREAM_SHAPES)."""
    rows_long = mv.stream_plan(1, 64, 80_000)
    assert rows_long.n_slabs > 1
    assert 80_000 * 4 > mv.STAGE_BYTES
    assert mv.stream_plan(2, 1_000, 300).blocks > 1
    assert mv.stream_plan(2, 1_000, 300, transposed=True).blocks > 1
    assert mv.stream_plan(300, 5, 7).blocks == 1
    assert mv.stream_plan(4, 1, 1_000, transposed=True).blocks == 1
    assert mv.stream_plan(1, 64, 80_000, transposed=True).blocks == 2
    # f32 blocks of bmatvec_t take several chunks, bf16 blocks one
    for elem_bytes, several in ((4, True), (2, False)):
        plan = mv.stream_plan(2, 3_000, 4_000, True, elem_bytes)
        chunks = mv.block_rows(3_000, plan)
        assert (max(len(c) for c in chunks) > 1) == several


@pytest.mark.parametrize("n", [0, 1, 6_145, 8_192, 8_193, 30_000, 80_000])
def test_slabs_cover_the_columns(n):
    count, width = mv.slabs(n)
    assert width <= mv.SLAB_FLOATS
    if n > 0:
        assert count * width >= n > (count - 1) * width
        assert count == -(-n // mv.SLAB_FLOATS)


@pytest.mark.parametrize("elem_bytes", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_ring_and_slab_fit_the_shared_memory_budget(shape, elem_bytes):
    plan = mv.stream_plan(*shape, elem_bytes=elem_bytes)
    assert plan.stage_bytes == mv.STAGE_BYTES
    assert plan.smem_bytes == plan.depth * plan.stage_bytes + 4 * \
        plan.slab_width
    widest = mv.DEPTH * mv.STAGE_BYTES + 4 * mv.SLAB_FLOATS
    assert plan.smem_bytes <= widest
    per_block = widest + mv.BLOCK_RESERVED_BYTES + mv.STATIC_SMEM_BYTES
    assert mv.BLOCKS_PER_SM * per_block <= mv.SM_SMEM_BYTES
    # every copy is a whole number of 16-byte units
    assert plan.stage_bytes % 16 == 0


def _constants(text):
    return {name: int(value) for name, value in
            re.findall(r"constexpr int (k\w+) = (\d+);", text)}


def test_wrapper_constants_match_the_source():
    text = SOURCE.read_text()
    const = _constants(text)
    assert const["kConsumers"] == mv.CONSUMERS
    assert const["kStageBytes"] == mv.STAGE_BYTES
    assert const["kDepth"] == mv.DEPTH
    assert const["kSlabFloats"] == mv.SLAB_FLOATS
    assert const["kBlocksPerSm"] == mv.BLOCKS_PER_SM
    # the source's own budget check uses the wrapper's numbers
    budget = re.search(r"static_assert\(kBlocksPerSm \* \(kSmemBytes \+ "
                       r"(\d+) \+ (\d+)\) <= (\d+)", text)
    assert budget is not None
    assert tuple(int(v) for v in budget.groups()) == (
        mv.BLOCK_RESERVED_BYTES, mv.STATIC_SMEM_BYTES, mv.SM_SMEM_BYTES)
    # the static shared memory: 2 x kDepth barriers and the warp sums
    static = 2 * 8 * mv.DEPTH + 4 * 2 * (mv.CONSUMERS // 32)
    assert static <= mv.STATIC_SMEM_BYTES


def emulate_bmatvec_t(A: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x = A^T y in ``bmatvec_t``'s order: each block of the plan adds its
    rows, in the order it streams them, into its partials; each group of
    ``plan.group`` blocks adds its partials in block order, then the group
    sums are added in group order (f32 throughout; the kernel fuses each
    product into its add)."""
    k, m, n = A.shape
    A, y = A.to(torch.float32), y.to(torch.float32)
    plan = mv.stream_plan(k, m, n, transposed=True)
    parts = []
    for rows in _rows_of(mv.block_rows(m, plan)):
        part = torch.zeros((k, n), dtype=torch.float32)
        for r in rows:
            part = part + A[:, r, :] * y[:, r, None]
        parts.append(part)

    def in_order(terms):
        total = terms[0]
        for t in terms[1:]:
            total = total + t
        return total

    return in_order([in_order(parts[g:g + plan.group])
                     for g in range(0, plan.blocks, plan.group)])


@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 33 * 32, 264 * 32])
def test_groups_cover_the_blocks(m):
    """Groups of about sqrt(blocks): every block in one group, in order,
    and the two levels add about 2 sqrt(blocks) partials in a row."""
    plan = mv.stream_plan(1, m, 64, transposed=True)
    starts = range(0, plan.blocks, plan.group)
    groups = [list(range(g, min(plan.blocks, g + plan.group)))
              for g in starts]
    assert len(groups) == plan.n_groups
    assert [j for grp in groups for j in grp] == list(range(plan.blocks))
    assert plan.group + plan.n_groups <= 2 * math.isqrt(plan.blocks) + 3


@pytest.mark.parametrize("shape", KERNEL_TEST_SHAPES, ids=str)
def test_bmatvec_t_order_matches_reference_kernel(shape):
    k, m, n = shape
    rng = np.random.default_rng(11)
    A = rng.normal(size=shape).astype(np.float32)
    y = rng.normal(size=(k, m)).astype(np.float32)
    assert mv.stream_plan(k, m, n, transposed=True).blocks > 1
    got = emulate_bmatvec_t(torch.tensor(A), torch.tensor(y))
    want = np.asarray(rops.bmatvec_t(jnp.asarray(A), jnp.asarray(y),
                                     backend="interpret"))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
