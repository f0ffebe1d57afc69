"""The host side of the port's redesigned kernels, on the CPU.

* ``pop.reduce`` hands ``extract`` per-lane views of the device fields, so
  a stack built on a dense K never copies K to the host, and the Gavel and
  traffic allocations equal those of a reduce over host copies;
* the lane and full wrappers' constants and C structs match their CUDA
  sources (``csrc/*.cu``);
* an operator side is checked and packed once: the pack is reused while
  its tensors live unmodified, re-checked after an in-place change, and
  dropped when the operator is freed; the plan is laid out once per
  operator and plan object;
* the lane kernels' sorted bucket columns and the cooperative kernels'
  tile tables say what the plain versions compute; the full backward
  kernel's group widths are what the packed ELL stores, rebuilt after an
  in-place change, and a bucket no segment folds onto gets no tile.

No JAX here: the reference is the port's own plain versions."""

import gc
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import testing
from repro_torch.core import pdhg, pop
from repro_torch.core.pdhg import OperatorLP, map_arrays
from repro_torch.core.reduce import coalesce_concat, coalesce_replicated
from repro_torch.kernels import ref
from repro_torch.kernels import structured_full_pdhg_step as kfull
from repro_torch.kernels import structured_pdhg_step as klane
from repro_torch.problems.cluster_scheduling import (GavelProblem,
                                                     make_cluster_workload)

CSRC = Path(klane.__file__).parent / "csrc"


# --------------------------------------------------------------------------
# pop.reduce copies only what extract reads
# --------------------------------------------------------------------------

class _Counting(torch.Tensor):
    """A tensor that records every host copy made of it or its views."""

    copies: list = []
    _HOST = ("cpu", "to", "numpy", "__array__", "tolist", "item")

    @classmethod
    def __torch_function__(cls, func, types_, args=(), kwargs=None):
        if getattr(func, "__name__", "") in cls._HOST:
            cls.copies.append(tuple(args[0].shape))
        return super().__torch_function__(func, types_, args, kwargs or {})


class _DenseProblem(pop.POPProblem):
    """n entities, one variable each, a dense K of ones per lane (the
    default ``K_mv``); ``extract`` reads ``c`` only."""

    def __init__(self, n: int, m: int):
        self.n_entities, self.m = n, m

    def entity_attrs(self):
        return np.arange(self.n_entities, dtype=np.float64)[:, None]

    def build_sub(self, idx_row, frac, scale=None):
        n = idx_row.shape[0]
        f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)
        return OperatorLP(
            c=f32(np.where(idx_row >= 0, idx_row, 0)), q=f32(np.ones(self.m)),
            l=f32(np.zeros(n)), u=f32(np.ones(n)),
            ineq_mask=torch.ones(self.m, dtype=torch.bool),
            data=(f32(np.ones((self.m, n))),))

    def extract(self, op, x, idx_row):
        c = op.c.numpy(force=True)
        return np.asarray(x)[: idx_row.shape[0]] + c[: idx_row.shape[0]]


def _host_reduce(problem, plan, ops, res):
    """The reduce that copies every LP field and ``op.data`` to the host
    first (what ``pop.reduce`` did before it took device views)."""
    host = map_arrays(lambda a: a.cpu(), ops._replace(structured=None))
    allocs = np.stack([
        np.asarray(problem.extract(map_arrays(lambda a, i=i: a[i], host),
                                   np.asarray(res.x[i]), plan.idx[i]))
        for i in range(plan.k)])
    if plan.replication is None:
        return coalesce_concat(allocs, plan.idx, plan.n_entities)
    return coalesce_replicated(allocs, plan.idx, plan.replication)


def _fake_result(ops, seed=0):
    k, n = ops.c.shape
    x = np.random.default_rng(seed).random((k, n)).astype(np.float32)
    return types.SimpleNamespace(x=x)


def test_reduce_copies_no_dense_K_to_the_host():
    prob = _DenseProblem(24, 5)
    plan = pop.plan(prob, 3, strategy="random")
    ops = pop.build(prob, plan, "cpu")
    K = ops.data[0]
    counted = ops._replace(
        data=(K.as_subclass(_Counting),),
        c=ops.c.as_subclass(_Counting))
    _Counting.copies = []
    got = pop.reduce(prob, plan, counted, _fake_result(ops))
    lane_K = tuple(K.shape[1:])
    assert tuple(K.shape) not in _Counting.copies
    assert lane_K not in _Counting.copies, _Counting.copies
    assert _Counting.copies, "extract's copy of c was not recorded"
    np.testing.assert_array_equal(
        got, _host_reduce(prob, plan, ops, _fake_result(ops)))
    # the reduce that copies everything first does copy K: the check sees it
    _Counting.copies = []
    _host_reduce(prob, plan, counted, _fake_result(ops))
    assert tuple(K.shape) in _Counting.copies


@pytest.mark.parametrize("domain", ["gavel", "traffic"])
def test_reduce_allocations_unchanged(domain):
    if domain == "gavel":
        prob = GavelProblem(make_cluster_workload(48, num_workers=(8, 8, 8),
                                                  seed=4))
    else:
        prob = testing.traffic_problem(
            30, n_nodes=24, target_edges=48, n_paths=3, max_len=12,
            topo_seed=1, demand_seed=1, path_seed=1)
    plan = pop.plan(prob, 4, strategy="stratified")
    ops = pop.build(prob, plan, "cpu")
    res = _fake_result(ops, seed=3)
    np.testing.assert_array_equal(pop.reduce(prob, plan, ops, res),
                                  _host_reduce(prob, plan, ops, res))


# --------------------------------------------------------------------------
# the wrappers against their CUDA sources
# --------------------------------------------------------------------------

def _constants(src: str) -> dict:
    """The ``constexpr int`` values of a CUDA source, evaluated in order."""
    env: dict = {}
    for name, expr in re.findall(r"constexpr int (\w+) =\s*([^;]+);", src):
        expr = re.sub(r"sizeof\(\w+\)", "4", expr)
        env[name] = eval(expr, {}, dict(env))
    return env


def _struct_fields(src: str, name: str) -> list:
    """(field, C type) of ``struct name`` in declaration order."""
    body = re.search(rf"struct {name} \{{(.*?)\n\}};", src, re.S).group(1)
    fields = []
    for line in body.splitlines():
        decl = line.split("//")[0].strip().rstrip(";")
        if not decl:
            continue
        ctype, names = re.match(r"((?:const )?\w+\*?)\s+(.+)", decl).groups()
        fields += [(n.strip(), ctype) for n in names.split(",")]
    return fields


@pytest.mark.parametrize("module,source,struct", [
    (klane, "structured_pdhg_step.cu", "LaneSide"),
    (kfull, "structured_full_pdhg_step.cu", "FullSide"),
], ids=["lane", "full"])
def test_packed_struct_matches_the_source(module, source, struct):
    """The ctypes struct the wrapper fills has the C struct's fields, in
    order, pointers where the source has pointers and 32-bit ints where it
    has int32_t."""
    fields = _struct_fields((CSRC / source).read_text(), struct)
    py = getattr(module, struct)._fields_
    assert [n for n, _ in py] == [n for n, _ in fields]
    for (_, pytype), (name, ctype) in zip(py, fields):
        want = ("c_void_p" if ctype.endswith("*") else "c_int")
        assert pytype.__name__ == want, (name, ctype, pytype)


def test_lane_constants_match_the_source():
    """Cluster block size, largest cluster, entries loaded ahead of their
    gathers; the wrapper's cluster size is one the kernel takes."""
    const = _constants((CSRC / "structured_pdhg_step.cu").read_text())
    assert klane.CLUSTER_THREADS == const["kClusterThreads"]
    assert klane.MAX_CLUSTER == const["kMaxCluster"] == 16
    assert klane.GATHER_BATCH == const["kGatherBatch"]
    assert klane.LANE_SMEM_BYTES == const["kLaneSmemBytes"]
    assert 1 <= klane.CLUSTER <= klane.MAX_CLUSTER
    # a lane's tail and the row-group sums fit the 227 KB of an SM
    assert klane.LANE_SMEM_BYTES + 4 * klane.CLUSTER_THREADS == 227 * 1024


def test_full_constants_match_the_source():
    """Threads per narrow row (one per warp), rows per lane, blocks per SM
    and shared memory of the cooperative kernels; the group width table's
    4 segments are a lane's 4."""
    const = _constants((CSRC / "structured_full_pdhg_step.cu").read_text())
    assert kfull.NARROW_WARPS == const["kNarrowWarps"] == kfull.THREADS // 32
    assert kfull.ROWS_PER_LANE == const["kRowsPerLane"]
    assert kfull.COOP_BLOCKS_PER_SM == const["kCoopBlocksPerSM"]
    assert (kfull.COOP_BACKWARD_BLOCKS_PER_SM
            == const["kCoopBackwardBlocksPerSM"])
    assert kfull.COOP_SMEM_MAX == const["kCoopSmemMax"]
    assert kfull.COOP_SMEM_MAX + 4 * 8 * 128 <= 227 * 1024
    assert kfull.VARIANT in (1, 2)
    s = testing.ragged_operator()
    w, n = s.col_val.shape[1:]
    assert kfull.group_widths(s.col_val).shape == (
        -(-n // kfull.ROWS_PER_LANE),)


# --------------------------------------------------------------------------
# the operator pack cache
# --------------------------------------------------------------------------

def _lane_side(s):
    return (s.col_idx, s.col_val, s.wcol_idx, s.wcol_val, s.wcol_ids)


def _full_side(s):
    return (s.row_idx, s.row_val, s.row_scale, s.wrow_idx, s.wrow_val,
            s.wrow_scale, s.row_fold)


def test_lane_pack_is_reused_and_rechecked_after_an_inplace_change():
    s = testing.skewed_operator(3, 45, 67, 0.25, True)
    m = s.row_idx.shape[-1]
    p = klane.side_pack("t", _lane_side(s), m)
    assert klane.side_pack("t", _lane_side(s), m) is p
    assert (p.struct.k, p.struct.s_len, p.struct.v_len) == (
        3, s.col_idx.shape[-1], m)
    s.wcol_ids[0, 0] = s.col_idx.shape[-1]        # out of range, in place
    with pytest.raises(ValueError, match="bucket ids"):
        klane.side_pack("t", _lane_side(s), m)
    s.wcol_ids[0, 0] = 0
    q = klane.side_pack("t", _lane_side(s), m)
    assert q is not p and klane.side_pack("t", _lane_side(s), m) is q


def test_full_pack_is_rechecked_after_an_inplace_change():
    s = testing.ragged_operator()
    rplan, _ = pdhg._wide_block_plans(s)
    n = s.col_idx.shape[-1]
    p = kfull.side_pack("t", _full_side(s), n, rplan)
    assert kfull.side_pack("t", _full_side(s), n, rplan) is p
    s.row_fold[0, 0] = s.wrow_idx.shape[-1] + 1
    with pytest.raises(ValueError, match="fold map"):
        kfull.side_pack("t", _full_side(s), n, rplan)


@pytest.mark.parametrize("which", ["lane", "full"])
def test_pack_forgets_a_freed_operator(which):
    if which == "lane":
        s = testing.skewed_operator(2, 30, 40, 0.3, True)
        cache = klane._packs
        klane.side_pack("t", _lane_side(s), s.row_idx.shape[-1])
        key = id(s.col_idx)
    else:
        s = testing.ragged_operator()
        cache = kfull._packs
        kfull.side_pack("t", _full_side(s), s.col_idx.shape[-1],
                        pdhg._wide_block_plans(s)[0])
        key = id(s.row_idx)
    assert key in cache
    del s
    gc.collect()
    assert key not in cache


def test_plan_layout_runs_once_per_operator_and_plan(monkeypatch):
    calls = []
    layout = kfull.plan_layout
    monkeypatch.setattr(kfull, "plan_layout",
                        lambda *a: calls.append(a) or layout(*a))
    s = testing.ragged_operator()
    rplan, _ = pdhg._wide_block_plans(s)
    n = s.col_idx.shape[-1]
    for _ in range(3):
        p = kfull.side_pack("t", _full_side(s), n, rplan)
    assert len(calls) == 1
    assert p.plan is rplan and p.struct.n_blocks == len(rplan)
    kfull.side_pack("t", _full_side(s), n, tuple(list(rplan)))
    assert len(calls) == 2


def test_calls_need_cuda_tensors():
    s = testing.skewed_operator(2, 30, 40, 0.3, True)
    o = testing.step_tensors(s, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        klane.backward_checks(s, o["y"], o["q"], o["sigma"], o["mask"],
                              o["kxn"], o["kxp"])
    f = testing.ragged_operator()
    fo = testing.step_tensors(f, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        kfull.forward_checks(f, fo["x"], fo["c"], fo["l"], fo["u"],
                             fo["tau"], fo["kty"],
                             pdhg._wide_block_plans(f)[0])


# --------------------------------------------------------------------------
# what the kernels' index tables say
# --------------------------------------------------------------------------

@pytest.mark.parametrize("cluster", [4, 8, 16])
@pytest.mark.parametrize("shape", [(1, 64, 96, 0.3), (4, 130, 250, 0.05),
                                   (2, 256, 129, 0.1)], ids=str)
def test_lane_wide_order_gives_the_plain_product(shape, cluster):
    """The backward kernel's phase 3 in torch: each cluster block takes the
    range of the lane's sorted bucket columns whose segments it owns (the
    kernel's binary search) and adds each column's sum onto its segment's
    narrow sum; that is K^T y of the plain version, every real column
    taken once, the padded columns that stack_ops adds never."""
    s = testing.skewed_operator(*shape, True)
    k, m = shape[0], shape[1]
    y = torch.as_tensor(np.random.default_rng(2).normal(size=(k, m)),
                        dtype=torch.float32)
    n = s.col_idx.shape[-1]
    wsort, nreal = klane.wide_order(s.wcol_ids, s.wcol_val, n)
    narrow = torch.sum(s.col_val * ref._bgather(y, s.col_idx), dim=-2)
    wide = torch.sum(s.wcol_val * ref._bgather(y, s.wcol_idx), dim=-2)
    got = narrow.clone()
    seg_per_block = -(-n // cluster)
    for b in range(k):
        targets = s.wcol_ids[b][wsort[b, :nreal[b]].long()].numpy()
        assert (np.diff(targets) > 0).all()
        taken = 0
        for r in range(cluster):
            s0, s1 = r * seg_per_block, min(n, (r + 1) * seg_per_block)
            lo = np.searchsorted(targets, s0, side="left")
            hi = np.searchsorted(targets, s1, side="left")
            for mm in range(lo, hi):
                d = int(wsort[b, mm])
                got[b, targets[mm]] += wide[b, d]
            taken += hi - lo
        assert taken == int(nreal[b])
    torch.testing.assert_close(got, ref.smatvec_t(s, y), rtol=1e-5,
                               atol=1e-5)
    real = (s.wcol_val != 0).any(dim=1)
    assert nreal.tolist() == real.sum(dim=1).tolist()


def test_cooperative_tile_table_covers_the_plan():
    """The plan rows' first-tile column numbers every wide tile once, in
    plan order, and the binary search of the kernel finds each tile's
    block."""
    s = testing.ragged_operator()
    rplan, _ = pdhg._wide_block_plans(s)
    ww, d = s.wrow_idx.shape[1:]
    tc, n_tiles, _ = kfull.plan_layout(rplan, d, ww)
    rows = np.array(kfull.plan_rows(rplan, d, ww, tc))
    chunk = (kfull.THREADS // tc) * kfull.WIDE_ITERS
    per_block = [-(-(c1 - c0) // tc) * -(-wb // chunk)
                 for c0, c1, wb in rplan]
    assert rows[:, 3].tolist() == np.concatenate(
        [[0], np.cumsum(per_block)[:-1]]).tolist()
    owner = np.searchsorted(rows[:, 3], np.arange(n_tiles),
                            side="right") - 1
    assert np.bincount(owner, minlength=len(rplan)).tolist() == per_block
    assert rows[:, :3].tolist() == [list(b) for b in rplan]


def test_cooperative_tile_table_covers_the_column_plan():
    """The backward kernel reads the column plan with the same four
    columns: its first-tile numbers count every wide tile of the column
    bucket once, in plan order, and the pack lays it out so."""
    s = testing.ragged_operator()
    _, cplan = pdhg._wide_block_plans(s)
    ww, d = s.wcol_idx.shape[1:]
    tc, n_tiles, _ = kfull.plan_layout(cplan, d, ww)
    rows = np.array(kfull.plan_rows(cplan, d, ww, tc))
    chunk = (kfull.THREADS // tc) * kfull.WIDE_ITERS
    per_block = [-(-(c1 - c0) // tc) * -(-wb // chunk)
                 for c0, c1, wb in cplan]
    assert len(cplan) >= 3 and rows.shape == (len(cplan), 4)
    assert rows[:, 3].tolist() == np.concatenate(
        [[0], np.cumsum(per_block)[:-1]]).tolist()
    owner = np.searchsorted(rows[:, 3], np.arange(n_tiles),
                            side="right") - 1
    assert np.bincount(owner, minlength=len(cplan)).tolist() == per_block
    p = kfull.side_pack("t", _col_side(s), s.row_idx.shape[-1], cplan)
    assert p.plan_t.tolist() == rows.tolist()
    assert (p.struct.n_blocks, p.struct.tc, p.struct.n_tiles) == (
        len(cplan), tc, n_tiles)


def _col_side(s):
    return (s.col_idx, s.col_val, s.col_scale, s.wcol_idx, s.wcol_val,
            s.wcol_scale, s.col_fold)


def _np_group_widths(val):
    """Each 4-segment group's stored width, in numpy: the last nonzero
    coefficient's position plus one, the largest of the group's 4."""
    v = np.asarray(val[0].float())
    w, s_len = v.shape
    nz = v != 0
    last = np.where(nz.any(axis=0), w - np.argmax(nz[::-1], axis=0), 0)
    last = np.pad(last, (0, -s_len % 4))
    return last.reshape(-1, 4).max(axis=1)


FULL_OPERATORS = {
    "traffic": lambda: map_arrays(lambda a: a[None], testing.traffic_problem(
        30, n_nodes=24, target_edges=48, n_paths=3, max_len=12, topo_seed=1,
        demand_seed=1, path_seed=1).build_full().structured),
    "gavel_full": lambda: map_arrays(lambda a: a[None], GavelProblem(
        make_cluster_workload(96, num_workers=(16, 16, 16), seed=0))
        .build_full().structured),
    "ragged": testing.ragged_operator,
}


@pytest.mark.parametrize("coef_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("case", sorted(FULL_OPERATORS))
def test_group_widths_match_numpy(case, coef_dtype):
    """The pack's width table of each side equals a numpy computation, and
    covers every nonzero coefficient: past a group's width every slot of
    its 4 segments holds 0, padding (idx 0) in f32 and bf16; int8 may
    round a small stored coefficient to 0, which the kernel then skips."""
    s = pdhg.quantize_structured(FULL_OPERATORS[case](), coef_dtype)
    plans = pdhg._wide_block_plans(s)
    for side, v_len, plan in ((_full_side(s), s.col_idx.shape[-1], plans[0]),
                              (_col_side(s), s.row_idx.shape[-1], plans[1])):
        idx, val = side[0], side[1]
        gw = kfull.side_pack("t", side, v_len, plan).gw
        want = _np_group_widths(val)
        assert gw.dtype == torch.int32
        assert gw.tolist() == want.tolist()
        w, s_len = val.shape[1:]
        assert gw.shape == (-(-s_len // 4),) and int(gw.max()) <= w
        slot = torch.arange(w)[:, None]
        past = slot >= gw.repeat_interleave(4)[:s_len][None, :]
        assert not (val[0][past] != 0).any()
        if coef_dtype != "int8":
            assert not (idx[0][past] != 0).any()


def test_group_widths_of_skewed_lanes_match_numpy():
    """The width table of a skewed operator's lanes (wide and narrow
    segments side by side, widths up to the padded W), one lane at a
    time."""
    s = testing.skewed_operator(3, 130, 250, 0.05, True)
    for b in range(3):
        for val in (s.row_val[b:b + 1], s.col_val[b:b + 1]):
            assert kfull.group_widths(val).tolist() == (
                _np_group_widths(val).tolist())


def test_group_widths_are_rebuilt_after_an_inplace_change():
    """A nonzero written in place past a group's width widens that group
    in the next pack; the pack before it is not reused."""
    s = testing.ragged_operator()
    _, cplan = pdhg._wide_block_plans(s)
    m = s.row_idx.shape[-1]
    p = kfull.side_pack("t", _col_side(s), m, cplan)
    g = int(torch.argmin(p.gw))
    w = s.col_val.shape[1]
    assert int(p.gw[g]) < w
    s.col_val[0, w - 1, 4 * g + 1] = 0.5
    q = kfull.side_pack("t", _col_side(s), m, cplan)
    assert q is not p and int(q.gw[g]) == w
    assert q.gw.tolist() == _np_group_widths(s.col_val).tolist()


@pytest.mark.parametrize("case,side,has_wide", [
    ("traffic", "col", False), ("traffic", "row", True),
    ("gavel_full", "col", True), ("ragged", "col", True),
    ("ragged", "row", True)])
def test_a_bucket_no_segment_folds_onto_gets_no_tile(case, side, has_wide):
    """The traffic LP's column bucket holds no real column (every fold
    value is the zero slot): its pack lays the plan out with no tile, so
    the kernel skips the wide pass and the fold phase; a real bucket keeps
    every tile of its plan."""
    s = FULL_OPERATORS[case]()
    rplan, cplan = pdhg._wide_block_plans(s)
    if side == "col":
        args = (_col_side(s), s.row_idx.shape[-1], cplan)
        wval, d = s.wcol_val, s.wcol_idx.shape[-1]
    else:
        args = (_full_side(s), s.col_idx.shape[-1], rplan)
        wval, d = s.wrow_val, s.wrow_idx.shape[-1]
    p = kfull.side_pack("t", *args)
    assert p.has_wide is has_wide
    assert bool((args[0][-1] < d).any()) is has_wide
    _, n_tiles, _ = kfull.plan_layout(args[2], d, wval.shape[1])
    assert p.struct.n_tiles == (n_tiles if has_wide else 0)
    if not has_wide:
        assert not (wval != 0).any() and n_tiles > 0


def test_lane_forward_pack_carries_the_sorted_bucket_columns():
    """The forward wrapper packs the row side with its bucket columns
    sorted by row (``wide_order``), as the backward one packs the column
    side: the one-launch kernel's blocks find their rows' columns in it."""
    s = testing.skewed_operator(4, 130, 250, 0.05, True)
    o = testing.step_tensors(s, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        klane.forward_checks(s, o["x"], o["c"], o["l"], o["u"], o["tau"],
                             o["kty"])
    p = klane._packs[id(s.row_idx)]
    wsort, nreal = klane.wide_order(s.wrow_ids, s.wrow_val,
                                    s.row_idx.shape[-1])
    assert torch.equal(p.order[0], wsort) and torch.equal(p.order[1], nreal)
    assert (p.struct.wsort, p.struct.nreal) == (p.order[0].data_ptr(),
                                                p.order[1].data_ptr())
    assert int(nreal.sum()) > 0
    assert (p.struct.v_len, p.struct.s_len) == (s.col_idx.shape[-1],
                                                s.row_idx.shape[-1])


def _side(s, side):
    """(idx, val, widx, wval, wids, v_len, plain product) of one side."""
    k, m, n = s.row_idx.shape[0], s.row_idx.shape[-1], s.col_idx.shape[-1]
    if side == "row":
        return (s.row_idx, s.row_val, s.wrow_idx, s.wrow_val, s.wrow_ids, n,
                ref.smatvec)
    return (s.col_idx, s.col_val, s.wcol_idx, s.wcol_val, s.wcol_ids, m,
            ref.smatvec_t)


def _lane_blocks_product(idx, val, widx, wval, wids, v, blocks):
    """The lane kernels' split in torch: block r of a lane owns segments
    [r SC, (r + 1) SC) and stores their narrow sums, then adds, in column
    order, the whole sum of each real bucket column whose segment it owns
    (the range of the lane's sorted columns between its bounds).  Asserts
    each segment stored once, each real column added once, padded columns
    never."""
    k, _, s_len = idx.shape
    wsort, nreal = klane.wide_order(wids, wval, s_len)
    narrow = torch.sum(val * ref._bgather(v, idx), dim=-2)
    wide = torch.sum(wval * ref._bgather(v, widx), dim=-2)
    got = torch.full((k, s_len), float("nan"))
    sc = -(-s_len // blocks)
    for b in range(k):
        cols = wsort[b, :int(nreal[b])].long()
        segs = wids[b, cols]
        assert bool((segs[1:] >= segs[:-1]).all())
        added = 0
        for r in range(blocks):
            s0, s1 = r * sc, min(s_len, (r + 1) * sc)
            assert bool(torch.isnan(got[b, s0:s1]).all())
            got[b, s0:s1] = narrow[b, s0:s1]
            first = int(torch.searchsorted(segs, s0))
            last = int(torch.searchsorted(segs, s1))
            for m in range(first, last):
                got[b, segs[m]] = got[b, segs[m]] + wide[b, cols[m]]
            added += last - first
        assert added == int(nreal[b])
    return got


@pytest.mark.parametrize("shape", [(1, 64, 96, 0.3), (4, 130, 250, 0.05),
                                   (2, 256, 129, 0.1)], ids=str)
@pytest.mark.parametrize("side", ["row", "col"])
def test_lane_gather_ownership_gives_the_plain_product(shape, side):
    """The lane kernels' split of the segments and the bucket columns over
    a lane's blocks, in torch, at 4, 8 and 16 blocks: the plain product,
    every segment stored once, each real bucket column added once, the
    padded ones never."""
    s = testing.skewed_operator(*shape, True)
    *parts, v_len, plain = _side(s, side)
    v = torch.as_tensor(
        np.random.default_rng(4).normal(size=(shape[0], v_len)),
        dtype=torch.float32)
    for blocks in (4, 8, 16):
        got = _lane_blocks_product(*parts, v, blocks)
        torch.testing.assert_close(got, plain(s, v), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("side", ["row", "col"])
def test_lane_bucket_columns_that_share_a_segment_all_add_onto_it(side):
    """Three real bucket columns sent onto one segment sort side by side in
    column order, all count as real, and the blocks' split adds each of
    them once: the plain version's ``index_add_`` product, at 1, 4 and 16
    blocks a lane."""
    s = testing.shared_segment_operator()
    idx, val, widx, wval, wids, v_len, plain = _side(s, side)
    wsort, nreal = klane.wide_order(wids, wval, idx.shape[-1])
    assert int(nreal[0]) == wids.shape[-1]
    segs = wids[0, wsort[0].long()]
    run = torch.nonzero(segs == wids[0, 0]).flatten()
    assert run.tolist() == list(range(int(run[0]), int(run[0]) + 3))
    assert wsort[0, run].tolist() == [0, 1, 2]
    v = torch.as_tensor(np.random.default_rng(5).normal(size=(1, v_len)),
                        dtype=torch.float32)
    for blocks in (1, 4, 16):
        got = _lane_blocks_product(idx, val, widx, wval, wids, v, blocks)
        torch.testing.assert_close(got, plain(s, v), rtol=1e-5, atol=1e-5)
