"""The hand-written CUDA kernels of the port, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device; the
file imports no JAX, so it also runs where only the port is installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version (``kernels/ref.py``)
on the same CUDA inputs.  The element-wise tails are bit-equal (the
kernels round every operation to nearest and contract nothing into an
FMA, as the plain version's separate elementwise ops do); the
gather-reduce and dense products sum in another order, so they are held at
the reference's product tolerance of 1e-4 (``tests/test_kernels.py``), and
at its 2e-2 for bf16 coefficients.  The language-model serving path (no
hand kernel: plain torch ops) is held on the card against the same port
on the CPU: the 10 reduced architectures in f32 with TF32 off, the
serving driver and the two deprecated doors.  So is the training path:
each reduced architecture's train step (loss, grad_norm, parameters, m
and v within 1e-4), remat on against off (gradients within 1e-6 of each
leaf's largest), the checkpointer's round trip of card tensors and the
prefetcher's staged batches."""

import functools

import numpy as np
import pytest
import torch

from repro_torch import testing
from repro_torch.core import pdhg, pop
from repro_torch.core.config import ExecConfig, SolveConfig
from repro_torch.core import backends
from repro_torch.kernels import (fused_pdhg_step, ops, pdhg_matvec,
                                 structured_full_pdhg_step,
                                 structured_pdhg_step)
from repro_torch.problems.cluster_scheduling import (GavelProblem,
                                                     make_cluster_workload)
from repro_torch.problems.traffic_engineering import TrafficProblem
from repro_torch.service import PopService

PRODUCT_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only "
                    "on the GPU")
    return torch.device("cuda")


def _gavel():
    prob = GavelProblem(make_cluster_workload(40, num_workers=(6, 6, 6),
                                              seed=3))
    return pop.build(prob, pop.plan(prob, 4, strategy="stratified"),
                     "cpu").structured


CASES = {
    "skewed_dense(3,45,67)":
        lambda: testing.skewed_operator(3, 45, 67, 0.25, False),
    "skewed_sparse(4,130,250)":
        lambda: testing.skewed_operator(4, 130, 250, 0.05, True),
    "skewed_sparse(2,256,129)":
        lambda: testing.skewed_operator(2, 256, 129, 0.1, True),
    "gavel40x4": _gavel,
}


def _steps(s, o, backend):
    xn, kx = ops.structured_forward_step(s, o["x"], o["c"], o["l"], o["u"],
                                         o["tau"], o["kty"], backend=backend)
    yn, kty = ops.structured_backward_step(s, o["y"], o["q"], o["sigma"],
                                           o["mask"], o["kxn"], o["kxp"],
                                           backend=backend)
    return [v.cpu().numpy() for v in (xn, kx, yn, kty)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_kernels_match_plain_versions(case, cuda_device):
    s = pdhg.to_device(CASES[case](), cuda_device)
    o = testing.step_tensors(s, cuda_device, seed=9)
    before = dict(structured_pdhg_step.LAUNCHES)
    got = _steps(s, o, "kernel")
    torch.cuda.synchronize()
    want = _steps(s, o, "ref")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[1], want[1], **PRODUCT_TOL)
    np.testing.assert_allclose(got[3], want[3], **PRODUCT_TOL)
    for name in before:
        assert structured_pdhg_step.LAUNCHES[name] == before[name] + 1


@pytest.mark.cuda
def test_cuda_auto_dispatch_launches_kernel(cuda_device):
    s = pdhg.to_device(_gavel(), cuda_device)
    o = testing.step_tensors(s, cuda_device, seed=1)
    before = dict(structured_pdhg_step.LAUNCHES)
    _steps(s, o, None)
    for name in before:
        assert structured_pdhg_step.LAUNCHES[name] == before[name] + 1


@pytest.mark.cuda
def test_cuda_wrapper_rejects_bad_operands(cuda_device):
    s = pdhg.to_device(_gavel(), cuda_device)
    o = testing.step_tensors(s, cuda_device, seed=1)
    with pytest.raises(ValueError, match="shapes"):
        ops.structured_forward_step(s, o["x"][:, :-1], o["c"], o["l"],
                                    o["u"], o["tau"], o["kty"])
    with pytest.raises(ValueError, match="contiguous CUDA"):
        ops.structured_forward_step(s, o["x"].double(), o["c"], o["l"],
                                    o["u"], o["tau"], o["kty"],
                                    backend="kernel")


@pytest.mark.cuda
def test_cuda_session_matches_cpu_session(cuda_device):
    """The same three-step session on the card (kernels) and on the CPU
    (plain versions): the same plan-cache verdicts and, at convergence,
    the same quality within 1e-3."""
    cfg = SolveConfig(k=4, strategy="stratified", min_per_sub=8)
    gpu = PopService(device=cuda_device).session("t", domain="gavel",
                                                 solve=cfg)
    cpu = PopService(device="cpu").session("t", domain="gavel", solve=cfg)
    before = structured_pdhg_step.LAUNCHES["structured_backward_step"]
    for inst in testing.session_instances(64, (16, 16, 16), churn=0.2):
        a, b = gpu.step(inst), cpu.step(inst)
        assert a.engine == b.engine == "fused_structured"
        assert a.plan_cache == b.plan_cache
        assert np.isfinite(a.alloc).all() and a.alloc.shape == b.alloc.shape
        assert abs(a.metrics["mean_norm_throughput"]
                   - b.metrics["mean_norm_throughput"]) < 1e-3
    assert structured_pdhg_step.LAUNCHES["structured_backward_step"] > before


# --------------------------------------------------------------------------
# the full-problem (single-lane) kernels
# --------------------------------------------------------------------------

def _one_lane(s):
    return pdhg.map_arrays(lambda a: a[None], s)


@functools.lru_cache(maxsize=None)
def _kdl_arrays(n_demands):
    """A traffic instance on the KDL-like topology (paths take seconds)."""
    return testing.traffic_arrays(n_demands)


def _kdl_problem(n_demands, coef_dtype="float32"):
    return TrafficProblem(*_kdl_arrays(n_demands), coef_dtype=coef_dtype)


FULL_CASES = {
    # several ragged plan blocks, deeper than one row chunk, on both sides
    "ragged": testing.ragged_operator,
    # the conformance matrix's small traffic case (empty wide buckets)
    "traffic_small": lambda dt="float32": _one_lane(testing.traffic_problem(
        14, coef_dtype=dt, n_nodes=24, target_edges=48, n_paths=3,
        max_len=12, topo_seed=1, demand_seed=1,
        path_seed=1).build_full().structured),
    # the KDL-like topology: a ragged row bucket of edge rows
    "traffic_kdl_600": lambda dt="float32": _one_lane(
        _kdl_problem(600, dt).build_full().structured),
    # Gavel's full LP: a 3-column row bucket and a 1-column column bucket
    "gavel_full_256": lambda dt="float32": _one_lane(GavelProblem(
        make_cluster_workload(256, num_workers=(64, 64, 64), seed=0),
        coef_dtype=dt).build_full().structured),
}


def _full_steps(s, o, backend):
    rplan, cplan = pdhg._wide_block_plans(s)
    xn, kx = ops.structured_full_forward_step(
        s, o["x"], o["c"], o["l"], o["u"], o["tau"], o["kty"], plan=rplan,
        backend=backend)
    yn, kty = ops.structured_full_backward_step(
        s, o["y"], o["q"], o["sigma"], o["mask"], o["kxn"], o["kxp"],
        plan=cplan, backend=backend)
    return [v.cpu().numpy() for v in (xn, kx, yn, kty)]


@pytest.mark.cuda
@pytest.mark.parametrize("coef_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("case", sorted(FULL_CASES))
def test_cuda_full_kernels_match_plain_versions(case, coef_dtype,
                                                cuda_device):
    """Both full kernels against their plain versions on the same
    (quantized) operator: tails bit-equal, products within 1e-4."""
    s = pdhg.to_device(FULL_CASES[case](coef_dtype), cuda_device)
    assert s.coef_dtype == coef_dtype
    o = testing.step_tensors(s, cuda_device, seed=9)
    before = dict(structured_full_pdhg_step.LAUNCHES)
    got = _full_steps(s, o, "kernel")
    torch.cuda.synchronize()
    want = _full_steps(s, o, "ref")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[1], want[1], **PRODUCT_TOL)
    np.testing.assert_allclose(got[3], want[3], **PRODUCT_TOL)
    for name in before:
        assert structured_full_pdhg_step.LAUNCHES[name] == before[name] + 1


@pytest.mark.cuda
def test_cuda_full_kernels_are_deterministic(cuda_device):
    s = pdhg.to_device(testing.ragged_operator(), cuda_device)
    o = testing.step_tensors(s, cuda_device, seed=3)
    a, b = _full_steps(s, o, "kernel"), _full_steps(s, o, "kernel")
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)


@pytest.mark.cuda
def test_cuda_full_wrapper_rejects_bad_operands(cuda_device):
    s = pdhg.to_device(testing.ragged_operator(), cuda_device)
    o = testing.step_tensors(s, cuda_device, seed=1)
    rplan, _ = pdhg._wide_block_plans(s)
    args = (o["x"], o["c"], o["l"], o["u"], o["tau"], o["kty"])
    bad_fold = s._replace(row_fold=s.row_fold.clone())
    bad_fold.row_fold[0, 0] = s.wrow_idx.shape[-1] + 1
    with pytest.raises(ValueError, match="fold map"):
        ops.structured_full_forward_step(bad_fold, *args, plan=rplan)
    with pytest.raises(ValueError, match="plan"):
        ops.structured_full_forward_step(s, *args, plan=rplan[1:])
    with pytest.raises(ValueError, match="one lane"):
        ops.structured_full_forward_step(s, o["x"][:, :-1], *args[1:],
                                         plan=rplan)
    with pytest.raises(ValueError, match="contiguous CUDA"):
        ops.structured_full_forward_step(s, o["x"].double(), *args[1:],
                                         plan=rplan, backend="kernel")


@pytest.mark.cuda
def test_cuda_full_solve_runs_the_kernels(cuda_device, monkeypatch):
    """``solve_full_ex`` on the card resolves ``fused_structured_full``
    (threshold lowered for the small instance), launches both kernels once
    per iteration, agrees with the plain engine on the card at a fixed
    budget, and int8 storage gives the f32 trajectory (TE coefficients are
    all 1.0)."""
    monkeypatch.setattr(pdhg, "FULL_ENGINE_MIN_WIDE_ELEMS", 1)
    fixed = ExecConfig(solver_kw=dict(max_iters=200, tol_primal=0.0,
                                      tol_gap=0.0))
    runs = {}
    for dt in ("float32", "int8"):
        prob = _kdl_problem(600, dt)
        before = dict(structured_full_pdhg_step.LAUNCHES)
        fr = pop.solve_full_ex(prob, exec_cfg=fixed, device=cuda_device)
        assert fr.engine == "fused_structured_full"
        for name in before:
            assert (structured_full_pdhg_step.LAUNCHES[name] - before[name]
                    == int(fr.res.iterations))
        runs[dt] = fr
    np.testing.assert_array_equal(runs["int8"].res.x, runs["float32"].res.x)
    prob = _kdl_problem(600)
    op = pdhg.to_device(pdhg.map_arrays(lambda a: a[None], prob.build_full()),
                        cuda_device)
    eng = pdhg.resolve_engine("fused_structured_full", op)
    plain = pdhg.fused_structured_full_engine("ref", *(
        pdhg._wide_block_plans(op.structured)))
    got = pdhg.solve_stacked(op, engine=eng, **fixed.solver_dict())
    want = pdhg.solve_stacked(op, engine=plain, **fixed.solver_dict())
    np.testing.assert_allclose(got.x, want.x, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.y, want.y, rtol=1e-4, atol=1e-4)


def _wide_operator(n_wide, width=40, n_narrow=20_000, n_cols=30_000, seed=5):
    """Single-lane operator whose row bucket holds ``n_wide`` columns
    ``width`` deep (the other rows hold one entry each)."""
    rng = np.random.default_rng(seed)
    rows = np.concatenate([np.repeat(np.arange(n_wide), width),
                           n_wide + np.arange(n_narrow)])
    cols = np.concatenate([
        np.concatenate([rng.choice(n_cols, width, replace=False)
                        for _ in range(n_wide)]),
        rng.integers(0, n_cols, n_narrow)])
    s = pdhg.structured_from_coo(rows, cols, rng.normal(size=rows.size),
                                 n_wide + n_narrow, n_cols)
    assert tuple(s.wrow_idx.shape) == (width, n_wide)
    return _one_lane(s)


@pytest.mark.cuda
def test_cuda_full_kernels_at_the_plan_block_limit(cuda_device):
    """A row plan of exactly ``MAX_PLAN_BLOCKS`` blocks (one bucket column
    each, the last one the rest) fits the kernels' shared memory and
    matches the plain version; one block more is refused before launch."""
    limit = structured_full_pdhg_step.MAX_PLAN_BLOCKS
    s = pdhg.to_device(_wide_operator(limit + 90), cuda_device)
    ww, d = s.wrow_idx.shape[1:]
    plan = tuple((c, c + 1, ww) for c in range(limit - 1)) + (
        (limit - 1, d, ww),)
    o = testing.step_tensors(s, cuda_device, seed=2)
    args = (s, o["x"], o["c"], o["l"], o["u"], o["tau"], o["kty"])
    got = ops.structured_full_forward_step(*args, plan=plan,
                                           backend="kernel")
    torch.cuda.synchronize()
    want = ops.structured_full_forward_step(*args, plan=plan, backend="ref")
    np.testing.assert_array_equal(got[0].cpu().numpy(), want[0].cpu().numpy())
    np.testing.assert_allclose(got[1].cpu().numpy(), want[1].cpu().numpy(),
                               **PRODUCT_TOL)
    over = plan[:-1] + ((limit - 1, limit, ww), (limit, d, ww))
    with pytest.raises(ValueError, match="at most"):
        ops.structured_full_forward_step(*args, plan=over, backend="kernel")


# --------------------------------------------------------------------------
# the redesigned kernels: structured_backward_step (one launch) and
# structured_full_forward_step (one cooperative launch)
# --------------------------------------------------------------------------

def _backward(s, o, backend):
    return ops.structured_backward_step(s, o["y"], o["q"], o["sigma"],
                                        o["mask"], o["kxn"], o["kxp"],
                                        backend=backend)


def _full_forward(s, o, plan, backend):
    return ops.structured_full_forward_step(
        s, o["x"], o["c"], o["l"], o["u"], o["tau"], o["kty"], plan=plan,
        backend=backend)


def _main_path_lanes():
    """The main path's k=8 stack at a quarter of its fleet."""
    prob = GavelProblem(make_cluster_workload(4096, num_workers=(1024,) * 3,
                                              seed=0))
    return pop.build(prob, pop.plan(prob, 8, strategy="stratified"),
                     "cpu").structured


LANE_CASES = dict(CASES, main_path_quarter=_main_path_lanes)


@pytest.mark.cuda
@pytest.mark.parametrize("instance", ["shared", "cluster"])
@pytest.mark.parametrize("cluster", [4, 8, 16])
@pytest.mark.parametrize("case", sorted(LANE_CASES))
def test_cuda_backward_kernel(case, cluster, instance, cuda_device,
                              monkeypatch):
    """Both instances of the backward kernel (the lane's tail in each
    block's shared memory; a cluster over the stored tail) at every block
    count: the tail bit-equal, the product within 1e-4, one CUDA launch
    per call, bit-for-bit the same over repeated calls."""
    monkeypatch.setattr(structured_pdhg_step, "CLUSTER", cluster)
    monkeypatch.setattr(structured_pdhg_step, "lane_local",
                        lambda p: instance == "shared")
    s = pdhg.to_device(LANE_CASES[case](), cuda_device)
    o = testing.step_tensors(s, cuda_device, seed=5)
    name = "structured_backward_step"
    before = structured_pdhg_step.CUDA_LAUNCHES[name]
    got = [v.cpu().numpy() for v in _backward(s, o, "kernel")]
    assert structured_pdhg_step.CUDA_LAUNCHES[name] == before + 1
    want = [v.cpu().numpy() for v in _backward(s, o, "ref")]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], **PRODUCT_TOL)
    for _ in range(3):
        again = [v.cpu().numpy() for v in _backward(s, o, "kernel")]
        for u, v in zip(got, again):
            np.testing.assert_array_equal(u, v)


@pytest.mark.cuda
def test_cuda_backward_lane_beyond_shared_memory(cuda_device):
    """A lane whose tail does not fit a block's shared memory takes the
    cluster instance (the shape rule says so) and is still right, in one
    launch, and deterministic: the cluster barrier orders the stored tail
    before its gathers."""
    rng = np.random.default_rng(11)
    M, N = 250_000, 3_000
    rows = np.concatenate([rng.integers(0, M, 600_000), np.arange(M)])
    cols = np.concatenate([rng.integers(0, N, 600_000),
                           np.full(M, 7)])          # a column in every row
    s = pdhg.structured_from_coo(rows, cols, rng.normal(size=rows.size),
                                 M, N)
    s = pdhg.to_device(pdhg.map_arrays(lambda a: a[None], s), cuda_device)
    assert s.wcol_idx.shape[-1] >= 1
    name = "structured_backward_step"
    pack = structured_pdhg_step.side_pack(
        name, (s.col_idx, s.col_val, s.wcol_idx, s.wcol_val, s.wcol_ids),
        M)
    assert not structured_pdhg_step.lane_local(pack)
    o = testing.step_tensors(s, cuda_device, seed=3)
    before = structured_pdhg_step.CUDA_LAUNCHES[name]
    got = [v.cpu().numpy() for v in _backward(s, o, "kernel")]
    assert structured_pdhg_step.CUDA_LAUNCHES[name] == before + 1
    want = [v.cpu().numpy() for v in _backward(s, o, "ref")]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], **PRODUCT_TOL)
    again = [v.cpu().numpy() for v in _backward(s, o, "kernel")]
    for u, v in zip(got, again):
        np.testing.assert_array_equal(u, v)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [8, 16])
def test_cuda_backward_lane_of_many_bucket_columns(cluster, cuda_device,
                                                   monkeypatch):
    """A lane of 12,500 wide bucket columns (each block reduces the columns
    of its own segments, many tiles of them): right, in one launch, and
    deterministic."""
    monkeypatch.setattr(structured_pdhg_step, "CLUSTER", cluster)
    rng = np.random.default_rng(11)
    n_wide, depth, n_narrow, M = 12_500, 40, 40_000, 30_000
    cols = np.concatenate([np.repeat(np.arange(n_wide), depth),
                           n_wide + np.arange(n_narrow)])
    rows = rng.integers(0, M, cols.size)
    s = pdhg.structured_from_coo(rows, cols, rng.normal(size=rows.size), M,
                                 n_wide + n_narrow)
    s = pdhg.to_device(pdhg.map_arrays(lambda a: a[None], s), cuda_device)
    assert s.wcol_idx.shape[-1] >= n_wide
    o = testing.step_tensors(s, cuda_device, seed=3)
    name = "structured_backward_step"
    before = structured_pdhg_step.CUDA_LAUNCHES[name]
    got = [v.cpu().numpy() for v in _backward(s, o, "kernel")]
    assert structured_pdhg_step.CUDA_LAUNCHES[name] == before + 1
    want = [v.cpu().numpy() for v in _backward(s, o, "ref")]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], **PRODUCT_TOL)
    again = [v.cpu().numpy() for v in _backward(s, o, "kernel")]
    for u, v in zip(got, again):
        np.testing.assert_array_equal(u, v)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", [1, 2])
@pytest.mark.parametrize("coef_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("case", sorted(FULL_CASES))
def test_cuda_full_forward_cooperative_kernel(case, coef_dtype, variant,
                                              cuda_device, monkeypatch):
    """The cooperative forward kernel, in one launch (variant 1) or after
    the tail launch (variant 2): the tail bit-equal, the product within
    1e-4, the launches it reports, bit-for-bit the same over repeated
    calls."""
    monkeypatch.setattr(structured_full_pdhg_step, "VARIANT", variant)
    s = pdhg.to_device(FULL_CASES[case](coef_dtype), cuda_device)
    o = testing.step_tensors(s, cuda_device, seed=4)
    rplan, _ = pdhg._wide_block_plans(s)
    name = "structured_full_forward_step"
    before = structured_full_pdhg_step.CUDA_LAUNCHES[name]
    got = [v.cpu().numpy() for v in _full_forward(s, o, rplan, "kernel")]
    assert structured_full_pdhg_step.CUDA_LAUNCHES[name] == before + variant
    want = [v.cpu().numpy() for v in _full_forward(s, o, rplan, "ref")]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], **PRODUCT_TOL)
    for _ in range(3):
        again = [v.cpu().numpy()
                 for v in _full_forward(s, o, rplan, "kernel")]
        for u, v in zip(got, again):
            np.testing.assert_array_equal(u, v)


@pytest.mark.cuda
def test_cuda_full_scratch_is_kept_per_stream(cuda_device):
    """The full wrappers keep one scratch of wide partial sums per pack and
    CUDA stream: two calls on one stream share it, a call on another
    stream gets its own, and every call is right."""
    s = pdhg.to_device(testing.ragged_operator(), cuda_device)
    o = testing.step_tensors(s, cuda_device, seed=6)
    rplan, _ = pdhg._wide_block_plans(s)
    want = [v.cpu().numpy() for v in _full_forward(s, o, rplan, "ref")]
    side = (s.row_idx, s.row_val, s.row_scale, s.wrow_idx, s.wrow_val,
            s.wrow_scale, s.row_fold)
    pack = structured_full_pdhg_step.side_pack(
        "t", side, s.col_idx.shape[-1], rplan)
    got = []
    for _ in range(2):
        got.append(_full_forward(s, o, rplan, "kernel"))
    assert len(pack.scratch) == 1
    other = torch.cuda.Stream()
    other.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(other):
        got.append(_full_forward(s, o, rplan, "kernel"))
    torch.cuda.synchronize()
    assert len(pack.scratch) == 2
    first, second = pack.scratch.values()
    assert first.data_ptr() != second.data_ptr()
    for xn, kx in got:
        np.testing.assert_array_equal(xn.cpu().numpy(), want[0])
        np.testing.assert_allclose(kx.cpu().numpy(), want[1], **PRODUCT_TOL)


@pytest.mark.cuda
def test_cuda_redesigned_wrappers_reject_bad_operands(cuda_device):
    """A non-contiguous, wrong-dtype or wrong-device operand raises before
    launch, in the per-call vectors and in the operator."""
    s = pdhg.to_device(_gavel(), cuda_device)
    o = testing.step_tensors(s, cuda_device, seed=1)
    k, m = o["y"].shape
    args = dict(o)
    strided = torch.empty((m, k), device=cuda_device).t()
    strided.copy_(o["y"])
    bad = {"contiguous CUDA": [("y", strided), ("y", o["y"].double()),
                               ("y", o["y"].cpu()),
                               ("mask", o["mask"].to(torch.uint8))]}
    for key, val in bad["contiguous CUDA"]:
        a = dict(args, **{key: val})
        match = "bool" if key == "mask" else "contiguous CUDA"
        with pytest.raises(ValueError, match=match):
            structured_pdhg_step.structured_backward_step(
                s, a["y"], a["q"], a["sigma"], a["mask"], a["kxn"],
                a["kxp"])
    with pytest.raises(ValueError, match="shapes"):
        ops.structured_backward_step(s, o["y"][:, :-1], o["q"], o["sigma"],
                                     o["mask"], o["kxn"], o["kxp"])
    wide = s.col_val.shape
    bad_op = s._replace(col_val=torch.empty(
        (wide[2], wide[1], wide[0]), device=cuda_device).permute(2, 1, 0))
    with pytest.raises(ValueError, match="contiguous"):
        _backward(bad_op, o, "kernel")
    bad_op = s._replace(col_val=s.col_val.double())
    with pytest.raises(ValueError, match="contiguous"):
        _backward(bad_op, o, "kernel")

    f = pdhg.to_device(testing.ragged_operator(), cuda_device)
    fo = testing.step_tensors(f, cuda_device, seed=1)
    rplan, _ = pdhg._wide_block_plans(f)
    n = fo["x"].shape[1]
    strided = torch.empty((1, 2 * n), device=cuda_device)[:, ::2]
    strided.copy_(fo["x"])
    for bad_x in (strided, fo["x"].double(), fo["x"].cpu()):
        with pytest.raises(ValueError, match="contiguous CUDA"):
            structured_full_pdhg_step.structured_full_forward_step(
                f, bad_x, fo["c"], fo["l"], fo["u"], fo["tau"], fo["kty"],
                rplan)
    bad_op = f._replace(row_idx=f.row_idx.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        _full_forward(bad_op, fo, rplan, "kernel")


# --------------------------------------------------------------------------
# the kernels redesigned next: structured_forward_step (one launch, the
# lanes: each block holds the lane's tail) and
# structured_full_backward_step (one cooperative launch that stops at each
# column group's stored width)
# --------------------------------------------------------------------------

def _forward(s, o, backend):
    return ops.structured_forward_step(s, o["x"], o["c"], o["l"], o["u"],
                                       o["tau"], o["kty"], backend=backend)


def _full_backward(s, o, plan, backend):
    return ops.structured_full_backward_step(
        s, o["y"], o["q"], o["sigma"], o["mask"], o["kxn"], o["kxp"],
        plan=plan, backend=backend)


def _one_launch_matches_plain(mod, name, step, repeats=3):
    """``step(backend)`` on the kernel: one CUDA launch, the tail bit-equal
    to the plain version's, the product within 1e-4, and bit-for-bit the
    same over ``repeats`` more calls."""
    before = mod.CUDA_LAUNCHES[name]
    got = [v.cpu().numpy() for v in step("kernel")]
    assert mod.CUDA_LAUNCHES[name] == before + 1
    want = [v.cpu().numpy() for v in step("ref")]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], **PRODUCT_TOL)
    for _ in range(repeats):
        again = [v.cpu().numpy() for v in step("kernel")]
        for u, v in zip(got, again):
            np.testing.assert_array_equal(u, v)


@pytest.mark.cuda
@pytest.mark.parametrize("instance", ["shared", "cluster"])
@pytest.mark.parametrize("cluster", [4, 8, 16])
@pytest.mark.parametrize("case", sorted(LANE_CASES))
def test_cuda_forward_kernel(case, cluster, instance, cuda_device,
                             monkeypatch):
    """Both instances of the forward kernel (the lane's tail in each
    block's shared memory; a cluster over the stored tail) at every block
    count: the tail bit-equal, the product within 1e-4, one CUDA launch
    per call, bit-for-bit the same over repeated calls (no atomics)."""
    monkeypatch.setattr(structured_pdhg_step, "CLUSTER", cluster)
    monkeypatch.setattr(structured_pdhg_step, "lane_local",
                        lambda p: instance == "shared")
    s = pdhg.to_device(LANE_CASES[case](), cuda_device)
    o = testing.step_tensors(s, cuda_device, seed=5)
    _one_launch_matches_plain(structured_pdhg_step,
                              "structured_forward_step",
                              lambda be: _forward(s, o, be))


@pytest.mark.cuda
def test_cuda_forward_lane_beyond_shared_memory(cuda_device):
    """A lane of 250,000 columns (a tail of 1 MB, beyond a block's shared
    memory) takes the cluster instance: right, in one launch, and
    deterministic; a row holding every column goes to the wide bucket."""
    rng = np.random.default_rng(12)
    M, N = 3_000, 250_000
    cols = np.concatenate([rng.integers(0, N, 600_000), np.arange(N)])
    rows = np.concatenate([rng.integers(0, M, 600_000),
                           np.full(N, 7)])          # a row over every column
    s = pdhg.structured_from_coo(rows, cols, rng.normal(size=rows.size),
                                 M, N)
    s = pdhg.to_device(pdhg.map_arrays(lambda a: a[None], s), cuda_device)
    assert s.wrow_idx.shape[-2] >= N
    name = "structured_forward_step"
    pack = structured_pdhg_step.side_pack(
        name, (s.row_idx, s.row_val, s.wrow_idx, s.wrow_val, s.wrow_ids), N)
    assert pack.v_len > 57_600 and not structured_pdhg_step.lane_local(pack)
    o = testing.step_tensors(s, cuda_device, seed=3)
    _one_launch_matches_plain(structured_pdhg_step, name,
                              lambda be: _forward(s, o, be), repeats=1)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [8, 16])
def test_cuda_forward_lane_of_many_bucket_rows(cluster, cuda_device,
                                               monkeypatch):
    """A lane of 12,500 wide bucket rows (each block reduces the rows it
    owns, whole, many tiles of them): each row's sum added once, right, in
    one launch, and deterministic."""
    monkeypatch.setattr(structured_pdhg_step, "CLUSTER", cluster)
    rng = np.random.default_rng(13)
    n_wide, depth, n_narrow, N = 12_500, 40, 40_000, 30_000
    rows = np.concatenate([np.repeat(np.arange(n_wide), depth),
                           n_wide + np.arange(n_narrow)])
    cols = rng.integers(0, N, rows.size)
    s = pdhg.structured_from_coo(rows, cols, rng.normal(size=rows.size),
                                 n_wide + n_narrow, N)
    s = pdhg.to_device(pdhg.map_arrays(lambda a: a[None], s), cuda_device)
    assert s.wrow_idx.shape[-1] >= n_wide
    o = testing.step_tensors(s, cuda_device, seed=3)
    _one_launch_matches_plain(structured_pdhg_step,
                              "structured_forward_step",
                              lambda be: _forward(s, o, be), repeats=1)


@pytest.mark.cuda
@pytest.mark.parametrize("instance", ["shared", "cluster"])
@pytest.mark.parametrize("name", ["structured_forward_step",
                                  "structured_backward_step"])
def test_cuda_lane_kernels_add_bucket_columns_that_share_a_segment(
        name, instance, cuda_device, monkeypatch):
    """Three real wide bucket columns of one segment all add onto it (the
    plain version's ``index_add_``), in one launch, deterministically, in
    either instance, at a block count that puts several columns in one
    tile."""
    monkeypatch.setattr(structured_pdhg_step, "CLUSTER", 4)
    monkeypatch.setattr(structured_pdhg_step, "lane_local",
                        lambda p: instance == "shared")
    s = pdhg.to_device(testing.shared_segment_operator(), cuda_device)
    o = testing.step_tensors(s, cuda_device, seed=6)
    step = _forward if name == "structured_forward_step" else _backward
    _one_launch_matches_plain(structured_pdhg_step, name,
                              lambda be: step(s, o, be))


@pytest.mark.cuda
@pytest.mark.parametrize("coef_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("case", sorted(FULL_CASES))
def test_cuda_full_backward_cooperative_kernel(case, coef_dtype,
                                               cuda_device):
    """The cooperative backward kernel, its narrow reduce stopping at each
    column group's stored width: the tail bit-equal, the product within
    1e-4, one CUDA launch, bit-for-bit the same over repeated calls."""
    s = pdhg.to_device(FULL_CASES[case](coef_dtype), cuda_device)
    o = testing.step_tensors(s, cuda_device, seed=4)
    _, cplan = pdhg._wide_block_plans(s)
    _one_launch_matches_plain(
        structured_full_pdhg_step, "structured_full_backward_step",
        lambda be: _full_backward(s, o, cplan, be))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["traffic_small", "traffic_kdl_600"])
def test_cuda_full_backward_empty_bucket_launches_no_tile(case,
                                                          cuda_device):
    """A column bucket no column folds onto (traffic engineering's) is
    laid out with no tile: one launch without the wide pass or the fold
    phase, the plain version's result."""
    s = pdhg.to_device(FULL_CASES[case](), cuda_device)
    o = testing.step_tensors(s, cuda_device, seed=8)
    _, cplan = pdhg._wide_block_plans(s)
    side = (s.col_idx, s.col_val, s.col_scale, s.wcol_idx, s.wcol_val,
            s.wcol_scale, s.col_fold)
    pack = structured_full_pdhg_step.side_pack(
        "structured_full_backward_step", side, s.row_idx.shape[-1], cplan)
    assert not pack.has_wide and pack.struct.n_tiles == 0
    _one_launch_matches_plain(
        structured_full_pdhg_step, "structured_full_backward_step",
        lambda be: _full_backward(s, o, cplan, be), repeats=1)


@pytest.mark.cuda
def test_cuda_full_backward_skips_stored_zeros_and_padding(cuda_device):
    """Columns whose stored entries end in explicit zero coefficients and
    groups of very different widths: the width table stops each group at
    its last nonzero, and the result is the plain version's."""
    rng = np.random.default_rng(21)
    M, N = 5_000, 4_099
    counts = rng.integers(1, 60, N)
    cols = np.repeat(np.arange(N), counts)
    rows = rng.integers(0, M, cols.size)
    vals = rng.normal(size=cols.size)
    vals[rng.random(cols.size) < 0.2] = 0.0       # stored zeros, kept
    s32 = _one_lane(pdhg.structured_from_coo(rows, cols, vals, M, N))
    for dt in ("float32", "bfloat16", "int8"):
        s = pdhg.to_device(pdhg.quantize_structured(s32, dt), cuda_device)
        o = testing.step_tensors(s, cuda_device, seed=2)
        _, cplan = pdhg._wide_block_plans(s)
        _one_launch_matches_plain(
            structured_full_pdhg_step, "structured_full_backward_step",
            lambda be: _full_backward(s, o, cplan, be), repeats=1)


@pytest.mark.cuda
def test_cuda_next_redesigned_wrappers_reject_bad_operands(cuda_device):
    """The lane forward and full backward wrappers raise before launch on
    a non-contiguous, wrong-dtype, wrong-device or wrong-shape operand."""
    s = pdhg.to_device(_gavel(), cuda_device)
    o = testing.step_tensors(s, cuda_device, seed=1)
    k, n = o["x"].shape
    strided = torch.empty((n, k), device=cuda_device).t()
    strided.copy_(o["x"])
    for bad_x in (strided, o["x"].double(), o["x"].cpu()):
        with pytest.raises(ValueError, match="contiguous CUDA"):
            structured_pdhg_step.structured_forward_step(
                s, bad_x, o["c"], o["l"], o["u"], o["tau"], o["kty"])
    with pytest.raises(ValueError, match="shapes"):
        _forward(s, dict(o, x=o["x"][:, :-1]), None)
    bad_op = s._replace(row_val=s.row_val.double())
    with pytest.raises(ValueError, match="contiguous"):
        _forward(bad_op, o, "kernel")

    f = pdhg.to_device(testing.ragged_operator(), cuda_device)
    fo = testing.step_tensors(f, cuda_device, seed=1)
    _, cplan = pdhg._wide_block_plans(f)
    m = fo["y"].shape[1]
    strided = torch.empty((1, 2 * m), device=cuda_device)[:, ::2]
    strided.copy_(fo["y"])
    for bad_y in (strided, fo["y"].double(), fo["y"].cpu()):
        with pytest.raises(ValueError, match="contiguous CUDA"):
            structured_full_pdhg_step.structured_full_backward_step(
                f, bad_y, fo["q"], fo["sigma"], fo["mask"], fo["kxn"],
                fo["kxp"], cplan)
    with pytest.raises(ValueError, match="bool"):
        _full_backward(f, dict(fo, mask=fo["mask"].to(torch.uint8)), cplan,
                       "kernel")
    with pytest.raises(ValueError, match="one lane"):
        _full_backward(f, dict(fo, y=fo["y"][:, :-1]), cplan, "kernel")
    with pytest.raises(ValueError, match="plan"):
        _full_backward(f, fo, cplan[1:], "kernel")
    bad_fold = f._replace(col_fold=f.col_fold.clone())
    bad_fold.col_fold[0, 0] = f.wcol_idx.shape[-1] + 1
    with pytest.raises(ValueError, match="fold map"):
        _full_backward(bad_fold, fo, cplan, "kernel")


# --------------------------------------------------------------------------
# the dense kernels (bmatvec, bmatvec_t, fused_forward_step,
# fused_backward_step)
# --------------------------------------------------------------------------

# the reference's kernel-test shapes (tests/test_kernels.py) and the dense
# engine sweep's [32, 256, 256]
DENSE_SHAPES = [(1, 128, 128), (3, 300, 180), (4, 64, 512), (2, 512, 64),
                (8, 129, 257), (32, 256, 256), (2, 3, 1), (1, 1, 5)]
DENSE_LAUNCHES = (pdhg_matvec.LAUNCHES, fused_pdhg_step.LAUNCHES)


def _dense_operands(shape, dtype, device, seed=0, offset=0):
    """A [k, M, N] in ``dtype`` (starting ``offset`` elements into its
    storage, so its rows sit at other 16-byte alignments) and the
    half-step vectors, on ``device``."""
    k, M, N = shape
    rng = np.random.default_rng(seed)
    a = torch.tensor(rng.normal(size=k * M * N + offset), dtype=torch.float32)
    A = a.to(getattr(torch, dtype)).to(device)[offset:].view(k, M, N)
    o = {key: torch.as_tensor(v, device=device)
         for key, v in testing.step_operands(k, M, N, seed + 1).items()}
    return A, o


def _dense_steps(A, o, backend):
    xn, kx = ops.fused_forward_step(A, o["x"], o["c"], o["l"], o["u"],
                                    o["tau"], o["kty"], backend=backend)
    yn, kty = ops.fused_backward_step(A, o["y"], o["q"], o["sigma"],
                                      o["mask"], o["kxn"], o["kxp"],
                                      backend=backend)
    y = ops.bmatvec(A, o["x"], backend=backend)
    x = ops.bmatvec_t(A, o["y"], backend=backend)
    return [v.cpu().numpy() for v in (xn, kx, yn, kty, y, x)]


def _dense_counts():
    return {k: v for launches in DENSE_LAUNCHES for k, v in launches.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", DENSE_SHAPES, ids=str)
def test_cuda_dense_kernels_match_plain_versions(shape, dtype, offset,
                                                 cuda_device):
    """The four dense kernels against their plain versions on the same
    inputs: tails bit-equal, products within 1e-4 (bf16 A: 2e-2); each
    wrapper counts its one call."""
    A, o = _dense_operands(shape, dtype, cuda_device, offset=offset)
    before = _dense_counts()
    got = _dense_steps(A, o, "kernel")
    torch.cuda.synchronize()
    want = _dense_steps(A, o, "ref")
    tol = PRODUCT_TOL if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    for i in (1, 3, 4, 5):
        np.testing.assert_allclose(got[i], want[i], **tol)
    after = _dense_counts()
    assert all(after[name] == before[name] + 1 for name in before), after


@pytest.mark.cuda
def test_cuda_dense_kernels_are_deterministic(cuda_device):
    """The fused column pass adds its M chunks in a fixed order, and
    bmatvec_t its blocks' partials in block order (no atomics)."""
    A, o = _dense_operands((3, 2_000, 700), "float32", cuda_device, seed=4)
    assert pdhg_matvec.col_chunks(3, 2_000, 700)[1] > 1
    assert pdhg_matvec.stream_plan(3, 2_000, 700, transposed=True).blocks > 1
    a, b = _dense_steps(A, o, "kernel"), _dense_steps(A, o, "kernel")
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)


# the matvec stream's own cases: a row longer than a stage (several column
# slabs, and bmatvec_t's blocks of 32 rows), lanes split over many blocks,
# k = 1, M = 1, more lanes than the grid's blocks, bmatvec_t's f32 blocks
# taking interleaved chunks of rows
STREAM_SHAPES = [(1, 64, 80_000), (2, 1_000, 300), (1, 500, 700),
                 (4, 1, 1_000), (300, 5, 7), (8, 4_099, 97),
                 (2, 3_000, 4_000)]


def _matvecs(A, o, backend):
    return (ops.bmatvec(A, o["x"], backend=backend),
            ops.bmatvec_t(A, o["y"], backend=backend))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", STREAM_SHAPES, ids=str)
def test_cuda_matvec_stream_cases(shape, dtype, offset, cuda_device):
    """Both matvecs against their plain versions where the stream's plan
    takes its other branches, each in one CUDA launch a call."""
    k, m, n = shape
    A, o = _dense_operands(shape, dtype, cuda_device, offset=offset)
    before = dict(pdhg_matvec.CUDA_LAUNCHES)
    got = [v.cpu().numpy() for v in _matvecs(A, o, "kernel")]
    torch.cuda.synchronize()
    want = [v.cpu().numpy() for v in _matvecs(A, o, "ref")]
    tol = PRODUCT_TOL if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **tol)
    assert {name: n_ - before[name] for name, n_ in
            pdhg_matvec.CUDA_LAUNCHES.items()} == {"bmatvec": 1,
                                                   "bmatvec_t": 1}


def _device_operands(shape, dtype, device, seed):
    """A [k, M, N] in ``dtype``, x [k, N] and y [k, M], drawn on the card
    (the large shapes would take seconds to draw on the host); A is
    scaled by 1/sqrt(N), so that the products stay near 1 and the f32
    rounding of a sum of 30,000 terms (about 1e-3 at unit entries) stays
    below the 1e-4 product tolerance."""
    k, m, n = shape
    g = torch.Generator(device=device).manual_seed(seed)
    A = (torch.randn(shape, generator=g, device=device) / n ** 0.5).to(
        getattr(torch, dtype))
    return A, {"x": torch.randn((k, n), generator=g, device=device),
               "y": torch.randn((k, m), generator=g, device=device)}


@pytest.mark.cuda
def test_cuda_matvecs_past_4gb(cuda_device):
    """A [2, 20,000, 30,000] f32 (4.8 GB): byte offsets into A pass 2^32
    in the second lane, and both matvecs still agree with the plain
    versions."""
    A, o = _device_operands((2, 20_000, 30_000), "float32", cuda_device, 5)
    assert A.numel() * 4 > 2 ** 32
    got = _matvecs(A, o, "kernel")
    torch.cuda.synchronize()
    for g, w in zip(got, _matvecs(A, o, "ref")):
        torch.testing.assert_close(g, w, **PRODUCT_TOL)
    del A
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(8, 4_099, 6_145), (1, 64, 80_000),
                                   (3, 2_000, 700)], ids=str)
def test_cuda_matvecs_repeat_bit_equal(shape, dtype, cuda_device):
    """Three calls of each matvec give the same bits where bmatvec_t's last
    blocks add the partials (the ticket reduction, in one level and in
    two), and every ticket is 0 again after the calls."""
    k, m, n = shape
    assert pdhg_matvec.stream_plan(k, m, n, transposed=True).blocks > 1
    A, o = _device_operands(shape, dtype, cuda_device, seed=8)
    runs = [[v.cpu().numpy() for v in _matvecs(A, o, "kernel")]
            for _ in range(3)]
    for run in runs[1:]:
        for got, first in zip(run, runs[0]):
            np.testing.assert_array_equal(got, first)
    stream = torch.cuda.current_stream().cuda_stream
    count = k * (1 + pdhg_matvec.stream_plan(k, m, n, True).n_groups)
    assert not pdhg_matvec.tickets(cuda_device, stream, count)[:count].any()


@pytest.mark.cuda
def test_cuda_matvecs_make_one_launch_a_call(cuda_device):
    """Each call of either matvec is one CUDA launch, with its block
    partials summed inside it."""
    A, o = _dense_operands((8, 300, 500), "float32", cuda_device)
    assert pdhg_matvec.stream_plan(8, 300, 500, transposed=True).blocks > 1
    before = dict(pdhg_matvec.CUDA_LAUNCHES), dict(pdhg_matvec.LAUNCHES)
    for _ in range(5):
        _matvecs(A, o, "kernel")
    torch.cuda.synchronize()
    for counts, start in zip((pdhg_matvec.CUDA_LAUNCHES, pdhg_matvec.LAUNCHES),
                             before):
        assert {name: n - start[name] for name, n in counts.items()} == {
            "bmatvec": 5, "bmatvec_t": 5}


@pytest.mark.cuda
def test_cuda_matvec_tickets_are_kept_per_stream(cuda_device):
    """bmatvec_t's tickets belong to one stream: calls on two streams at
    once get their own and both are right."""
    A, o = _dense_operands((4, 2_000, 900), "float32", cuda_device, seed=3)
    want = ops.bmatvec_t(A, o["y"], backend="ref").cpu().numpy()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    got = [ops.bmatvec_t(A, o["y"], backend="kernel")]
    with torch.cuda.stream(side):
        got.append(ops.bmatvec_t(A, o["y"], backend="kernel"))
    torch.cuda.synchronize()
    main = torch.cuda.current_stream().cuda_stream
    assert (pdhg_matvec.tickets(cuda_device, main, 4).data_ptr()
            != pdhg_matvec.tickets(cuda_device, side.cuda_stream, 4)
            .data_ptr())
    for x in got:
        np.testing.assert_allclose(x.cpu().numpy(), want, **PRODUCT_TOL)
    np.testing.assert_array_equal(got[0].cpu().numpy(), got[1].cpu().numpy())


@pytest.mark.cuda
def test_cuda_dense_auto_dispatch_and_bad_operands(cuda_device):
    A, o = _dense_operands((2, 64, 96), "float32", cuda_device)
    before = _dense_counts()
    _dense_steps(A, o, None)
    after = _dense_counts()
    assert all(after[name] == before[name] + 1 for name in before)
    with pytest.raises(ValueError, match="shape"):
        ops.bmatvec(A, o["x"][:, :-1])
    with pytest.raises(ValueError, match="contiguous CUDA"):
        ops.bmatvec_t(A.transpose(1, 2), o["x"])
    with pytest.raises(ValueError, match="contiguous CUDA"):
        ops.fused_forward_step(A.double(), o["x"], o["c"], o["l"], o["u"],
                               o["tau"], o["kty"])
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.bmatvec(A.cpu(), o["x"].cpu(), backend="kernel")


@pytest.mark.cuda
def test_cuda_dense_stack_resolves_fused(cuda_device):
    """``solve_map(engine="auto")`` on a dense stack on the card resolves
    the ``fused`` engine, launches each half-step kernel once per iteration
    and each product kernel 33 times (31 in the power iteration, the
    starting products, the final KKT report), and agrees with the plain
    engine on the card at a fixed budget."""
    ops_ = testing.dense_stack(testing.random_dense_lps(4, 150, 90, seed=0),
                               cuda_device)
    kw = dict(max_iters=200, tol_primal=0.0, tol_gap=0.0)
    backend, eng, _ = backends.resolve_exec(ops_, pdhg.dense_K_mv,
                                            pdhg.dense_KT_mv)
    assert eng is pdhg.fused_dense_engine() and backend == "vmap"
    before = _dense_counts()
    got = backends.solve_map(ops_, pdhg.dense_K_mv, pdhg.dense_KT_mv, kw)
    counts = {k: v - before[k] for k, v in _dense_counts().items()}
    assert counts == {"bmatvec": 33, "bmatvec_t": 33,
                      "fused_forward_step": 200,
                      "fused_backward_step": 200}, counts
    want = pdhg.solve_stacked(ops_, engine=pdhg.fused_dense_engine("ref"),
                              **kw)
    np.testing.assert_allclose(got.x, want.x, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.y, want.y, rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------------
# load balancing (paper §3.3) on the card
# --------------------------------------------------------------------------

BALANCE_FIXED = dict(max_iters=400, check_every=40, tol_primal=0.0,
                     tol_gap=0.0)


@pytest.mark.cuda
def test_cuda_load_balance_session_matches_cpu_session(cuda_device):
    """Cold, drift, then 20% churn at 128 shards on 16 servers
    (``testing.balance_session``) through ``PopService`` on the card and
    on the CPU at a fixed budget: the same verdicts, warm fractions and
    placements, the relaxations within 1e-5."""
    cfg = ExecConfig(solver_kw=BALANCE_FIXED)
    runs = {}
    for device in (cuda_device, "cpu"):
        sess = PopService(device=device).session("lb", domain="load_balance",
                                                 exec=cfg)
        runs[str(device)] = testing.balance_session(sess.step, 128, 16,
                                                    0.2)[1]
    got, want = runs[str(cuda_device)], runs["cpu"]
    assert [a.plan_cache for a in got] == ["miss", "hit", "repair"]
    for a, b in zip(got, want):
        assert a.plan_cache == b.plan_cache and a.engine == "matvec"
        assert a.warm_fraction == b.warm_fraction
        np.testing.assert_array_equal(a.alloc, b.alloc)
        np.testing.assert_allclose(a.raw.extra["pop_state"]["x"],
                                   b.raw.extra["pop_state"]["x"],
                                   rtol=1e-5, atol=1e-5)


def _balance_prob():
    from repro_torch.problems.load_balancing import (LoadBalanceProblem,
                                                     make_shard_workload)
    return LoadBalanceProblem(make_shard_workload(256, 16, seed=0))


def _kernel_solve_matches_plain(op, mod, kernels, plain):
    """A fixed budget through the kernels against the plain versions on
    the same card inputs: x and y within 1e-5, equal iterations, one
    call and one CUDA launch per half-step and iteration."""
    before = dict(mod.LAUNCHES)
    cuda_before = dict(mod.CUDA_LAUNCHES)
    got = pdhg.solve_stacked(op, engine=kernels, **BALANCE_FIXED)
    want = pdhg.solve_stacked(op, engine=plain, **BALANCE_FIXED)
    np.testing.assert_allclose(got.x, want.x, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.y, want.y, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.iterations, want.iterations)
    its = int(got.iterations.max())
    for name in before:
        assert mod.LAUNCHES[name] - before[name] == its
        assert mod.CUDA_LAUNCHES[name] - cuda_before[name] == its


@pytest.mark.cuda
def test_cuda_lane_kernels_at_balance_shapes(cuda_device):
    """The POP-4 ``structured=True`` relaxation at 256 shards on 16
    servers: each lane's per-server rows fill the wide bucket."""
    op = testing.balance_ops(_balance_prob(), 4, cuda_device,
                             structured=True)
    assert op.structured.wrow_idx.shape[-1] == 12
    _kernel_solve_matches_plain(op, structured_pdhg_step,
                                pdhg.fused_structured_engine(),
                                pdhg.fused_structured_engine("ref"))


@pytest.mark.cuda
def test_cuda_full_kernels_at_balance_shapes(cuda_device):
    """The single-lane full relaxation at 256 shards on 16 servers through
    the cooperative kernels."""
    op = testing.balance_ops(_balance_prob(), 1, cuda_device,
                             structured=True)
    plans = pdhg._wide_block_plans(op.structured)
    _kernel_solve_matches_plain(
        op, structured_full_pdhg_step,
        pdhg.resolve_engine("fused_structured_full", op),
        pdhg.fused_structured_full_engine("ref", *plans))


# --------------------------------------------------------------------------
# the serving ladder on the card: quarantine retry and checkpoints
# --------------------------------------------------------------------------

# a fixed budget (no tolerance stop), so the kernels and their plain
# versions make the same iterations and are held at 1e-5
QUARANTINE_KW = dict(max_iters=400, tol_primal=0.0, tol_gap=0.0,
                     equilibrate=True)


def _quarantined_session(device, engine):
    """A 256-job Gavel session (k=4): a cold step, lane 1 of the warm
    state poisoned with NaN, a step on the drifted fleet.  Returns that
    step and every solve it ran."""
    from repro_torch.analysis import faults
    svc = PopService(device=device)
    sess = svc.session("t", domain="gavel",
                       solve=SolveConfig(k=4, strategy="stratified",
                                         min_per_sub=8),
                       exec=ExecConfig(engine=engine,
                                       solver_kw=QUARANTINE_KW))
    solves = []
    inner = svc._solve_instance

    def recording(*args, **kw):
        solves.append(inner(*args, **kw))
        return solves[-1]

    svc._solve_instance = recording
    insts = testing.session_instances(256, (64, 64, 64), churn=0.05)
    sess.step(insts[0])
    faults.poison_warm(sess, lanes=[1])
    del solves[:]
    return sess.step(insts[1]), solves, svc.stats()


@pytest.mark.cuda
def test_cuda_quarantine_matches_plain_versions(cuda_device):
    """The poisoned lane diverges through the lane kernels exactly as
    through their plain versions, and the retry (lane 1 cold beside three
    warm lanes) gives the same allocation within 1e-5."""
    before = dict(structured_pdhg_step.CUDA_LAUNCHES)
    got, got_solves, got_stats = _quarantined_session(cuda_device,
                                                      "fused_structured")
    launched = {name: n - before[name]
                for name, n in structured_pdhg_step.CUDA_LAUNCHES.items()}
    want, want_solves, want_stats = _quarantined_session(
        cuda_device, pdhg.fused_structured_engine("ref"))
    for a in (got, want):
        assert a.status == "recovered"
        assert a.faults == ("divergence:1",)
        assert a.raw.warm_stats["quarantined_lanes"] == 1
        assert a.raw.warm_stats["lanes_cold"] == 1
        assert a.raw.warm_stats["warm_fraction"] == 0.75
        assert np.isfinite(a.alloc).all()
    assert len(got_solves) == len(want_solves) == 2
    np.testing.assert_array_equal(got_solves[0].diverged,
                                  want_solves[0].diverged)
    np.testing.assert_array_equal(got_solves[0].diverged,
                                  [False, True, False, False])
    assert not got_solves[1].diverged.any()
    np.testing.assert_array_equal(got.raw.iterations, want.raw.iterations)
    np.testing.assert_allclose(got.alloc, want.alloc, rtol=1e-5, atol=1e-5)
    assert got_stats["quarantined_lanes"] == want_stats["quarantined_lanes"]
    assert min(launched.values()) > 0


@pytest.mark.cuda
def test_cuda_checkpoint_restores_onto_the_card(cuda_device):
    """A checkpoint taken on the card restores its iterates onto the card
    as float32, and the restored session's next step is a warm hit."""
    insts = testing.session_instances(256, (64, 64, 64), churn=0.05)
    cfg = SolveConfig(k=4, strategy="stratified", min_per_sub=8)
    svc = PopService(device=cuda_device)
    sess = svc.session("t", domain="gavel", solve=cfg)
    sess.step(insts[0])
    fresh = PopService(device=cuda_device)
    assert fresh.restore(svc.checkpoint()) == {
        "restored": ["t"], "cold": [], "errors": {}}
    restored = fresh.session("t")
    for it in (restored._warm.x, restored._warm.y):
        assert it.is_cuda and it.dtype == torch.float32
    a, b = restored.step(insts[1]), sess.step(insts[1])
    assert a.plan_cache == "hit" and a.warm_fraction == 1.0
    assert abs(a.metrics["mean_norm_throughput"]
               - b.metrics["mean_norm_throughput"]) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("k", [4, 1], ids=["pop", "full"])
def test_cuda_restores_a_reference_blob(cuda_device, k):
    """A checkpoint the JAX package wrote (``tests/fixtures/session``: a
    two-step traffic session, 24 demands) restores warm onto the card; the
    next step equals the same restore's on the CPU within 1e-3."""
    from pathlib import Path
    from repro_torch.problems import traffic_engineering as te
    blob = (Path(__file__).resolve().parent / "fixtures" / "session"
            / f"reference_traffic24_k{k}.popses").read_bytes()
    topo = te.make_topology(20, 40, seed=0)
    pairs, dem = te.make_demands(topo, 24, seed=0)
    paths = te.k_shortest_paths(topo, pairs, n_paths=2, max_len=10, seed=0)
    nxt = te.TrafficProblem(topo, pairs, dem * 1.2, paths)
    allocs = []
    for device in (cuda_device, torch.device("cpu")):
        svc = PopService(device=device)
        assert svc.restore(blob, strict=True) == {
            "restored": ["a"], "cold": [], "errors": {}}
        sess = svc.session("a")
        assert sess._warm.x.device.type == device.type
        assert sess._warm.x.dtype == torch.float32
        a = sess.step(nxt)
        assert a.warm_fraction == 1.0
        assert a.plan_cache == ("hit" if k > 1 else "full")
        allocs.append(np.asarray(a.alloc, float))
    np.testing.assert_allclose(allocs[0], allocs[1], atol=1e-3)


# --------------------------------------------------------------------------
# async serving on the card: a coalesced round through the lane kernels
# --------------------------------------------------------------------------

def _coalesced_round(device, engine):
    """Four 256-job Gavel tenants (k=4, a fixed budget) stepped cold through
    ``step_async`` under a held dispatcher: one 16-lane launch.  Returns
    ({tenant: Allocation}, the dispatcher's counters)."""
    import time
    from repro_torch.service import DispatchConfig
    svc = PopService(device=device, dispatch=DispatchConfig(max_wait_ms=20))
    cfg = dict(domain="gavel",
               solve=SolveConfig(k=4, strategy="stratified", min_per_sub=8),
               exec=ExecConfig(engine=engine, solver_kw=QUARANTINE_KW))
    insts = {s: testing.session_instances(256, (64, 64, 64), churn=0.05,
                                          seed=s)[0] for s in range(4)}
    sessions = {s: svc.session(f"t{s}", **cfg) for s in insts}
    try:
        with svc.dispatcher.hold():
            futs = {s: sessions[s].step_async(insts[s]) for s in insts}
            t_end = time.monotonic() + 120
            while (svc.dispatcher.stats()["requests"] < len(futs)
                   and time.monotonic() < t_end):
                time.sleep(0.01)
        allocs = {s: f.result(timeout=300) for s, f in futs.items()}
        return allocs, svc.dispatcher.stats()
    finally:
        svc.close()


@pytest.mark.cuda
def test_cuda_coalesced_round_matches_plain_versions(cuda_device):
    """One held round of four tenants is one 16-lane launch of the lane
    kernels, one CUDA launch a half-step, and every tenant's allocation is
    the plain versions' coalesced round's within 1e-5 at equal
    iterations."""
    calls = dict(structured_pdhg_step.LAUNCHES)
    before = dict(structured_pdhg_step.CUDA_LAUNCHES)
    got, got_stats = _coalesced_round(cuda_device, "fused_structured")
    n_calls = {name: n - calls[name]
               for name, n in structured_pdhg_step.LAUNCHES.items()}
    launched = {name: n - before[name]
                for name, n in structured_pdhg_step.CUDA_LAUNCHES.items()}
    want, want_stats = _coalesced_round(cuda_device,
                                        pdhg.fused_structured_engine("ref"))
    for stats in (got_stats, want_stats):
        assert (stats["launches"], stats["coalesced_requests"],
                stats["lanes"], stats["group_fallbacks"]) == (1, 4, 16, 0)
    assert n_calls == launched and min(n_calls.values()) > 0
    for s, a in got.items():
        b = want[s]
        assert a.status == b.status == "ok"
        np.testing.assert_array_equal(a.raw.iterations, b.raw.iterations)
        np.testing.assert_allclose(a.alloc, b.alloc, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [6_145, 136_000])
@pytest.mark.parametrize("fn", ["sum", "norm"])
def test_cuda_row_reduce_independent_of_row_count(cuda_device, n, fn):
    """``kernels/ref.py:row_reduce`` on the card: a lane's sum (2-norm)
    keeps its bits from a stack of 4 or 8 rows to one of 64, at the main
    path's lane width and at load balancing's (whose rows CUDA's reduction
    would split across blocks by the row count)."""
    from repro_torch.kernels import ref
    red = {"sum": ref.sum_last, "norm": ref.norm_last}[fn]
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    a = torch.randn(64, n, generator=gen, device=cuda_device)
    whole = ref.row_reduce(red, a)
    for rows in (4, 8):
        assert torch.equal(ref.row_reduce(red, a[:rows]), whole[:rows])


@pytest.mark.cuda
def test_cuda_build_profile_seals(cuda_device, tmp_path):
    """A tiny profile measured on the card (gavel, fast probes, the launch
    line): it names the card's device type, its thresholds apply there
    only, and its seal survives save_profile / load_profile."""
    from repro_torch import tuning
    profile = tuning.build_profile(domains=("gavel",), fast=True,
                                   measure_backends=False,
                                   device=cuda_device)
    assert profile.platform == "cuda"
    assert profile.jax_version == "torch-" + torch.__version__
    rows = dict(profile.domains["gavel"].quality_vs_k)
    assert rows[1.0] == 1.0 and len(rows) > 1
    assert all(isinstance(v, float) for v in rows.values())
    assert profile.launch_cost["overhead_s"] >= 0.0
    path = tuning.save_profile(profile, tmp_path / "card.json")
    loaded = tuning.check_profile(tuning.load_profile(path),
                                  platform="cuda")
    assert loaded.digest == profile.digest
    with pytest.raises(tuning.ProfileError, match="measured on"):
        tuning.check_profile(loaded, platform="cpu")


@pytest.mark.cuda
def test_cuda_service_rejects_cpu_profile(cuda_device):
    """The committed ``TUNING_profile.json`` was measured on the CPU: a
    service on the card refuses it at the door instead of planning k from
    CPU curves."""
    from pathlib import Path
    from repro_torch import tuning
    committed = Path(__file__).resolve().parents[1] / "TUNING_profile.json"
    assert tuning.load_profile(committed).platform == "cpu"
    with pytest.raises(tuning.ProfileError, match="measured on 'cpu'"):
        PopService(device=cuda_device, profile=str(committed))


@pytest.mark.cuda
def test_cuda_moe_session_matches_cpu_session(cuda_device):
    """Cold, drift, then 10% expert churn at 96 experts on 8 devices
    (``testing.moe_session``) through ``PopService`` on the card and on the
    CPU at a fixed budget: the same verdicts, warm fractions and
    placements, served load and objective within 1e-3."""
    cfg = ExecConfig(solver_kw=dict(max_iters=300, tol_primal=0.0,
                                    tol_gap=0.0))
    runs = {}
    for device in (cuda_device, "cpu"):
        sess = PopService(device=device).session(
            "moe", domain="moe_placement", exec=cfg)
        runs[str(device)] = testing.moe_session(sess.step, 96, 8, 1.03,
                                                0.1)[1]
    got, want = runs[str(cuda_device)], runs["cpu"]
    assert [a.plan_cache for a in got] == ["miss", "hit", "repair"]
    for a, b in zip(got, want):
        assert a.plan_cache == b.plan_cache and a.engine == "matvec"
        assert a.warm_fraction == b.warm_fraction
        np.testing.assert_array_equal(a.alloc, b.alloc)
        for key in ("served", "objective"):
            assert abs(a.metrics[key] - b.metrics[key]) < 1e-3


# ---------------------------------------------------------------------------
# the language-model serving path (models, serve engine, launch/serve)
# ---------------------------------------------------------------------------

LM_TOL = 1e-4


@pytest.fixture
def no_tf32(cuda_device):
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield cuda_device
    torch.backends.cuda.matmul.allow_tf32 = before


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["h2o_danube3_4b", "gemma3_4b",
                                  "gemma2_27b", "llama3_8b", "mixtral_8x22b",
                                  "qwen2_moe_a2_7b", "zamba2_2_7b",
                                  "seamless_m4t_medium", "chameleon_34b",
                                  "xlstm_350m"])
def test_cuda_lm_matches_cpu(arch, no_tf32):
    """Each reduced architecture on the card against the port on the CPU:
    one parameter set made on the CPU, forward_train and 8 decode steps
    within 1e-4 in f32 with TF32 off, the same greedy tokens."""
    from repro_torch import configs, models
    cfg = configs.get_reduced(arch)
    params = models.init_params(torch.Generator().manual_seed(1), cfg)
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab, (2, 8), generator=gen)
    enc = (torch.randn(2, 6, cfg.d_model, generator=gen)
           if cfg.enc_segments else None)
    want = testing.teacher_forcing(params, cfg, toks, torch.float32, enc)
    got = testing.teacher_forcing(testing.to_device(params, no_tf32), cfg,
                                  toks.to(no_tf32), torch.float32,
                                  None if enc is None else enc.to(no_tf32))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=LM_TOL)
        assert torch.equal(g.argmax(-1), w.argmax(-1))


@pytest.mark.cuda
def test_cuda_serve_driver(cuda_device):
    """``launch.serve`` on the card: CUDA-event step times, peak memory,
    greedy tokens in the vocabulary and the same tokens from the same
    seed."""
    from repro_torch.launch import serve
    argv = ["--arch", "llama3_8b", "--reduced", "--batch", "4",
            "--max-seq", "64", "--prompt", "8", "--tokens", "8"]
    run = serve.main(argv)
    assert run.step_ms is not None and run.step_ms > 0
    assert run.peak_bytes >= run.cache_bytes
    assert bool(torch.isfinite(run.final_logits).all())
    assert bool(((run.tokens >= 0) & (run.tokens < 512)).all())
    assert torch.equal(serve.main(argv).tokens, run.tokens)


@pytest.mark.cuda
def test_cuda_balance_requests_and_scheduler(cuda_device):
    """The two shims on the card: valid placements, and a scheduler round
    whose allocations are time fractions."""
    import warnings
    from repro_torch.sched import GavelScheduler, JobSpec, SchedulerConfig
    from repro_torch.serve import balance_requests
    rng = np.random.default_rng(1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        res = balance_requests(rng.uniform(1.0, 8.0, 40), 6, pop_k=2)
        sched = GavelScheduler(SchedulerConfig(pop_k=2))
    assert ((res.placement >= 0) & (res.placement < 6)).all()
    for i in range(32):
        sched.submit(JobSpec(job_id=f"j{i}", arch="llama3_8b",
                             throughputs=np.abs(rng.normal(
                                 [1.0, 0.6, 0.8], 0.2)) + 0.05))
    rho = np.concatenate([np.atleast_1d(v)
                          for v in sched.allocate().values()])
    assert rho.shape == (32,) and (rho >= 0).all() and (rho <= 1 + 1e-6).all()


# ---------------------------------------------------------------------------
# the training path (train/, data/, checkpoint/checkpointer.py)
# ---------------------------------------------------------------------------

REMAT_RTOL = 1e-6
ARCHS = ["h2o_danube3_4b", "gemma3_4b", "gemma2_27b", "llama3_8b",
         "mixtral_8x22b", "qwen2_moe_a2_7b", "zamba2_2_7b",
         "seamless_m4t_medium", "chameleon_34b", "xlstm_350m"]


def _tree_max_diff(a, b) -> float:
    from repro_torch.models.transformer import leaves
    return max(float((x.cpu() - y.cpu()).abs().max())
               for x, y in zip(leaves(a), leaves(b)))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_train_step_matches_cpu(arch, no_tf32):
    """One train step (2 microbatches of 1 x 8 tokens, f32,
    ``testing.PARITY_ADAMW``) of the same parameters on the card and on
    the CPU, every routing checked for a top-k tie: the loss, grad_norm
    (relative to its value), parameters, m and v within 1e-4."""
    from repro_torch import configs, models
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.train_step import TrainConfig, make_train_step
    cfg = configs.get_reduced(arch)
    tcfg = TrainConfig(n_microbatches=2, compute_dtype="float32",
                       adamw=opt_mod.AdamWConfig(**testing.PARITY_ADAMW))
    host = models.init_params(torch.Generator().manual_seed(1), cfg)
    card = testing.to_device(host, no_tf32)
    batch = testing.train_batch(cfg, 2, 8, seed=1)
    out = {}
    with testing.router_tie_guard():
        for name, params, b in (("card", card,
                                 testing.to_device(batch, no_tf32)),
                                ("cpu", host, batch)):
            step = make_train_step(cfg, tcfg)
            out[name] = step(params, opt_mod.init_state(params), b)
    (gp, go, gm), (wp, wo, wm) = out["card"], out["cpu"]
    assert abs(float(gm["loss"]) - float(wm["loss"])) <= LM_TOL
    assert abs(float(gm["grad_norm"]) - float(wm["grad_norm"])) <= \
        LM_TOL * float(wm["grad_norm"])
    for a, b in ((gp, wp), (go.m, wo.m), (go.v, wo.v)):
        assert _tree_max_diff(a, b) <= LM_TOL
    assert go.step.device.type == "cuda" and int(go.step) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_remat_on_and_off(arch, no_tf32):
    """One f32 forward and backward on the card with remat on and off: the
    loss and every gradient within 1e-6 of the leaf's largest."""
    from repro_torch import configs, models
    from repro_torch.models.transformer import leaves
    from repro_torch.train.train_step import TrainConfig, make_loss_fn
    cfg = configs.get_reduced(arch)
    params = models.init_params(torch.Generator(no_tf32).manual_seed(1),
                                cfg)
    batch = testing.train_batch(cfg, 2, 16, seed=2, device=no_tf32)
    runs = []
    for remat in (True, False):
        flat = list(leaves(params))
        for p in flat:
            p.grad = None
            p.requires_grad_(True)
        loss = make_loss_fn(cfg, TrainConfig(compute_dtype="float32",
                                             remat=remat))(params, batch)
        loss.backward()
        runs.append((float(loss.detach()), [p.grad.clone() for p in flat]))
        for p in flat:
            p.requires_grad_(False)
    (la, ga), (lb, gb) = runs
    assert abs(la - lb) <= REMAT_RTOL * abs(lb)
    for a, b in zip(ga, gb):
        assert float((a - b).abs().max()) <= \
            REMAT_RTOL * float(b.abs().max())


@pytest.mark.cuda
def test_cuda_checkpointer_round_trip(cuda_device, tmp_path):
    """Card tensors through ``save_async`` (updated in place right after)
    and ``restore`` onto a card-side tree: the saved bits, on the card."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.models.transformer import leaves
    from repro_torch.train import optimizer as opt_mod
    gen = torch.Generator(cuda_device).manual_seed(0)
    params = {"w": torch.randn(64, 32, generator=gen, device=cuda_device),
              "blocks": [{"scale": torch.randn(32, generator=gen,
                                               device=cuda_device)}]}
    tree = {"params": params, "opt": opt_mod.init_state(params)}
    want = [t.cpu().clone() for t in leaves(tree)]
    ck = Checkpointer(str(tmp_path))
    ck.save_async(3, tree, extras={"step": 3})
    for t in leaves(params):
        t.add_(1.0)
    ck.wait()
    restored, extras = ck.restore(3, tree)
    assert extras == {"step": 3}
    for got, w in zip(leaves(restored), want):
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), w)


@pytest.mark.cuda
def test_cuda_prefetcher_stages_batches(cuda_device):
    """``DevicePrefetcher`` on the card: each batch equal to the pipeline's
    draw, on the card, usable on the caller's stream."""
    from repro_torch.data import DevicePrefetcher, TokenPipeline
    want = TokenPipeline(vocab=100, batch=4, seq=32, seed=2)
    pre = DevicePrefetcher(TokenPipeline(vocab=100, batch=4, seq=32,
                                         seed=2), cuda_device)
    try:
        for i, ref in zip(range(5), iter(want)):
            got = next(pre)
            total = got["tokens"].sum()          # read on the caller's stream
            for k, v in ref.items():
                assert got[k].device.type == "cuda"
                np.testing.assert_array_equal(got[k].cpu().numpy(), v)
            assert int(total) == int(ref["tokens"].sum())
            assert pre.state()["cursor"] == i + 1
    finally:
        pre.close()


# ---------------------------------------------------------------------------
# the mesh layer on an NCCL world of one
# ---------------------------------------------------------------------------

@pytest.fixture
def host_mesh(cuda_device):
    """``make_host_mesh()``: a (1, 1) mesh over an NCCL world of one (the
    process group stays for the session)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh()
    assert tuple(mesh.shape) == (1, 1) and mesh.device_type == "cuda"
    assert dist.get_backend() == "nccl"
    return mesh


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["shard_map", "pmap"])
def test_cuda_map_backend_session_matches_vmap(host_mesh, backend):
    """A 512-job Gavel session (cold, drift, churn; the registry's
    defaults) through each multi-device backend: allocations and per-lane
    iterations bit-equal to the vmap session's, the lane kernels
    launched."""
    import dataclasses
    from repro_torch.domains import registry
    insts = testing.session_instances(512, (128, 128, 128), 0.05)
    opts = ({"mesh": host_mesh, "axis": "data"} if backend == "shard_map"
            else {"devices": (torch.device("cuda"),)})
    spec = registry.get("gavel")
    runs = {}
    for name, o in (("vmap", {}), (backend, opts)):
        ex = dataclasses.replace(spec.default_exec, backend=name,
                                 backend_opts=o)
        sess = PopService(device="cuda").session(f"m-{name}", insts[0],
                                                 exec=ex)
        for k in structured_pdhg_step.LAUNCHES:
            structured_pdhg_step.LAUNCHES[k] = 0
        runs[name] = ([sess.step(i) for i in insts],
                      dict(structured_pdhg_step.LAUNCHES))
    for a, b in zip(runs[backend][0], runs["vmap"][0]):
        assert a.backend == backend and b.backend == "vmap"
        np.testing.assert_array_equal(a.alloc, b.alloc)
        np.testing.assert_array_equal(np.asarray(a.raw.iterations),
                                      np.asarray(b.raw.iterations))
    assert all(n > 0 for n in runs[backend][1].values())


def _mesh_train(cfg, tcfg, batches, mesh, device):
    from repro_torch import models
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.train_step import (init_placed_params,
                                              init_placed_state,
                                              jit_train_step,
                                              make_train_step)
    gen = torch.Generator(device).manual_seed(0)
    if mesh is None:
        params = models.init_params(gen, cfg)
        opt = opt_mod.init_state(params)
        step = make_train_step(cfg, tcfg)
    else:
        params = init_placed_params(gen, cfg, mesh)
        opt = init_placed_state(params)
        step = jit_train_step(cfg, tcfg, mesh)
    metrics = []
    for b in batches:
        params, opt, m = step(params, opt, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return params, metrics


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_jit_train_step_bit_equal(host_mesh, dtype):
    """Two steps of reduced llama3-8b (2 microbatches, remat) through
    ``jit_train_step`` on the (1, 1) mesh: metrics and every parameter
    bit-equal to ``make_train_step``'s from the same seed."""
    from repro_torch.configs import get_reduced
    from repro_torch.models.transformer import leaves
    from repro_torch.train.train_step import TrainConfig
    cfg = get_reduced("llama3_8b")
    tcfg = TrainConfig(n_microbatches=2, compute_dtype=dtype)
    batches = [testing.train_batch(cfg, 4, 32, seed=s, device="cuda")
               for s in (0, 1)]
    want, wm = _mesh_train(cfg, tcfg, batches, None, torch.device("cuda"))
    got, gm = _mesh_train(cfg, tcfg, batches, host_mesh,
                          torch.device("cuda"))
    assert gm == wm
    for g, w in zip(leaves(got), leaves(want)):
        assert torch.equal(g.to_local(), w)


@pytest.mark.cuda
def test_cuda_jit_serve_step_matches_unsharded(host_mesh):
    """Reduced llama3-8b, batch 4, 8 greedy tokens in bf16 through
    ``launch.serve.serve(mesh=)``, from parameters built on the mesh:
    tokens and final logits bit-equal to the unsharded path's."""
    from repro_torch.configs import get_reduced
    from repro_torch.launch import serve
    cfg = get_reduced("llama3_8b")
    params = serve.build_params(cfg, 0, "cuda")
    prompt = serve.random_prompt(cfg, 4, 5, 0, "cuda")
    a = serve.serve(cfg, params, prompt, 8, 64)
    b = serve.serve(cfg, serve.build_params(cfg, 0, "cuda", host_mesh),
                    prompt, 8, 64, mesh=host_mesh)
    assert torch.equal(a.tokens, b.tokens)
    assert torch.equal(a.final_logits, b.final_logits)


@pytest.mark.cuda
def test_cuda_compressed_psum_world_of_one(host_mesh):
    """Over NCCL with one rank the mean is the rank's own dequantised
    payload and the residual its own error feedback, bit for bit."""
    from repro_torch.train import compression as comp
    gen = torch.Generator("cuda").manual_seed(1)
    g = {"w": torch.randn(3000, generator=gen, device="cuda")}
    r = comp.init_residuals(g)
    mean, r2 = comp.compressed_psum(g, r, group=host_mesh.get_group("data"))
    q, s, want_r = comp.compress_with_feedback(g["w"], r["w"])
    assert torch.equal(mean["w"], comp.dequantize_int8(q, s, (3000,)))
    assert torch.equal(r2["w"], want_r)


@pytest.mark.cuda
def test_cuda_checkpoint_restores_onto_mesh(host_mesh, tmp_path):
    """Parameters placed on the mesh, saved, restored onto the mesh by
    their placements and unsharded: bit-equal, on the card."""
    from repro_torch import models
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_reduced
    from repro_torch.launch import shardings as sh
    from repro_torch.models.transformer import leaves
    from repro_torch.train.train_step import place_params
    cfg = get_reduced("llama3_8b")
    params = models.init_params(torch.Generator("cuda").manual_seed(4), cfg)
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"p": place_params(params, host_mesh)})
    like = {"p": models.init_params(None, cfg)}
    on_mesh, _ = ck.restore(1, like, mesh=host_mesh, shardings={
        "p": sh.param_shardings(like["p"], host_mesh)})
    plain, _ = ck.restore(1, {"p": params})
    for a, b, w in zip(leaves(on_mesh), leaves(plain), leaves(params)):
        assert a.to_local().device.type == "cuda"
        assert torch.equal(a.to_local(), w) and torch.equal(b, w)


@pytest.mark.cuda
def test_cuda_prefetcher_on_mesh(host_mesh):
    """``DevicePrefetcher(mesh=)``: DTensors on the card, rows on the data
    axis, equal to the pipeline's draw."""
    from repro_torch.data import DevicePrefetcher, TokenPipeline
    want = iter(TokenPipeline(vocab=100, batch=4, seq=16, seed=5))
    pre = DevicePrefetcher(TokenPipeline(vocab=100, batch=4, seq=16, seed=5),
                           torch.device("cuda"), mesh=host_mesh)
    try:
        for _ in range(3):
            got, ref = next(pre), next(want)
            for k, v in ref.items():
                assert got[k].to_local().device.type == "cuda"
                assert got[k].placements[0].is_shard(0)
                np.testing.assert_array_equal(
                    got[k].full_tensor().cpu().numpy(), v)
    finally:
        pre.close()
