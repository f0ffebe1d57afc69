"""Port parity: the two-bucket ELL packing of ``repro_torch.core.pdhg`` is
bit-equal to the reference's (idx, val, wide, ids and fold on both sides,
after ``stack_ops``), and the port's containers round-trip through numpy.

Cases: the Gavel COO of the conformance matrix (16 jobs, k=3, ragged
slots) and the skewed ``STRUCT_SHAPES`` of ``tests/test_kernels.py`` (one
full row + one full column).  Packed with every entry, zeros included, as
the reference's tests pack them, those shapes have no wide segment; packed
from their nonzeros only, the full row and column go to the wide
buckets."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pdhg as rpdhg, pop as rpop
from repro.problems.cluster_scheduling import (GavelProblem as RefGavel,
                                               make_cluster_workload)
from repro_torch import interop
from repro_torch.core import pdhg as tpdhg, pop as tpop
from repro_torch.problems.cluster_scheduling import GavelProblem

STRUCT_SHAPES = [
    (1, 64, 96, 0.3),
    (3, 45, 67, 0.25),
    (4, 130, 250, 0.05),
    (2, 256, 129, 0.1),
]


def _assert_struct_equal(ref_s, port_s):
    for f in rpdhg.StructuredOperator._fields:
        a, b = getattr(ref_s, f), getattr(port_s, f)
        if a is None:
            assert b is None, f
            continue
        a = np.asarray(a)
        b = b.numpy()
        assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
        np.testing.assert_array_equal(b, a, err_msg=f)


def _cluster_ops():
    wl = make_cluster_workload(16, num_workers=(6, 6, 6), seed=3)
    ref_prob = RefGavel(wl)
    ref_ops = rpop.build(ref_prob, rpop.plan(ref_prob, 3,
                                             strategy="stratified"))
    prob = GavelProblem(wl)
    ops = tpop.build(prob, tpop.plan(prob, 3, strategy="stratified"), "cpu")
    return ref_ops, ops


def test_gavel_ell_bit_equal_after_stack():
    ref_ops, ops = _cluster_ops()
    _assert_struct_equal(ref_ops.structured, ops.structured)
    for f in ("c", "q", "l", "u", "ineq_mask"):
        np.testing.assert_array_equal(getattr(ops, f).numpy(),
                                      np.asarray(getattr(ref_ops, f)))
    for a, b in zip(ref_ops.data, ops.data):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def _skewed_coo(k, M, N, density, sparse=False, seed=0):
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(k, M, N)) * (rng.random((k, M, N)) < density)
    G[:, M // 2, :] = rng.normal(size=(k, N))     # a full row
    G[:, :, N // 3] = rng.normal(size=(k, M))     # a full column
    coo = []
    for g in G:
        r, c = np.nonzero(g) if sparse else np.indices(g.shape).reshape(2, -1)
        coo.append((r, c, g[r, c]))
    return coo, G


def _stack(mod, wrap, coo, M, N):
    """One LP per lane around the lane's packed K, stacked by
    ``mod.stack_ops`` (which pads the lanes' ELL widths to the widest)."""
    zeros = lambda n: wrap(np.zeros(n, np.float32))
    return mod.stack_ops([
        mod.OperatorLP(c=zeros(N), q=zeros(M), l=zeros(N), u=zeros(N),
                       ineq_mask=wrap(np.ones(M, bool)), data=(),
                       structured=mod.structured_from_coo(*c, M, N))
        for c in coo])


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("shape", STRUCT_SHAPES)
def test_skewed_ell_bit_equal_after_stack(shape, sparse):
    k, M, N, density = shape
    coo, _ = _skewed_coo(k, M, N, density, sparse)
    ref = _stack(rpdhg, jnp.asarray, coo, M, N)
    port = _stack(tpdhg, torch.as_tensor, coo, M, N)
    _assert_struct_equal(ref.structured, port.structured)
    # the full row / column are wide exactly when only nonzeros are packed
    # and they exceed the cap of max(16, 4 x median width)
    wide_rows = int((port.structured.row_fold == 0).sum())
    wide_cols = int((port.structured.col_fold == 0).sum())
    if not sparse:
        assert wide_rows == wide_cols == 0
    elif density <= 0.1:
        assert wide_rows == wide_cols == k


@pytest.mark.parametrize("shape", STRUCT_SHAPES[1:3])
def test_structured_to_dense_matches_coo(shape):
    k, M, N, density = shape
    coo, G = _skewed_coo(k, M, N, density, sparse=True)
    s = _stack(tpdhg, torch.as_tensor, coo, M, N).structured
    np.testing.assert_allclose(tpdhg.structured_to_dense(s).numpy(),
                               G.astype(np.float32), rtol=1e-6, atol=1e-6)


def test_interop_roundtrip_builds_identical_payload():
    ref_ops, ops = _cluster_ops()
    fields = jax.tree.map(np.asarray, ref_ops._replace(structured=None))
    fields = dict(fields._asdict(),
                  structured={f: (None if v is None else np.asarray(v))
                              for f, v in ref_ops.structured._asdict().items()})
    op = interop.operator_from_numpy(fields, device="cpu")
    _assert_struct_equal(ref_ops.structured, op.structured)
    for f in ("c", "q", "l", "u", "ineq_mask"):
        np.testing.assert_array_equal(getattr(op, f).numpy(),
                                      getattr(ops, f).numpy())
    assert op.data[1].dtype == torch.int32
    s = interop.operator_from_numpy(fields["structured"], device="cpu")
    assert isinstance(s, tpdhg.StructuredOperator)
    wx, wy = interop.warm_from_numpy(np.ones((3, 4)), np.zeros((3, 2)),
                                     device="cpu")
    assert wx.dtype == torch.float32 and tuple(wy.shape) == (3, 2)
    ws = interop.warm_from_numpy(np.ones((3, 4)), np.zeros((3, 2)),
                                 mask=[True, False, True], device="cpu")
    assert ws.mask.tolist() == [True, False, True]


def test_quantized_storage_not_ported_raises():
    """Quantized ELL storage is ported: ``structured_from_coo(coef_dtype=)``
    stores int8 (with per-bucket scales) and bf16 payloads bit-equal to the
    reference's, and an unknown storage type raises."""
    coo, _ = _skewed_coo(1, 45, 67, 0.25, sparse=True)
    for coef_dtype in ("int8", "bfloat16"):
        ref = rpdhg.structured_from_coo(*coo[0], 45, 67, coef_dtype=coef_dtype)
        port = tpdhg.structured_from_coo(*coo[0], 45, 67,
                                         coef_dtype=coef_dtype)
        assert port.coef_dtype == coef_dtype
        for f in ("row_val", "wrow_val", "col_val", "wcol_val"):
            a, b = np.asarray(getattr(ref, f)), getattr(port, f)
            if coef_dtype == "bfloat16":
                a, b = a.view(np.int16), b.view(torch.int16)
            np.testing.assert_array_equal(b.numpy(), a, err_msg=f)
        for f in ("row_scale", "wrow_scale", "col_scale", "wcol_scale"):
            a, b = getattr(ref, f), getattr(port, f)
            if coef_dtype == "bfloat16":
                assert a is None and b is None
            else:
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    with pytest.raises(ValueError, match="coef_dtype"):
        tpdhg.structured_from_coo([0], [0], [1.0], 1, 1, coef_dtype="fp8")
