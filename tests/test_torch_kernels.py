"""Port parity for the structured PDHG half-steps.

The port's plain versions (``repro_torch.kernels.ref``, what the CPU path
runs) are held against the reference's Pallas kernels run in interpret
mode and against ``repro.kernels.ref``, on the skewed ``STRUCT_SHAPES`` of
``tests/test_kernels.py`` and on stacked Gavel sub-LPs.  Tolerances are
the reference's own (``test_kernels.py:160-174``): 1e-5 on the element-wise
tails x_new / y_new, 1e-4 on the gather-reduce products, whose summation
order differs between the packages.

The skewed shapes pack every entry of K, zeros included, as the
reference's tests do, so every segment is as wide as K and no bucket is
wide; the ``sparse`` cases pack only the nonzeros, which sends the full
row and column to the wide buckets.  The hand-written CUDA kernels are
held against the same plain versions in ``tests/test_torch_cuda.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pdhg as rpdhg, pop as rpop
from repro.kernels import ops as rops_k, ref as rref
from repro.problems.cluster_scheduling import (GavelProblem as RefGavel,
                                               make_cluster_workload)
from repro_torch import testing
from repro_torch.core import pdhg as tpdhg
from repro_torch.kernels import ops, ref, structured_pdhg_step

STRUCT_SHAPES = [
    (1, 64, 96, 0.3),
    (3, 45, 67, 0.25),
    (4, 130, 250, 0.05),
    (2, 256, 129, 0.1),
]
TAIL_TOL = dict(rtol=1e-5, atol=1e-5)
PRODUCT_TOL = dict(rtol=1e-4, atol=1e-4)


def _skewed(k, M, N, density, sparse=False, seed=0):
    """(reference StructuredOperator, port StructuredOperator) of the
    same stacked skewed K."""
    coo = testing.skewed_coo(k, M, N, density, sparse, seed)
    return (_stack(rpdhg, jnp.asarray, coo, M, N),
            _stack(tpdhg, torch.as_tensor, coo, M, N))


def _stack(mod, wrap, coo, M, N):
    """The lanes' StructuredOperators stacked by ``mod.stack_ops``, which
    pads the lanes' ELL widths to the widest."""
    zeros = lambda n: wrap(np.zeros(n, np.float32))
    return mod.stack_ops([
        mod.OperatorLP(c=zeros(N), q=zeros(M), l=zeros(N), u=zeros(N),
                       ineq_mask=wrap(np.ones(M, bool)), data=(),
                       structured=mod.structured_from_coo(*c, M, N))
        for c in coo]).structured


def _gavel():
    wl = make_cluster_workload(40, num_workers=(6, 6, 6), seed=3)
    prob = RefGavel(wl)
    s = rpop.build(prob, rpop.plan(prob, 4, strategy="stratified")).structured
    port = tpdhg.StructuredOperator(*(None if v is None else
                                      torch.as_tensor(np.array(v))
                                      for v in s))
    return s, port


def _cases():
    for shape in STRUCT_SHAPES:
        yield f"skewed{shape[:3]}", lambda shape=shape: _skewed(*shape)
    for shape in STRUCT_SHAPES[2:]:
        yield (f"sparse{shape[:3]}",
               lambda shape=shape: _skewed(*shape, sparse=True))
    yield "gavel40x4", _gavel


CASES = dict(_cases())


def _sizes(port_s):
    k, _, M = port_s.row_idx.shape
    return k, M, port_s.col_idx.shape[-1]


def _port_steps(port_s, o, device="cpu", backend=None):
    t = {name: torch.as_tensor(v, device=device) for name, v in o.items()}
    s = tpdhg.to_device(port_s, torch.device(device))
    xn, kx = ops.structured_forward_step(s, t["x"], t["c"], t["l"], t["u"],
                                         t["tau"], t["kty"], backend=backend)
    yn, kty = ops.structured_backward_step(s, t["y"], t["q"], t["sigma"],
                                           t["mask"], t["kxn"], t["kxp"],
                                           backend=backend)
    return [v.cpu().numpy() for v in (xn, kx, yn, kty)]


def _assert_steps_close(got, want):
    for g, w, tol in zip(got, want, (TAIL_TOL, PRODUCT_TOL) * 2):
        np.testing.assert_allclose(g, np.asarray(w), **tol)


@jax.jit
def _reference_kernels_interpret(s, j):
    """The reference's Pallas half-steps in interpret mode, traced once."""
    return (*rops_k.structured_forward_step(
                s, j["x"], j["c"], j["l"], j["u"], j["tau"], j["kty"],
                backend="interpret"),
            *rops_k.structured_backward_step(
                s, j["y"], j["q"], j["sigma"], j["mask"], j["kxn"], j["kxp"],
                backend="interpret"))


@jax.jit
def _reference_oracles(s, j):
    """The reference's plain half-steps and ``smatvec``, traced once."""
    return (*rref.structured_forward_step(
                s, j["x"], j["c"], j["l"], j["u"], j["tau"][:, None],
                j["kty"]),
            *rref.structured_backward_step(
                s, j["y"], j["q"], j["sigma"][:, None], j["mask"], j["kxn"],
                j["kxp"]),
            rref.smatvec(s, j["x"]))


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_steps_match_reference_kernels_interpret(case):
    ref_s, port_s = CASES[case]()
    o = testing.step_operands(*_sizes(port_s))
    want = _reference_kernels_interpret(ref_s, jax.tree.map(jnp.asarray, o))
    _assert_steps_close(_port_steps(port_s, o), want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_steps_match_reference_oracles(case):
    ref_s, port_s = CASES[case]()
    o = testing.step_operands(*_sizes(port_s), seed=5)
    *want, want_kx = _reference_oracles(ref_s, jax.tree.map(jnp.asarray, o))
    _assert_steps_close(_port_steps(port_s, o), want)
    x = torch.as_tensor(o["x"])
    np.testing.assert_allclose(ref.smatvec(port_s, x).numpy(),
                               np.asarray(want_kx), **PRODUCT_TOL)


def test_dispatch_on_cpu_takes_plain_version_only():
    _, port_s = CASES["gavel40x4"]()
    o = testing.step_operands(*_sizes(port_s))
    before = dict(structured_pdhg_step.LAUNCHES)
    auto = _port_steps(port_s, o, backend=None)
    plain = _port_steps(port_s, o, backend="ref")
    for a, b in zip(auto, plain):
        np.testing.assert_array_equal(a, b)
    assert structured_pdhg_step.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        _port_steps(port_s, o, backend="kernel")
    with pytest.raises(ValueError, match="unknown kernel backend"):
        _port_steps(port_s, o, backend="interpret")


def test_plain_tails_keep_nan():
    """A NaN iterate must survive the projections (the divergence guard
    reads it), in the plain versions as in jnp.clip / jnp.maximum."""
    nan = torch.tensor([[float("nan"), 1.0]])
    x_new = ref.primal_tail(nan, torch.zeros(1, 2), torch.zeros(1, 2),
                            torch.ones(1, 2), torch.ones(1, 1),
                            torch.zeros(1, 2))
    assert torch.isnan(x_new[0, 0]) and x_new[0, 1] == 1.0
    y_new = ref.dual_tail(nan, torch.zeros(1, 2), torch.ones(1, 1),
                          torch.ones(1, 2, dtype=torch.bool),
                          torch.zeros(1, 2), torch.zeros(1, 2))
    assert torch.isnan(y_new[0, 0])
