"""The hand-written CUDA kernels of the port, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device; the
file imports no JAX, so it also runs where only the port is installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version (``kernels/ref.py``)
on the same CUDA inputs.  The element-wise tails are bit-equal (the
kernels round every operation to nearest and contract nothing into an
FMA, as the plain version's separate elementwise ops do); the
gather-reduce products sum in another order, so they are held at the
reference's product tolerance of 1e-4 (``tests/test_kernels.py``)."""

import numpy as np
import pytest
import torch

from repro_torch import testing
from repro_torch.core import pdhg, pop
from repro_torch.core.config import SolveConfig
from repro_torch.kernels import ops, structured_pdhg_step
from repro_torch.problems.cluster_scheduling import (GavelProblem,
                                                     make_cluster_workload)
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
