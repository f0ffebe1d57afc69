"""The port's map backends on the reference's own backend cases
(``tests/test_backends.py``): ``shard_map`` walking each rank's lanes in
chunks, and ``pmap``'s default devices.

Both packages solve the reference's instance (30 Gavel jobs, k=6,
stratified, 1e-4 to convergence).  Within the port every chunk is
bit-equal to ``vmap`` (no lane's sums depend on its stack's lane count,
``kernels/ref.py:row_reduce``), tighter than the reference's own 1e-6
for a backend against its ``vmap``.  Against the reference the port has
equal per-lane iterations and its allocation within ``REF_TOL`` (1e-5,
the conformance standard across the packages): the two ``vmap`` solves
already differ by 3.31e-6, their f32 sums added in another order over
520-1,280 iterations, whatever the chunk.  ``shard_map`` runs on a gloo
world of one in this process (``testing.gloo_world``)."""

import warnings

import numpy as np
import pytest
import torch

from repro.core import pop as rpop
from repro.problems.cluster_scheduling import GavelProblem as RefGavel
from repro.problems.cluster_scheduling import (
    make_cluster_workload as ref_workload)
from repro_torch import testing
from repro_torch.core import backends as tback, pop as tpop
from repro_torch.core.pdhg import OperatorLP
from repro_torch.problems.cluster_scheduling import (GavelProblem,
                                                     make_cluster_workload)

SOLVER_KW = dict(max_iters=4_000, tol_primal=1e-4, tol_gap=1e-4)
K = 6
REF_TOL = 1e-5


def _port_solve(backend, **opts):
    wl = make_cluster_workload(30, num_workers=(8, 8, 8), seed=5)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return tpop.pop_solve(GavelProblem(wl, space_sharing=False), K,
                              strategy="stratified", backend=backend,
                              solver_kw=SOLVER_KW, backend_opts=opts,
                              device="cpu")


@pytest.fixture(scope="module")
def reference():
    """The reference's ``test_shard_map_chunked_matches_vmap`` solve:
    ``shard_map`` at ``chunk=2`` (k=6 pads to a multiple of n_dev * 2)."""
    wl = ref_workload(30, num_workers=(8, 8, 8), seed=5)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return rpop.pop_solve(RefGavel(wl, space_sharing=False), K,
                              strategy="stratified", backend="shard_map",
                              solver_kw=SOLVER_KW,
                              backend_opts=dict(chunk=2))


@pytest.fixture(scope="module")
def port_vmap():
    return _port_solve("vmap")


@pytest.fixture
def no_tuned_thresholds():
    yield
    tback.install_tuned_thresholds(None)


@pytest.mark.parametrize("chunk", [2, 1, 0, None])
def test_shard_map_chunked_matches_reference(reference, port_vmap, chunk):
    """The reference's ``chunk=2`` case, and the port at every chunk:
    bit-equal to the port's ``vmap``; within REF_TOL of the reference with
    equal iterations."""
    with testing.gloo_world():
        got = _port_solve("shard_map", chunk=chunk)
    np.testing.assert_allclose(got.alloc, np.asarray(reference.alloc),
                               atol=REF_TOL)
    np.testing.assert_array_equal(got.iterations,
                                  np.asarray(reference.iterations))
    np.testing.assert_array_equal(got.alloc, port_vmap.alloc)
    np.testing.assert_array_equal(got.iterations, port_vmap.iterations)


def test_shard_map_chunks_from_the_per_rank_share(no_tuned_thresholds):
    """``chunk=None`` chunks when a rank's share of the lanes exceeds the
    one-device ``vmap`` ceiling, counted per rank: 6 lanes over 4 ranks
    are 2 a rank, so a ceiling of 2 lanes leaves them whole and a ceiling
    of 1 chunks them; on one rank a ceiling of 2 chunks.  The element
    ceiling counts the per-rank share too."""
    x, y = torch.zeros((K, 10)), torch.zeros((K, 4))
    ops = OperatorLP(c=x, q=y, l=x, u=x, ineq_mask=y.bool(), data=())
    batch = (ops, x, y)
    per_sub = tback._n_elems_per_sub(batch[0])
    for max_k, n, want in ((2, 4, 0), (1, 4, tback.DEFAULT_CHUNK),
                           (2, 1, tback.DEFAULT_CHUNK), (6, 1, 0)):
        tback.install_tuned_thresholds(
            {"cpu": {"vmap_max_k": max_k, "vmap_max_elems": 10 ** 9}})
        assert tback._rank_chunk(batch, n, "cpu") == want, (max_k, n)
    tback.install_tuned_thresholds(
        {"cpu": {"vmap_max_k": 64, "vmap_max_elems": 2 * per_sub}})
    assert tback._rank_chunk(batch, 4, "cpu") == 0
    assert tback._rank_chunk(batch, 2, "cpu") == tback.DEFAULT_CHUNK
    # the thresholds are the batch's device type's: none installed for
    # the card, so its constants decide
    assert tback._rank_chunk(batch, 1, "cuda") == 0


def test_shard_map_self_chunks_on_a_heavy_rank(port_vmap, monkeypatch,
                                               no_tuned_thresholds):
    """With a one-lane ``vmap`` ceiling a world of one walks its six lanes
    in chunks of ``DEFAULT_CHUNK`` (k padded to 16, one chunk of 16
    lanes): bit-equal to ``vmap``."""
    seen = []
    inner = tback._solve_batch

    def recording(batch, *args, **kw):
        seen.append(tback.batch_size(batch))
        return inner(batch, *args, **kw)

    monkeypatch.setattr(tback, "_solve_batch", recording)
    tback.install_tuned_thresholds({"cpu": {"vmap_max_k": 1}})
    with testing.gloo_world():
        got = _port_solve("shard_map")
    assert seen == [tback.DEFAULT_CHUNK]
    np.testing.assert_array_equal(got.alloc, port_vmap.alloc)
    np.testing.assert_array_equal(got.iterations, port_vmap.iterations)


def test_pmap_defaults_to_every_device_of_the_batch_type(port_vmap,
                                                         monkeypatch):
    """A CPU batch's default is the CPU alone (bit-equal to ``vmap``); a
    batch on the card would spread over ``cuda:0`` to ``cuda:n-1``, as the
    reference's ``jax.devices()``."""
    assert tback._visible(torch.device("cpu")) == [torch.device("cpu")]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tback._visible(torch.device("cuda", 0)) == [
        torch.device("cuda", i) for i in range(4)]
    monkeypatch.undo()
    got = _port_solve("pmap")
    np.testing.assert_array_equal(got.alloc, port_vmap.alloc)
    np.testing.assert_array_equal(got.iterations, port_vmap.iterations)


@pytest.mark.parametrize("size", [1, 2, 3, 8])
def test_slices_keep_each_lane_at_its_place_modulo_the_phase(size):
    """A slice of the stack starting at lane ``lo`` is led by ``lo %
    LANE_PHASE`` copies of lane ``lo``: every lane sits at its place in
    the whole stack modulo the phase, where the card's row reductions
    give it the same bits (``tests/test_torch_cuda.py``), and dropping the
    lead gives the lanes themselves."""
    stack = torch.arange(8 * 5, dtype=torch.float32).reshape(8, 5)
    for lo in range(0, 8 - size + 1):
        part, lead = tback._slice_lanes(stack, lo, size)
        assert lead == lo % tback.LANE_PHASE
        assert part.shape == (lead + size, 5)
        assert torch.equal(part[lead:], stack[lo:lo + size])
        assert torch.equal(part[:lead], stack[lo].expand(lead, 5))
        for i in range(size):
            assert (lead + i) % tback.LANE_PHASE == \
                (lo + i) % tback.LANE_PHASE
