"""The per-layer readers on hand-made inputs: the LP's byte count, the
device trace's busy share, the kernels inside solve_map, the named idle
gaps."""

import numpy as np
import pytest

from popbench_tiny import config
from popbench import trace
from popbench.metrics import (device_idle, host_prep_s, iter_roofline,
                              iters_per_step, kernels_per_iter, ms_per_iter)
from popbench.reference import gavel


def test_lane_iteration_bytes_by_hand():
    # a Gavel lane of 2 jobs: X [2, 3] and t (7 variables), 2 epigraph +
    # 2 time + 3 worker rows (7), S and z of each job (8 numbers)
    # products 2 x 8, iterates (7 + 7) read and written, c, l, u (3 x 7)
    # and q (7) read: 16 + 28 + 21 + 7 = 72 numbers of 4 bytes
    assert iter_roofline.lane_iteration_bytes(7, 7, 8) == 288


def test_gavel_sizes_leave_out_padding():
    fleet = {"T": np.ones((3, 3)), "w": np.ones(3), "z": np.ones(3),
             "num_workers": np.array([2.0, 2.0, 2.0])}
    idx = np.array([[0, 2], [1, -1]])
    lp = gavel.Lanes(fleet, idx, config())
    assert lp.sizes() == [(7, 7, 8), (4, 5, 4)]


def profile():
    # two steps 0-100 and 100-200 ns; solve_map 10-90 and 110-190
    ops = [("k1", 10, 30), ("k2", 20, 40), ("Memcpy HtoD", 95, 99),
           ("k1", 120, 150), ("k3", 5, 8)]
    host = [("aten::copy_", 40, 80), ("cudaLaunchKernel", 150, 152),
            (trace.STEP, 0, 100), (trace.STEP, 100, 200),
            (trace.SOLVE_MAP, 10, 90), (trace.SOLVE_MAP, 110, 190)]
    return trace.Profile(device_ops=sorted(ops, key=lambda o: o[1]),
                         steps=[(0, 100), (100, 200)],
                         solve_maps=[(10, 90), (110, 190)],
                         host_ops=sorted(host, key=lambda o: (o[1], -o[2])))


def run_with(profile_=None):
    step = lambda wall, map_s, iters, sizes: dict(
        wall_s=wall, map_s=map_s, calls=[np.asarray(iters)], sizes=sizes)
    sizes = [(7, 7, 8), (4, 5, 4)]
    return trace.TraceRun(
        steps=[step(1.0, 0.8, [10, 20], sizes), step(2.0, 1.5, [40, 5],
                                                      sizes)],
        profiled=[step(1.0, 0.5, [2, 1], sizes)],
        profile=profile_, peaks={"hbm_bytes_per_s": 1e9})


def test_host_clock_readers():
    r = run_with()
    assert host_prep_s.read(r) == pytest.approx((0.2 + 0.5) / 2)
    assert iters_per_step.read(r) == pytest.approx((20 + 40) / 2)
    assert ms_per_iter.read(r) == pytest.approx(1e3 * 2.3 / 60)


def test_device_idle_is_one_minus_the_union():
    r = run_with(profile())
    # busy: 5-8, 10-40, 95-99, 120-150 = 3 + 30 + 4 + 30 = 67 of 200 ns
    assert device_idle.read(r) == pytest.approx(100 * (1 - 67 / 200))


def test_kernels_inside_solve_map_per_iteration():
    r = run_with(profile())
    # k1, k2 (10-90) and k1 (110-190); k3 starts before, the copy is none
    assert kernels_per_iter.read(r) == pytest.approx(3 / 2)


def test_iter_roofline_from_the_lp_bytes():
    r = run_with(profile())
    work = 2 * 288 + 1 * iter_roofline.lane_iteration_bytes(4, 5, 4)
    device_s = (20 + 20 + 30) * 1e-9
    assert iter_roofline.read(r) == pytest.approx(
        100 * (work / 1e9) / device_s)


def test_readers_find_nothing_without_a_profile():
    r = run_with(None)
    for reader in (device_idle, kernels_per_iter, iter_roofline):
        assert reader.read(r) is None


def test_gaps_are_named_by_the_host_op():
    gaps = dict(trace.named_gaps(profile()))
    # idle 0-5, 8-10 (step), 40-95 (aten::copy_ at 67.5), 99-120 (step),
    # 150-200: its middle 175 lies in solve_map with no op open
    assert gaps["aten::copy_"] == pytest.approx(55e-9)
    assert gaps[trace.STEP] == pytest.approx((5 + 2 + 21) * 1e-9)
    assert gaps[trace.SOLVE_MAP] == pytest.approx(50e-9)
    top = trace.top_device_ops(profile())
    assert top[0][0] == "k1" and top[0][1] == pytest.approx(50e-9)
