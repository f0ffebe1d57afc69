"""The comparison fails what it must: the control (the reference in the
program's place, a precision below the configuration's) and each fault a
one-card cell can have come out not correct under the cell's limits.  The
card's readings at the cell's size are ``popbench/control.py``'s; these
are the same runs at a size the host holds (the faults skip the harness's
look for a card and drive the rest of a run)."""

import json

import pytest

from popbench_tiny import CELL, ROOT, config, one_thread, run
from popbench import control


def limits():
    return json.loads((ROOT / "popbench" / "limits" /
                       f"{CELL}.json").read_text())


def over(readings):
    lim = limits()
    return sorted(n for n, v in readings.items() if not v <= lim[n])


def test_control_is_not_correct():
    cfg = config()
    cfg["solver"] = dict(cfg["solver"], max_iters=2000)
    with one_thread():
        readings = control.control_reading(CELL, cfg, 2**31 + 9, 2, "cpu")
    assert over(readings), readings
    assert readings["split_diff"] == 0.0


# the number each fault has to fail, beside any other
CATCHES = {"stale": "answer_gap", "half": "unfinished_lanes",
           "half_capped": "capped_gap_mean", "half_converged": "lane_kkt",
           "altered": "answer_gap"}


@pytest.mark.parametrize("fault", control.FAULTS)
def test_fault_is_not_correct(fault):
    from repro_torch.core import backends
    orig = backends.solve_map
    try:
        out = run(seconds=0.5,
                  hooks=control.plant(fault, config()["solver"]["max_iters"]))
    finally:
        backends.solve_map = orig
    res = out["result"]
    assert not res["correct"], res["checks"]
    assert CATCHES[fault] in over(
        {n: c["value"] for n, c in res["checks"].items()}), res["checks"]
