"""The reference against the port on the CPU at a small size: every
number of a sound run is within its cell's limit, the split replays the
program's plan through churn, the reference's KKT measures agree with the
solver's own, and each lane is judged by what it reports."""

import numpy as np
import pytest
import torch

from popbench_tiny import config, one_thread, run
from popbench.generate import Rounds, load_mix
from popbench.reference import gavel, pdhg
from popbench.reference.lp import kkt


def test_sound_run_is_correct():
    out = run(seconds=1.0)
    res, notes = out["result"], out["notes"]
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] == notes["steps"] >= 1
    assert res["checks"]["split_diff"]["value"] == 0.0
    assert notes["judged"] == res["attempted"]


def session(cfg):
    from popbench.adapters import gavel as adapter
    from popbench.trace import SolveCapture
    from repro_torch.service import PopService
    gen = Rounds(cfg, load_mix("drift"), 7)
    capture = SolveCapture(False)
    svc = PopService(device="cpu")
    solve, exec_ = adapter.configs(cfg)
    fleet = gen.next()
    sess = svc.session("t", adapter.instance(cfg, fleet), domain="gavel",
                       solve=solve, exec=exec_)
    threads = one_thread()
    threads.__enter__()
    try:
        for r in range(7):
            if r:
                fleet = gen.next()
            alloc = sess.step(adapter.instance(cfg, fleet))
            solves = [res for _, res in capture.take()]
            yield fleet, adapter.record(alloc, solves), solves[-1]
    finally:
        capture.close()
        svc.close()
        threads.__exit__(None, None, None)


def test_gavel_split_and_kkt_follow_the_program():
    cfg = config()
    split = gavel.Split(cfg)
    kinds = []
    for fleet, rec, res in session(cfg):
        kinds.append(rec["plan_cache"])
        idx = split.next(fleet)
        assert np.array_equal(idx, rec["split"])
        lp = gavel.Lanes(fleet, idx, cfg)
        prim, gap, p_obj = kkt(lp, torch.as_tensor(rec["x"], dtype=torch.float64),
                                     torch.as_tensor(rec["y"], dtype=torch.float64))
        np.testing.assert_allclose(prim.numpy(), res.primal_res, atol=2e-5)
        np.testing.assert_allclose(gap.numpy(), res.gap, atol=2e-5)
        np.testing.assert_allclose(p_obj.numpy(), res.primal_obj,
                                   rtol=1e-5, atol=1e-6)
        rho = lp.answer(torch.as_tensor(rec["x"], dtype=torch.float64),
                        fleet["ids"].shape[0])
        np.testing.assert_allclose(rho, rec["alloc"], atol=1e-6)
    assert kinds == ["miss", "hit", "hit", "hit", "hit", "repair", "hit"]


def lanes(seed=4):
    cfg = config()
    fleet = Rounds(cfg, load_mix("drift"), seed).next()
    return cfg, fleet, gavel.Lanes(fleet, gavel.Split(cfg).next(fleet), cfg)


def test_lane_optimum_is_the_lps():
    # the exact solution is feasible for the reference's own K, and the
    # plain PDHG's objective closes in on it from above
    cfg, _, lp = lanes()
    x = torch.stack([torch.as_tensor(lp.exact(i).x) for i in range(lp.k)])
    prim, _, p_obj = kkt(lp, x, torch.zeros(lp.q.shape, dtype=x.dtype))
    assert float(prim.max()) < 1e-9
    sol = pdhg.solve(lp, 20000, 1e-6)
    for i in range(lp.k):
        opt = lp.optimum(i)
        assert float(p_obj[i]) == pytest.approx(opt, abs=1e-12)
        assert 0.0 <= float(sol["primal_obj"][i]) - opt < 3e-3 * abs(opt)


def judged(rec, fleet, cfg):
    check = gavel.Check(cfg)
    check.observe(fleet, rec, True)
    return check.worst


def record(lp, x, iters, conv):
    x = x.numpy()
    return dict(split=lp.idx, x=x, y=np.zeros(lp.q.shape),
                primal_obj=(lp.c.numpy() * x).sum(axis=1),
                lane_iters=np.asarray(iters), converged=np.asarray(conv),
                alloc=lp.answer(torch.as_tensor(x), lp.idx.max() + 1),
                metrics=gavel.quality(lp.answer(torch.as_tensor(x),
                                                lp.idx.max() + 1)))


def test_each_lane_is_judged_by_what_it_reports():
    cfg, fleet, lp = lanes()
    cap = cfg["solver"]["max_iters"]
    best = torch.stack([torch.as_tensor(lp.exact(i).x)
                        for i in range(lp.k)])
    x, k = best.clone(), lp.k
    x[k // 2:] = 0.0
    base = [100] * k
    # solved lanes stopped at the cap are held to the optimum: sound ones
    # pass, zeroed ones fall short by their whole objective
    good = judged(record(lp, best, [cap] * k, [False] * k), fleet, cfg)
    assert good["capped_gap_mean"] < 1e-9 and good["unfinished_lanes"] == 0
    bad = judged(record(lp, x, [cap] * k, [False] * k), fleet, cfg)
    assert bad["capped_gap_mean"] == pytest.approx(0.5, abs=1e-6)
    # a lane reported unconverged before the cap was left unsolved
    left = judged(record(lp, x, base[:k // 2] + [0] * (k - k // 2),
                         [True] * (k // 2) + [False] * (k - k // 2)),
                  fleet, cfg)
    assert left["unfinished_lanes"] == k - k // 2
    assert left["capped_gap_mean"] == 0.0
