"""The domain registry's declarative style and the MoE expert placement
domain of the port (``repro_torch.domains.moe_placement``,
``repro_torch.models.moe``) against the reference's.

The first half twins ``tests/test_domains.py``'s ``TestRegistry``, its
matvec-identity test and ``TestMoEPlacement`` on the port at
``device="cpu"``; the gate-load test builds its router weight with numpy.
The second half puts the same inputs
through both packages: the sub-LP arrays bit for bit (f32), ``_evaluate``
and ``_round`` on one allocation, ``place_experts`` at a fixed budget
(served, objective and moves within 1e-3, the same placement), the warm
chain's plan-cache verdicts and warm fractions, and ``expert_gate_load``
in f32 within 1e-5."""

import dataclasses

import numpy as np
import pytest

from repro.core import ExecConfig as RefExecConfig
from repro.core import SolveConfig as RefSolveConfig
from repro.domains import moe_placement as rmoe
from repro.models import moe as rmodels_moe
from repro.service import PopService as RefPopService
from repro_torch.core import pdhg as tpdhg
from repro_torch.core.config import ExecConfig, SolveConfig
from repro_torch.domains import (DomainSpec, SpecProblem, greedy_placement,
                                 make_placement_instance, place_experts,
                                 register, registry)
from repro_torch.domains import moe_placement as tmoe
from repro_torch.domains.moe_placement import SPEC as MOE_SPEC, _evaluate
from repro_torch.models.moe import expert_gate_load, plan_expert_placement
from repro_torch.problems import load_balancing as tlb
from repro_torch.service import PopService

KW = dict(max_iters=250, tol_primal=1e-4, tol_gap=1e-4)
CPU = "cpu"
# a fixed budget both packages run to the end (tolerances 0)
FIXED_KW = dict(max_iters=300, tol_primal=0.0, tol_gap=0.0)
PLACE_TOL = 1e-3
GATE_TOL = 1e-5
# experts whose two best LP values lie within 1e-5 in either package may
# round to another device; none did at the sizes below
KNOWN_TIES: dict = {}


def _place(inst, **kw):
    return place_experts(inst, device=CPU, **kw)


# ---------------------------------------------------------------------------
# registry mechanics
# ---------------------------------------------------------------------------

class TestRegistry:
    def test_builtins_registered(self):
        assert registry.names() == ("gavel", "load_balance", "moe_placement",
                                    "traffic")
        for name in registry.names():
            assert registry.get(name).name == name

    def test_unknown_and_duplicate(self):
        with pytest.raises(KeyError, match="unknown domain"):
            registry.get("warp_drive")
        with pytest.raises(ValueError, match="already registered"):
            register(registry.get("gavel"))
        register(registry.get("gavel"), replace=True)

    def test_spec_for_infers_from_type(self):
        inst = make_placement_instance(16, 4)
        assert registry.spec_for(inst).name == "moe_placement"
        assert registry.spec_for(object()) is None

    def test_declarative_spec_requires_hooks(self):
        with pytest.raises(ValueError, match="missing"):
            DomainSpec(name="hollow")
        DomainSpec(name="ok", problem=lambda inst: inst)


def test_spec_problem_adapter_shares_matvec_identity():
    """SpecProblem exposes the SPEC's matvecs (one function object per
    domain, load balancing's own) so every instance shares the memoized
    matvec engine."""
    a = SpecProblem(MOE_SPEC, make_placement_instance(16, 4, seed=0))
    b = SpecProblem(MOE_SPEC, make_placement_instance(24, 4, seed=1))
    assert a.K_mv is b.K_mv and a.KT_mv is b.KT_mv
    assert a.K_mv is tlb._k_mv and a.KT_mv is tlb._kt_mv
    assert a.K_mv.preferred_engine == "matvec"
    assert tpdhg.matvec_engine(a.K_mv, a.KT_mv) is \
        tpdhg.matvec_engine(b.K_mv, b.KT_mv)
    assert a.n_entities == 16 and b.n_entities == 24
    assert a.entity_attrs().shape == (16, 2)
    assert a.entity_scores().shape == (16,)


# ---------------------------------------------------------------------------
# MoE placement: the reference's acceptance row, on the port
# ---------------------------------------------------------------------------

class TestMoEPlacement:
    def test_pop_within_1p5pct_of_full_at_k4(self):
        inst = make_placement_instance(128, 8, seed=0)
        _, _, ev_full = _place(inst, solve_cfg=SolveConfig(k=1))
        for k in (4, 8):
            _, res, ev = _place(
                inst, solve_cfg=SolveConfig(k=k, strategy="stratified"))
            assert ev["objective"] >= 0.985 * ev_full["objective"], (k, ev)
            assert ev["mem_feasible"]
        assert res.engine == "matvec"

    def test_pop_beats_greedy(self):
        inst = make_placement_instance(128, 8, seed=1)
        _, _, ev = _place(inst, solve_cfg=SolveConfig(k=4))
        ev_g = _evaluate(inst, greedy_placement(inst))
        assert ev["objective"] > ev_g["objective"]
        assert ev["n_moved"] < 0.5 * ev_g["n_moved"]

    def test_session_warm_chain_with_expert_churn(self):
        allocs = _warm_chain(PopService(device=CPU), ExecConfig, tmoe)
        a1, a2, a3 = allocs
        assert a1.plan_cache == "miss" and a1.k == 4
        assert a2.plan_cache == "hit" and a2.warm_fraction == 1.0
        assert a3.plan_cache == "repair"
        assert 0.7 < a3.warm_fraction < 1.0

    def test_rounding_respects_memory(self):
        inst = make_placement_instance(48, 6, seed=4)
        inst.cap = np.full(6, 1.3 * inst.mem.sum() / 6)
        placement, _, ev = _place(inst, solve_cfg=SolveConfig(k=4),
                                  exec_cfg=ExecConfig(solver_kw=KW))
        assert ev["mem_feasible"]
        assert placement.shape == (48,)
        assert placement.min() >= 0 and placement.max() < 6

    def test_gate_load_feeds_demand_vector(self):
        p, x = _router_inputs(d=16, n_experts=8, batch=2, seq=12)
        load = expert_gate_load(p, x, top_k=2, device=CPU)
        assert load.shape == (8,)
        assert load.min() >= 0
        np.testing.assert_allclose(load.sum(), 2 * 12, rtol=1e-4)

    def test_plan_expert_placement_improves_the_current_placement(self):
        """``plan_expert_placement`` over a gate-load vector: every expert
        on a device in range, more load served than the current placement
        and fewer experts moved than the greedy placement moves."""
        load, inst = _gate_instance()
        placement = plan_expert_placement(load, 8, device=CPU)
        assert placement.shape == (64,)
        assert placement.min() >= 0 and placement.max() < 8
        ev = _evaluate(inst, placement)
        assert ev["mem_feasible"]
        assert ev["served"] > _evaluate(inst, inst.current)["served"]
        assert ev["n_moved"] < _evaluate(inst, greedy_placement(inst))[
            "n_moved"]


# ---------------------------------------------------------------------------
# cross-package
# ---------------------------------------------------------------------------

def _router_inputs(d, n_experts, batch, seq, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    router = (rng.standard_normal((d, n_experts)) / np.sqrt(d)).astype(dtype)
    x = rng.standard_normal((batch, seq, d)).astype(dtype)
    return {"router": router}, x


def _gate_instance():
    """A 64-expert gate-load vector on 8 devices and the instance
    ``plan_expert_placement`` builds from it."""
    p, x = _router_inputs(d=32, n_experts=64, batch=4, seq=64)
    load = expert_gate_load(p, x, top_k=4, device=CPU)
    inst = tmoe.MoEPlacementInstance(
        load=load, mem=np.ones(64), current=np.arange(64) % 8,
        cap=np.full(8, 16.0), compute=np.full(8, load.sum() / 8))
    return load, inst


def _warm_chain(svc, exec_cls, mod):
    """The reference test's chain: cold, +3% drift, 6 experts churned."""
    inst = mod.make_placement_instance(64, 8, seed=2)
    inst.ids = np.arange(64)
    sess = svc.session("moe", inst, exec=exec_cls(solver_kw=KW))
    a1 = sess.step(inst)
    inst2 = dataclasses.replace(inst, load=inst.load * 1.03)
    a2 = sess.step(inst2)
    keep = np.arange(6, 64)
    rng = np.random.default_rng(3)
    inst3 = dataclasses.replace(
        inst,
        load=np.concatenate([inst2.load[keep], rng.uniform(1, 4, 6)]),
        mem=np.concatenate([inst.mem[keep], rng.uniform(0.8, 1.2, 6)]),
        current=np.concatenate([a2.alloc[keep], rng.integers(0, 8, 6)]),
        ids=np.concatenate([inst.ids[keep], 100 + np.arange(6)]))
    return [a1, a2, sess.step(inst3)]


@pytest.mark.parametrize("n,d,seed", [(64, 8, 0), (50, 6, 3)])
def test_instances_and_sub_lps_equal(n, d, seed):
    """The same draw, and every field of a padded sub-LP (with a
    replication scale) bit for bit in f32."""
    a = tmoe.make_placement_instance(n, d, seed=seed)
    b = rmoe.make_placement_instance(n, d, seed=seed)
    for f in ("load", "mem", "current", "cap", "compute"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    idx = np.concatenate([np.arange(0, n, 3), [-1, -1]])
    scale = np.where(idx >= 0, 0.5, 0.0)
    for sc in (None, scale):
        mine = tmoe._build_sub(a, idx, 0.25, sc)
        ref = rmoe._build_sub(b, idx, 0.25, sc)
        for f in ("c", "q", "l", "u", "ineq_mask"):
            got, want = getattr(mine, f).numpy(), np.asarray(getattr(ref, f))
            assert got.dtype == want.dtype, f
            np.testing.assert_array_equal(got, want, err_msg=f)
        for got, want in zip(mine.data, ref.data):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    la, lb = tmoe._sub_layout(a, 7), rmoe._sub_layout(b, 7)
    for f in ("x_slot", "y_slot", "x_global", "y_global"):
        np.testing.assert_array_equal(getattr(la, f), getattr(lb, f))


def test_round_and_evaluate_equal():
    """One fractional allocation (with near ties and unserved experts)
    through both packages' rounding and metrics."""
    inst = tmoe.make_placement_instance(96, 8, seed=5)
    rinst = rmoe.make_placement_instance(96, 8, seed=5)
    rng = np.random.default_rng(1)
    r = rng.dirichlet(np.ones(8), 96) * rng.uniform(0, 1, (96, 1))
    r[:10] = 0.0
    pick = tmoe._round(inst, r)
    np.testing.assert_array_equal(pick, rmoe._round(rinst, r))
    for placement in (pick, greedy_placement(inst), inst.current):
        assert tmoe._evaluate(inst, placement) == \
            rmoe._evaluate(rinst, placement)
    np.testing.assert_array_equal(greedy_placement(inst),
                                  rmoe.greedy_placement(rinst))


@pytest.mark.parametrize("k", [1, 4])
def test_place_experts_matches_reference(k):
    """A fixed budget through both packages' place_experts: served,
    objective and n_moved within PLACE_TOL; the same placement except
    experts named in KNOWN_TIES."""
    inst = tmoe.make_placement_instance(128, 8, seed=0)
    rinst = rmoe.make_placement_instance(128, 8, seed=0)
    solve = dict(k=k, strategy="stratified")
    a, res, ev = _place(inst, solve_cfg=SolveConfig(**solve),
                        exec_cfg=ExecConfig(solver_kw=FIXED_KW))
    b, rres, rev = rmoe.place_experts(
        rinst, solve_cfg=RefSolveConfig(**solve),
        exec_cfg=RefExecConfig(solver_kw=FIXED_KW))
    assert res.engine == rres.engine == "matvec"
    for key in ("served", "objective", "n_moved"):
        assert abs(ev[key] - rev[key]) < PLACE_TOL, (key, ev[key], rev[key])
    differ = set(np.flatnonzero(a != b).tolist())
    assert differ <= set(KNOWN_TIES.get(k, ())), sorted(differ)


def test_warm_chain_matches_reference():
    """The reference test's warm chain through both services: the same
    verdicts, k and warm fractions, and the same served load."""
    mine = _warm_chain(PopService(device=CPU), ExecConfig, tmoe)
    ref = _warm_chain(RefPopService(), RefExecConfig, rmoe)
    for a, b in zip(mine, ref):
        assert a.plan_cache == b.plan_cache
        assert a.k == b.k
        assert a.warm_fraction == b.warm_fraction
        assert abs(a.metrics["served"] - b.metrics["served"]) < PLACE_TOL


def test_gate_load_matches_reference():
    """expert_gate_load in f32, the same router weight and activations in
    both packages, within GATE_TOL."""
    import jax.numpy as jnp
    p, x = _router_inputs(d=64, n_experts=32, batch=3, seq=40, seed=2)
    mine = expert_gate_load(p, x, top_k=4, device=CPU)
    ref = rmodels_moe.expert_gate_load({"router": jnp.asarray(p["router"])},
                                       jnp.asarray(x), top_k=4)
    assert mine.dtype == np.float64
    np.testing.assert_allclose(mine, ref, rtol=GATE_TOL, atol=GATE_TOL)
    np.testing.assert_allclose(mine.sum(), 3 * 40, rtol=1e-5)


def test_plan_expert_placement_matches_reference():
    """The same gate-load vector through both packages'
    ``plan_expert_placement``: the same placement.  Neither serves the
    greedy placement's load here (the reference's own trade: the migration
    penalty keeps 54 of 64 experts in place where the greedy moves 57);
    the smoke's ``moe`` phase prints the same comparison on the card."""
    load, inst = _gate_instance()
    mine = plan_expert_placement(load, 8, device=CPU)
    ref = rmodels_moe.plan_expert_placement(load, 8)
    np.testing.assert_array_equal(mine, ref)
    ev, ev_g = _evaluate(inst, mine), _evaluate(inst, greedy_placement(inst))
    assert ev["n_moved"] == 10 and ev_g["n_moved"] == 57
    assert ev["served"] < ev_g["served"]
    assert ev["objective"] > ev_g["objective"]
