"""The port's public surface, on the CPU: a fresh render of
``scripts/api_surface_torch.py`` equals the committed snapshot
(``docs/api_surface_torch.txt``); every name of the reference's
``docs/api_surface.txt`` resolves in ``repro_torch`` but for the listed
known differences; the doors the surface repair added (``pop_solve``,
``solve_one``, ``make_map_solver``, ``available_backends``, the
``repro_torch.core`` re-exports, ``serve.jit_serve_step``) behave as the
reference's; and ``examples_torch/quickstart.py`` runs, its flows matching
the reference's same calls."""

import difflib
import importlib
import importlib.util
import os
import re
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as ref_core
from repro.core import pdhg as rpdhg
from repro.core.problem import LinearProgram as RefLP
from repro.problems import traffic_engineering as rte
from repro.service import PopService as RefPopService
import repro_torch.core as core
from repro_torch import testing
from repro_torch.core import ExecConfig, SolveConfig, backends, pdhg, pop
from repro_torch.core.problem import LinearProgram
from repro_torch.problems.cluster_scheduling import (GavelProblem,
                                                     make_cluster_workload)

REPO = Path(__file__).resolve().parent.parent
QUICKSTART = REPO / "examples_torch" / "quickstart.py"

# names of the reference's surface the port does not have, and why
KNOWN_DIFFERENCES = {
    "repro_torch.core.LinearProgram.tree_flatten":
        "a JAX pytree hook; the port's LinearProgram is a plain dataclass "
        "of tensors",
    "repro_torch.core.LinearProgram.tree_unflatten":
        "a JAX pytree hook (see tree_flatten)",
}
FLOW_RTOL = 1e-3


def _load_renderer():
    spec = importlib.util.spec_from_file_location(
        "api_surface_torch", REPO / "scripts" / "api_surface_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_api_surface_matches_snapshot():
    fresh = _load_renderer().render()
    committed = (REPO / "docs" / "api_surface_torch.txt").read_text()
    if fresh != committed:
        diff = "\n".join(difflib.unified_diff(
            committed.splitlines(), fresh.splitlines(),
            "docs/api_surface_torch.txt (committed)", "fresh render",
            lineterm=""))
        raise AssertionError(
            "the port's public API surface drifted from the committed "
            "snapshot.\nIf intentional: run `scripts/api_surface_torch.py "
            "--write` and commit the diff.\n" + diff)


def _reference_names():
    """Every qualified name of the reference's snapshot, under the port's
    package name."""
    names = []
    for ln in (REPO / "docs" / "api_surface.txt").read_text().splitlines():
        ln = ln.strip()
        if not ln or ln.startswith(("#", "==")):
            continue
        ln = ln.removeprefix("class ")
        names.append(re.match(r"[\w.]+", ln).group(0))
    return [n.replace("repro.", "repro_torch.", 1) for n in names]


def _resolves(name: str) -> bool:
    parts = name.split(".")
    for cut in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:cut]))
        except ImportError:
            continue
        try:
            for attr in parts[cut:]:
                obj = getattr(obj, attr)
        except AttributeError:
            return False
        return True
    return False


def test_every_reference_name_resolves_in_the_port():
    names = _reference_names()
    assert len(names) == 222
    missing = sorted(n for n in names if not _resolves(n))
    assert missing == sorted(KNOWN_DIFFERENCES)


def test_core_reexports_the_reference_surface():
    assert core.__all__ == ref_core.__all__
    for name in core.__all__:
        assert getattr(core, name) is not None, name
    assert core.available_backends() == tuple(backends.MAP_BACKENDS)
    assert set(core.available_backends()) == set(
        ref_core.available_backends())
    from repro_torch.serve import engine, jit_serve_step
    assert jit_serve_step is engine.jit_serve_step


def test_snapshot_covers_the_surface():
    text = (REPO / "docs" / "api_surface_torch.txt").read_text()
    for needle in ("repro_torch.service.PopService", "PopSession.step",
                   "repro_torch.domains.register",
                   "repro_torch.core.config.SolveConfig",
                   "repro_torch.core.solve_instance",
                   "repro_torch.core.pop_solve",
                   "repro_torch.core.make_map_solver",
                   "repro_torch.serve.jit_serve_step"):
        assert needle in text, needle


def test_pop_solve_warns_and_is_bit_identical_to_solve_instance():
    prob = GavelProblem(make_cluster_workload(48, seed=3))
    kw = dict(max_iters=400, tol_primal=1e-4, tol_gap=1e-4)
    with pytest.warns(DeprecationWarning, match="pop_solve"):
        got = pop.pop_solve(prob, 2, solver_kw=kw, device="cpu")
    # pop_solve's default strategy is 'random' (SolveConfig's is
    # 'stratified')
    want = pop.solve_instance(prob, SolveConfig(k=2, strategy="random"),
                              ExecConfig(solver_kw=kw), device="cpu")
    assert np.array_equal(got.alloc, want.alloc)
    assert np.array_equal(got.x, want.x) and np.array_equal(got.y, want.y)
    assert np.array_equal(got.idx, want.idx)
    assert (got.backend, got.engine) == (want.backend, want.engine)


def test_solve_one_matches_reference():
    """One dense LP through each package's ``solve_one`` at a fixed
    iteration budget: the iterates agree within 1e-5 (the conformance
    standard)."""
    ((c, G, h),) = testing.random_dense_lps(1, 40, 20, seed=4)
    box = dict(l=np.zeros(40), u=np.ones(40))
    kw = dict(max_iters=200, tol_primal=0.0, tol_gap=0.0)
    got = core.solve_one(pdhg.dense_ops(LinearProgram.build(
        c=c, G=G, h=h, device="cpu", **box)), pdhg.dense_K_mv,
        pdhg.dense_KT_mv, kw)
    want = ref_core.solve_one(rpdhg.dense_ops(RefLP.build(c=c, G=G, h=h,
                                                          **box)),
                              rpdhg.dense_K_mv, rpdhg.dense_KT_mv, kw)
    assert got.x.shape == np.asarray(want.x).shape
    assert int(got.iterations) == int(want.iterations) == 200
    np.testing.assert_allclose(got.x, np.asarray(want.x), atol=1e-5)
    np.testing.assert_allclose(got.y, np.asarray(want.y), atol=1e-5)
    np.testing.assert_allclose(got.primal_obj, float(want.primal_obj),
                               rtol=1e-5, atol=1e-5)


def test_make_map_solver_is_cached_on_equal_keys():
    kw = {"max_iters": 50, "tol_gap": 1e-3}
    a = backends.make_map_solver(pdhg.dense_K_mv, pdhg.dense_KT_mv, kw)
    b = backends.make_map_solver(pdhg.dense_K_mv, pdhg.dense_KT_mv,
                                 {"tol_gap": 1e-3, "max_iters": 50})
    c = backends.make_map_solver(pdhg.dense_K_mv, pdhg.dense_KT_mv,
                                 {"max_iters": 51, "tol_gap": 1e-3})
    assert a is b and a is not c
    with pytest.raises(ValueError, match="unresolved engine"):
        backends.make_map_solver(pdhg.dense_K_mv, pdhg.dense_KT_mv, kw,
                                 engine="fused")
    # the solver runs the batch it is given, as the map backends do
    ops = testing.dense_stack(testing.random_dense_lps(2, 16, 8, seed=1),
                              "cpu")
    batch = backends.make_batch(ops)
    res = a(batch)
    want = backends.get_backend("vmap")(batch, pdhg.dense_K_mv,
                                        pdhg.dense_KT_mv, kw)
    assert np.array_equal(res.x, want.x)


def _fast_instance(make):
    topo = make.make_topology(n_nodes=60, target_edges=140, seed=0)
    pairs, demand = make.make_demands(topo, 600, seed=1)
    paths = make.k_shortest_paths(topo, pairs, n_paths=4, max_len=32, seed=2)
    return make.TrafficProblem(topo, pairs, demand, paths)


def _flows(text: str) -> dict:
    out = {}
    for ln in text.splitlines():
        m = re.match(r"(full LP|POP-4 |POP-16)\s*: flow=\s*([\d.]+)", ln)
        if m:
            out[m.group(1).strip()] = float(m.group(2))
    return out


def test_quickstart_fast_matches_reference():
    """``examples_torch/quickstart.py --fast --device cpu`` in a child
    process prints every line, the full LP and POP-4/POP-16 flows within
    1e-3 relative of the reference's same calls at that size (run here,
    in-process)."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, str(QUICKSTART), "--fast",
                           "--device", "cpu"], capture_output=True,
                          text=True, timeout=600, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    for tag in ("full LP", "POP-4", "POP-16", "warm re-tick", "CSPF",
                "POP-16 skew", "MoE place"):
        assert tag in proc.stdout, (tag, proc.stdout)
    assert "plan_cache=hit" in proc.stdout
    got = _flows(proc.stdout)

    prob = _fast_instance(rte)
    exec_cfg = ref_core.ExecConfig(solver_kw=dict(
        max_iters=2_000, tol_primal=1e-4, tol_gap=1e-4))
    fr = ref_core.pop.solve_full_ex(prob, exec_cfg=exec_cfg)
    want = {"full LP": prob.evaluate(fr.alloc)["total_flow"]}
    service = RefPopService()
    for k in (4, 16):
        r = service.session(f"net-k{k}", prob, solve=ref_core.SolveConfig(
            k=k, strategy="random"), exec=exec_cfg).step(prob)
        want[f"POP-{k}"] = r.metrics["total_flow"]
    assert set(got) == set(want)
    for name, flow in want.items():
        # the printed flow has one decimal
        assert abs(got[name] - flow) <= FLOW_RTOL * flow + 0.05, \
            (name, got[name], flow)


def test_quickstart_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = importlib.util.spec_from_file_location("quickstart_twin",
                                                  QUICKSTART)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main(["--fast"])
