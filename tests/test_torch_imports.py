"""The port stands alone: ``src/repro_torch``, ``examples_torch/`` and
``chip_smoke.py`` import neither ``jax`` nor the reference package
``repro``; every port module imports in a fresh interpreter without
pulling JAX in; entry points default to the CUDA device and refuse, rather
than fall back, where there is none; ``chip_smoke.py`` fails without a
card and outside the repository."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import domains
from repro_torch.core import pop
from repro_torch.core.problem import LinearProgram
from repro_torch.models.moe import plan_expert_placement
from repro_torch.problems.cluster_scheduling import (GavelProblem,
                                                     make_cluster_workload)
from repro_torch.problems.load_balancing import (LoadBalanceProblem,
                                                 balance_placement,
                                                 make_shard_workload)
from repro_torch.service import PopService
from repro_torch.tuning import build_profile

PKG = Path(next(iter(repro_torch.__path__)))
ROOT = PKG.parents[1]
SMOKE = ROOT / "chip_smoke.py"
EXAMPLES = ROOT / "examples_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _sources():
    return (sorted(PKG.rglob("*.py")) + sorted(EXAMPLES.glob("*.py"))
            + [SMOKE])


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _module_names():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_new_modules_are_checked():
    """The dense and full-problem kernels, the LP containers, the traffic,
    load-balancing and MoE placement domains, the rounding and max-min
    helpers, the shared build, the session checkpoint codec, the page
    store, the fault injectors, the tuner, the LM substrate and configs,
    the serving engine and driver, the scheduler shims, the training
    substrate (optimizer, compression, train step, data pipeline,
    checkpointer, training driver), the mesh layer (placements, mesh,
    shardings, specs, collective statistics, dry run, roofline, flags
    harness) and the example twins are among the sources the import
    checks walk."""
    names = {str(p.relative_to(ROOT)) for p in _sources()}
    for rel in ("kernels/structured_full_pdhg_step.py", "kernels/build.py",
                "kernels/pdhg_matvec.py", "kernels/fused_pdhg_step.py",
                "core/problem.py", "problems/traffic_engineering.py",
                "domains/traffic.py", "testing.py", "interop.py",
                "problems/load_balancing.py", "domains/load_balance.py",
                "core/rounding.py", "core/maxmin.py",
                "checkpoint/__init__.py", "checkpoint/session_state.py",
                "checkpoint/paged.py", "analysis/__init__.py",
                "analysis/faults.py", "tuning/__init__.py",
                "tuning/profile.py", "tuning/slo.py", "tuning/online.py",
                "models/__init__.py", "models/moe.py",
                "domains/moe_placement.py", "models/layers.py",
                "models/attention.py", "models/ssm.py", "models/xlstm.py",
                "models/transformer.py", "configs/__init__.py",
                "configs/llama3_8b.py", "serve/engine.py",
                "launch/serve.py", "sched/elastic.py",
                "sched/gavel_service.py", "train/__init__.py",
                "train/optimizer.py", "train/compression.py",
                "train/train_step.py", "data/__init__.py",
                "data/pipeline.py", "checkpoint/checkpointer.py",
                "launch/train.py", "launch/mesh.py", "launch/shardings.py",
                "launch/specs.py", "launch/hlo_stats.py",
                "launch/dryrun.py", "launch/roofline.py",
                "launch/perf.py", "core/placement.py"):
        assert f"src/repro_torch/{rel}" in names, rel
    for rel in ("examples_torch/serve_balanced.py",
                "examples_torch/schedule_cluster.py",
                "examples_torch/train_e2e.py", "chip_smoke.py"):
        assert rel in names, rel


def test_problem_module_imports_nothing_of_the_package():
    """``core/problem.py`` resolves the default device itself: it imports
    no module of the package (``core/backends.py`` imports it), so the LP
    containers carry no import cycle."""
    tree = ast.parse((PKG / "core" / "problem.py").read_text())
    relative = [node.module for node in ast.walk(tree)
                if isinstance(node, ast.ImportFrom) and node.level > 0]
    absolute = [alias.name for node in ast.walk(tree)
                if isinstance(node, ast.Import) for alias in node.names]
    assert not relative, relative
    assert not any(name.startswith("repro_torch") for name in absolute)


def test_every_module_imports_without_jax():
    code = (
        "import sys\n"
        f"for name in {list(_module_names())!r}:\n"
        "    __import__(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(PKG.parent))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_registered_domains():
    """The three paper domains and MoE placement register on import, load
    balancing with its ``step_override``, MoE placement through the
    declarative hooks alone."""
    assert domains.names() == ("gavel", "load_balance", "moe_placement",
                               "traffic")
    sess = PopService(device="cpu").session("t", domain="load_balance")
    assert sess.spec.step_override is not None
    moe = domains.get("moe_placement")
    assert moe.problem is None and moe.step_override is None
    assert moe.build_sub is not None and moe.quality is not None


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PopService()
    prob = GavelProblem(make_cluster_workload(16, seed=0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pop.solve_instance(prob)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pop.build(prob, pop.plan(prob, 2))
    for full in (pop.solve_full_ex, pop.solve_full):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            full(prob)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LinearProgram.build(c=np.ones(3))
    wl = make_shard_workload(16, 4, seed=0)
    lb = LoadBalanceProblem(wl)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lb._relax_op(np.arange(16), np.arange(4), 16, 4)
    for solve in (lb.solve_full, lambda: lb.pop_solve(2),
                  lambda: balance_placement(wl.load, 4)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            solve()
    moe = domains.make_placement_instance(16, 4, seed=0)
    for entry in (lambda: build_profile(domains=("gavel",)),
                  lambda: domains.place_experts(moe),
                  lambda: plan_expert_placement(moe.load, 4)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()
    assert PopService(device="cpu").device.type == "cpu"


def test_lm_entry_points_default_to_the_card(monkeypatch):
    """The serving and training drivers, the decode cache, the balancer
    shim, the scheduler shim and the example twins resolve the device as
    ``resolve_device`` does: the card by default, a refusal with none."""
    import importlib.util
    import warnings

    from repro_torch import models
    from repro_torch.configs import get_reduced
    from repro_torch.launch import serve
    from repro_torch.sched import GavelScheduler, SchedulerConfig
    from repro_torch.serve import balance_requests
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    entries = [lambda: serve.main(["--reduced", "--tokens", "1"]),
               lambda: models.init_cache(get_reduced("llama3_8b"), 1, 8),
               lambda: balance_requests(np.ones(8), 2),
               lambda: GavelScheduler(SchedulerConfig())]
    from repro_torch.launch import train
    entries.append(lambda: train.main(["--reduced", "--steps", "1"]))
    for name, argv in (("serve_balanced", ["--fast"]),
                       ("schedule_cluster", ["--fast"]),
                       ("train_e2e", ["--steps", "2"])):
        spec = importlib.util.spec_from_file_location(
            f"{name}_twin", EXAMPLES / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        entries.append(lambda mod=mod, argv=argv: mod.main(argv))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        for entry in entries:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                entry()


def test_chip_smoke_fails_without_card_or_outside_repo(tmp_path):
    """Run here, where there is no CUDA device: no result, nonzero exit;
    alone in a directory, the same."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(SMOKE, alone)
    procs = [subprocess.Popen([sys.executable, str(script)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, cwd=script.parent)
             for script in (SMOKE, alone)]
    for proc in procs:
        out, _ = proc.communicate(timeout=120)
        assert proc.returncode != 0
        assert out == ""


def test_mesh_entry_points_default_to_the_card(monkeypatch):
    """The mesh layer resolves the device as ``resolve_device`` does:
    ``make_host_mesh``/``make_production_mesh``, ``jit_train_step`` and
    ``jit_serve_step`` (whose mesh must lie on the card unless the caller
    names its device), the map backends' default mesh and both drivers'
    ``--mesh`` refuse without a card, before any process group starts."""
    import torch.distributed as dist

    from repro_torch.configs import get_reduced
    from repro_torch.core import backends
    from repro_torch.launch import serve, train
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    from repro_torch.serve.engine import ServeConfig, jit_serve_step
    from repro_torch.train.train_step import TrainConfig, jit_train_step
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    started = dist.is_initialized()

    class CpuMesh:
        device_type = "cpu"
    cfg = get_reduced("llama3_8b")
    for entry in (make_host_mesh, make_production_mesh,
                  lambda: jit_train_step(cfg, TrainConfig(), CpuMesh()),
                  lambda: jit_serve_step(cfg, ServeConfig(1, 8), CpuMesh()),
                  lambda: backends._default_mesh(None, "pop"),
                  lambda: train.main(["--reduced", "--mesh", "1x1"]),
                  lambda: serve.main(["--reduced", "--mesh", "1x1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()
    assert dist.is_initialized() == started
