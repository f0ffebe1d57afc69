"""The port's mesh layer on ``torch.distributed`` against its own unsharded
paths and the reference's mesh paths, on the CPU.

Four gloo ranks run in subprocesses (this file run as a script: xdist
workers share nothing, and a process group is process-wide); the
reference runs in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` set before ``jax``
is imported.  Every input is drawn with numpy from a seed.  The ranks run
every case once (a module fixture), each case's results are held by its
own test.

Tolerances: in the port, ``shard_map``/``pmap`` equal ``vmap`` bit for
bit; the sharded train step (2 x 2) within ``STEP_TOL`` (1e-6) of the
unsharded one (the data axis sums two ranks' gradients where the
unsharded step sums one batch: f32 rounding); the sharded serve step's
greedy tokens equal; checkpoints restore bit for bit.  Against the
reference: the map backends within the conformance standard (1e-5, a
fixed budget), the train steps within ``REF_TOL`` (1e-4, the standard of
``tests/test_torch_train_step.py``), ``compressed_psum``'s mean and residual
within 1e-6 of the largest gradient (the same int8 payloads; XLA fuses
``target - q * scale``, so a residual may differ in its last bits).
"""

import os
import pickle
import subprocess
import sys
import traceback

import numpy as np
import pytest
import torch

WORLD = 4
HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
FIXED_KW = dict(max_iters=120, check_every=40, tol_primal=0.0, tol_gap=0.0)
MAP_TOL = dict(rtol=1e-5, atol=1e-5)
STEP_TOL = 1e-6
REF_TOL = 1e-4
PSUM_TOL = 1e-6
TRAIN_ARCHS = ("llama3_8b", "qwen2_moe_a2_7b")
SERVE_ARCHS = ("llama3_8b", "zamba2_2_7b", "xlstm_350m")
B, S = 4, 8
SERVE_TOKENS = 6
SERVE_TOL = 1e-5
# llama3-8b (reduced: 2 KV heads of 16 dims, 16 cache slots) with its
# cache split over each dim the rules split: (config change, ServeConfig
# options, the placements of a stacked KV leaf [periods, B, Kv, L, hd])
SERVE_LAYOUTS = {
    "kv_heads": ({}, {}, ("Shard(dim=1)", "Shard(dim=2)")),
    "head_dim": ({"n_kv": 1}, {}, ("Shard(dim=1)", "Shard(dim=4)")),
    "seq_on_model": ({}, {"cache_seq_on_model": True},
                     ("Shard(dim=1)", "Shard(dim=3)")),
    "seq_on_data": ({}, {"shard_cache_seq": True},
                    ("Shard(dim=3)", "Shard(dim=2)")),
}
INIT_PERIODS = 16
PSUM_SEED = 5
RUN_TIMEOUT_S = 600


def _env(**extra) -> dict:
    env = dict(os.environ)
    old = env.get("PYTHONPATH")
    env["PYTHONPATH"] = SRC + (os.pathsep + old if old else "")
    env.update(JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1", **extra)
    return env


# ---------------------------------------------------------------------------
# the reference, on a forced 4-device host mesh
# ---------------------------------------------------------------------------

REFERENCE = r"""
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
assert len(jax.devices()) == 4, jax.devices()
B, S, FIXED_KW, PSUM_SEED, ARCHS = pickle.loads(bytes.fromhex(sys.argv[2]))
out = {}

from repro.core import backends as rback, pop as rpop
from repro.problems.cluster_scheduling import GavelProblem, make_cluster_workload
wl = make_cluster_workload(48, num_workers=(6, 6, 6), seed=3)
prob = GavelProblem(wl, space_sharing=False)
ops = rpop.build(prob, rpop.plan(prob, 6, strategy="stratified"))
fields = {f: np.asarray(getattr(ops, f)) for f in ("c", "q", "l", "u",
                                                   "ineq_mask")}
fields["data"] = tuple(np.asarray(a) for a in ops.data)
fields["structured"] = {f: None if v is None else np.asarray(v)
                        for f, v in ops.structured._asdict().items()}
res = rback.solve_map(ops, prob.K_mv, prob.KT_mv, FIXED_KW,
                      backend="shard_map", engine="fused_structured")
out["pop"] = dict(fields=fields, x=np.asarray(res.x), y=np.asarray(res.y),
                  iterations=np.asarray(res.iterations))

from repro.core import compat
from repro.train import compression as comp
mesh = Mesh(np.array(jax.devices()), ("dp",))
G = np.random.default_rng(PSUM_SEED).normal(size=(4, 300)).astype(np.float32)

def f(g, r):
    m, r2 = comp.compressed_psum({"w": g[0]}, {"w": r[0]}, "dp")
    return m["w"][None], r2["w"][None]

fn = jax.jit(compat.shard_map(f, mesh=mesh, in_specs=(P("dp"), P("dp")),
                              out_specs=(P("dp"), P("dp")), check=False))
r = jnp.zeros_like(G)
rounds = []
for i in range(2):
    m, r = fn(jnp.asarray(G * (i + 1)), r)
    rounds.append((np.asarray(m), np.asarray(r)))
out["psum"] = rounds

from repro import configs as rconfigs, models as rmodels
from repro.train import optimizer as ropt
from repro.train.train_step import TrainConfig, jit_train_step
from repro_torch import configs as tconfigs, testing
# Mesh() keeps the axes "Auto" (jax.make_mesh makes them Explicit, which
# the reference's with_sharding_constraint refuses)
mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
for arch in ARCHS:
    rcfg, tcfg = rconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    rp = rmodels.init_params(jax.random.PRNGKey(1), rcfg)
    init = jax.tree.map(np.asarray, rp)
    batches = [{k: jnp.asarray(v.numpy()) for k, v in
                testing.train_batch(tcfg, B, S, seed=s).items()}
               for s in (0, 1)]
    step = jit_train_step(rcfg, TrainConfig(
        n_microbatches=2, compute_dtype="float32",
        adamw=ropt.AdamWConfig(**testing.PARITY_ADAMW)), mesh,
        jax.eval_shape(lambda: rp), jax.eval_shape(lambda: batches[0]))
    ro = ropt.init_state(rp)
    metrics = []
    for b in batches:
        rp, ro, m = step(rp, ro, b)
        metrics.append({k: float(v) for k, v in m.items()})
    out[arch] = dict(init=init, final=jax.tree.map(np.asarray, rp),
                     metrics=metrics)
with open(sys.argv[1], "wb") as fh:
    pickle.dump(out, fh)
"""


# ---------------------------------------------------------------------------
# the port's ranks (this file run as a script)
# ---------------------------------------------------------------------------

def _tree_max_diff(a, b) -> float:
    from repro_torch.models.transformer import leaves
    return max(float((x.detach().float() - y.detach().float()).abs().max())
               for x, y in zip(leaves(a), leaves(b)))


def case_pop(rank, ref):
    """The reference's stacked Gavel lanes (k=6) through shard_map (padded
    to 8 over 4 ranks), pmap over 4 "devices" and vmap; then a Gavel
    session (k=6) through PopService with each backend."""
    from repro_torch import interop, testing
    from repro_torch.core import backends
    from repro_torch.core.config import ExecConfig, SolveConfig
    from repro_torch.domains import GavelInstance
    from repro_torch.problems.cluster_scheduling import (GavelProblem,
                                                         make_cluster_workload)
    ops = interop.operator_from_numpy(ref["pop"]["fields"], device="cpu")
    runs = {}
    for name, opts in (("vmap", {}), ("shard_map", {}),
                       ("pmap", {"devices": ("cpu",) * WORLD})):
        res = backends.solve_map(ops, GavelProblem.K_mv, GavelProblem.KT_mv,
                                 FIXED_KW, backend=name,
                                 engine="fused_structured", **opts)
        runs[name] = {f: getattr(res, f) for f in
                      ("x", "y", "iterations", "converged", "n_restarts")}
    wls = testing.session_workloads(64, (16, 16, 16), churn=0.2,
                                    make_workload=make_cluster_workload)
    sessions = {}
    for name, opts in (("vmap", {}), ("shard_map", {}),
                       ("pmap", {"devices": ("cpu",) * WORLD})):
        from repro_torch.service import PopService
        sess = PopService(device="cpu").session(
            "t", domain="gavel",
            solve=SolveConfig(k=6, strategy="stratified", min_per_sub=8),
            exec=ExecConfig(backend=name, backend_opts=opts))
        sessions[name] = [
            (a.backend, a.alloc, np.asarray(a.raw.iterations)
             if hasattr(a.raw, "iterations") else None, a.plan_cache)
            for a in (sess.step(GavelInstance(wl, job_ids=ids))
                      for wl, ids in wls)]
    # "auto" spreads over the ranks of a mesh the caller hands over, and
    # stays on this rank without one (a process group alone says nothing
    # of what the other ranks call)
    mesh = backends._default_mesh(torch.device("cpu"), "pop")
    auto = {name: backends.resolve_exec(
        ops, GavelProblem.K_mv, GavelProblem.KT_mv, "auto",
        "fused_structured", opts)[0]
        for name, opts in (("mesh", {"mesh": mesh}), ("alone", {}))}
    return dict(solves=runs, sessions=sessions, auto=auto)


def case_psum(rank, ref):
    import torch.distributed as dist
    from repro_torch.train import compression as comp
    G = np.random.default_rng(PSUM_SEED).normal(size=(4, 300)).astype(
        np.float32)
    r = {"w": torch.zeros(300)}
    rounds, local = [], []
    for i in range(2):
        g = {"w": torch.as_tensor(G[rank] * (i + 1))}
        q, s, r_local = comp.compress_with_feedback(g["w"], r["w"])
        local.append((comp.dequantize_int8(q, s, (300,)).numpy(),
                      r_local.numpy()))
        m, r = comp.compressed_psum(g, r, group=None)
        rounds.append((m["w"].numpy(), r["w"].numpy()))
    # every rank's dequantised payload, to rebuild the mean by hand
    deq = [torch.zeros(300) for _ in range(WORLD)]
    dist.all_gather(deq, torch.as_tensor(local[0][0]))
    return dict(rounds=rounds, local=local,
                deq0=[d.numpy() for d in deq])


def case_train(rank, ref):
    from repro_torch import configs as tconfigs, testing
    from repro_torch.interop import params_from_numpy
    from repro_torch.core import placement as pl
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import optimizer as topt
    from repro_torch.train.train_step import (TrainConfig, jit_train_step,
                                              make_train_step)
    mesh = make_host_mesh(model_parallel=2, device="cpu")
    tcfg = TrainConfig(n_microbatches=2, compute_dtype="float32",
                       adamw=topt.AdamWConfig(**testing.PARITY_ADAMW))
    out = {"mesh": tuple(mesh.shape)}
    try:
        jit_train_step(tconfigs.get_reduced("llama3_8b"), tcfg, mesh)
        out["cpu_refused"] = False
    except (RuntimeError, ValueError):
        out["cpu_refused"] = True
    for arch in TRAIN_ARCHS:
        cfg = tconfigs.get_reduced(arch)
        init = ref[arch]["init"]
        batches = [testing.train_batch(cfg, B, S, seed=s) for s in (0, 1)]
        runs = {}
        for name in ("plain", "mesh"):
            p = params_from_numpy(init, cfg, "cpu")
            o = topt.init_state(p)
            step = (make_train_step(cfg, tcfg) if name == "plain" else
                    jit_train_step(cfg, tcfg, mesh, device="cpu"))
            metrics = []
            with testing.router_tie_guard():
                for b in batches:
                    p, o, m = step(p, o, b)
                    metrics.append({k: float(v) for k, v in m.items()})
            if name == "mesh":
                out[arch + "_placements"] = [
                    tuple(repr(x) for x in leaf.placements)
                    for leaf in _leaves(p)]
                p, m_, v_ = (pl.full_tree(p), pl.full_tree(o.m),
                             pl.full_tree(o.v))
            else:
                m_, v_ = o.m, o.v
            runs[name] = dict(params=p, m=m_, v=v_, metrics=metrics)
        from repro_torch.interop import _paths
        out[arch] = dict(
            metrics={k: r["metrics"] for k, r in runs.items()},
            diffs={f: _tree_max_diff(runs["mesh"][f], runs["plain"][f])
                   for f in ("params", "m", "v")},
            final={k: v.numpy() for k, v in
                   _paths(runs["mesh"]["params"]).items()})
    return out


def _leaves(tree):
    from repro_torch.models.transformer import leaves
    return list(leaves(tree))


def _serve_pair(cfg, scfg, mesh, first):
    """SERVE_TOKENS greedy tokens (f32) unsharded and through
    ``jit_serve_step`` on ``mesh`` from the same parameters and first
    token: the tokens and the last step's logits of each, the mesh
    cache's placements, and what the mesh's last step sent over the mesh
    beside its parameter gathers."""
    from repro_torch import models
    from repro_torch.launch.hlo_stats import CollectiveLog, collective_bytes
    from repro_torch.serve.engine import (jit_serve_step, make_serve_step,
                                          place_cache)
    from repro_torch.train.train_step import place_params
    out = {}
    for name in ("plain", "mesh"):
        params = models.init_params(torch.Generator().manual_seed(0), cfg)
        cache = models.init_cache(cfg, B, scfg.max_seq,
                                  kv_dtype=torch.float32, device="cpu")
        if name == "mesh":
            step = jit_serve_step(cfg, scfg, mesh, device="cpu",
                                  with_logits=True)
            params = place_params(params, mesh)
            cache = place_cache(cache, B, mesh, scfg)
        else:
            step = make_serve_step(cfg, scfg, with_logits=True)
        tok, got = first, []
        for i in range(SERVE_TOKENS):
            log = CollectiveLog()
            with log:
                tok, cache, logits = step(params, cache, tok)
            if name == "mesh":
                tok, logits = tok.full_tensor(), logits.full_tensor()
            got.append(tok)
        out[name] = torch.cat(got, dim=1).numpy()
        out[name + "_logits"] = logits.numpy()
        if name == "mesh":
            kv = [leaf for seg in cache["seg_caches"] for c in seg.values()
                  if isinstance(c, tuple) for leaf in c]
            out["cache_placements"] = sorted({
                tuple(repr(x) for x in leaf.placements)
                for leaf in _leaves(cache["seg_caches"])})
            out["kv_bytes"] = sum(t.numel() * t.element_size() for t in kv)
            # each parameter block is gathered whole once a step
            gathered = sum(t.numel() * t.element_size()
                           for t in _leaves(params)
                           if any(p.is_shard() for p in t.placements))
            out["other_collective_bytes"] = \
                collective_bytes(log)["total"] - gathered
    return out


def case_serve(rank, ref):
    """Greedy decode on the 2 x 2 mesh against the unsharded step: each
    of SERVE_ARCHS, then llama3-8b with its cache split each way the
    rules split one (SERVE_LAYOUTS)."""
    import dataclasses

    from repro_torch import configs as tconfigs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve.engine import ServeConfig
    mesh = make_host_mesh(model_parallel=2, device="cpu")
    runs = [(arch, arch, {}, {}) for arch in SERVE_ARCHS] + [
        (name, "llama3_8b", change, opts)
        for name, (change, opts, _) in SERVE_LAYOUTS.items()]
    out = {}
    for name, arch, change, opts in runs:
        cfg = dataclasses.replace(tconfigs.get_reduced(arch), **change)
        scfg = ServeConfig(batch=B, max_seq=16, compute_dtype="float32",
                           **opts)
        first = torch.as_tensor(np.random.default_rng(3).integers(
            0, cfg.vocab, (B, 1)))
        out[name] = _serve_pair(cfg, scfg, mesh, first)
    return out


def case_init(rank, ref):
    """``init_placed_params`` and ``init_placed_state`` on a 1 x 4 mesh:
    the most bytes of tensor storage alive at once while they run, the
    bytes of this rank's blocks and of the largest part drawn whole, and
    whether the parameters equal the whole model's draws."""
    import dataclasses
    import weakref

    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch import configs as tconfigs, models
    from repro_torch.core import placement as pl
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.transformer import _init_block
    from repro_torch.train.train_step import (init_placed_params,
                                              init_placed_state)

    class LiveBytes(TorchDispatchMode):
        """The peak of the storage bytes alive among those the ops in the
        block produced (a storage counts once, however many views)."""

        def __init__(self):
            super().__init__()
            self.live = self.peak = 0
            self.refs = {}

        def _drop(self, key):
            ref = self.refs[key]
            ref[0] -= 1
            if ref[0] == 0:
                self.live -= ref[1]
                del self.refs[key]

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (list, tuple)) else [out]):
                if type(t) is not torch.Tensor:
                    continue
                st = t.untyped_storage()
                key, size = st.data_ptr(), st.nbytes()
                if size == 0:
                    continue
                if key not in self.refs:
                    self.refs[key] = [0, size]
                    self.live += size
                    self.peak = max(self.peak, self.live)
                self.refs[key][0] += 1
                weakref.finalize(t, self._drop, key)
            return out

    mesh = make_host_mesh(model_parallel=WORLD, device="cpu")
    base = tconfigs.get_reduced("llama3_8b")
    (seg,) = base.segments
    cfg = dataclasses.replace(base, segments=(
        dataclasses.replace(seg, n_periods=INIT_PERIODS),))
    with LiveBytes() as meter:
        params = init_placed_params(torch.Generator().manual_seed(4), cfg,
                                    mesh)
        opt = init_placed_state(params)
    local = sum(t._local_tensor.numel() * 4 for tree in
                (params, opt.m, opt.v) for t in _leaves(tree))
    shapes = models.init_params(None, cfg)
    parts = [{k: v} for k, v in shapes.items() if k != "segments"] + [
        {f"b{i}": _init_block(None, cfg, b)
         for i, b in enumerate(seg.period)}]
    largest = max(sum(t.numel() * 4 for t in _leaves(part))
                  for part in parts)
    whole = models.init_params(torch.Generator().manual_seed(4), cfg)
    return dict(
        peak=meter.peak, local=local, largest_part=largest,
        whole_params=sum(t.numel() * 4 for t in _leaves(whole)),
        equal=all(torch.equal(a, b) for a, b in
                  zip(_leaves(pl.full_tree(params)), _leaves(whole))),
        moments_zero=all(not t._local_tensor.any()
                         for tree in (opt.m, opt.v) for t in _leaves(tree)),
        local_shapes=sorted({tuple(t._local_tensor.shape)
                             for t in _leaves(params)}))


def case_checkpoint(rank, ref):
    """Parameters placed on 2 x 2, saved, restored onto 1 x 4, saved again,
    restored unsharded: every leaf bit-equal to the original."""
    import tempfile
    import torch.distributed as dist
    from repro_torch import configs as tconfigs, models
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.train_step import place_params
    cfg = tconfigs.get_reduced("llama3_8b")
    params = models.init_params(torch.Generator().manual_seed(2), cfg)
    m22 = make_host_mesh(model_parallel=2, device="cpu")
    m14 = make_host_mesh(model_parallel=4, device="cpu")
    box = [tempfile.mkdtemp(prefix="mesh_ckpt_") if rank == 0 else None]
    dist.broadcast_object_list(box, src=0)
    ck = Checkpointer(box[0])
    ck.save(1, {"params": place_params(params, m22)}, extras={"step": 1})
    dist.barrier()
    like = {"params": models.init_params(None, cfg)}
    shard14 = {"params": sh.param_shardings(like["params"], m14)}
    on14, extras = ck.restore(1, like, mesh=m14, shardings=shard14)
    local_shapes = sorted({tuple(leaf._local_tensor.shape)
                           for leaf in _leaves(on14)})
    ck.save(2, on14)
    dist.barrier()
    plain, _ = ck.restore(2, {"params": params})
    return dict(
        on14_equal=all(torch.equal(a.full_tensor(), b) for a, b in
                       zip(_leaves(on14), _leaves(params))),
        plain_equal=all(torch.equal(a, b) for a, b in
                        zip(_leaves(plain), _leaves(params))),
        plain_is_dtensor=any(type(a) is not torch.Tensor
                             for a in _leaves(plain)),
        extras=extras, local_shapes=local_shapes)


def case_driver(rank, ref):
    """``launch.train`` for two steps of reduced llama3-8b, unsharded and
    with ``--mesh 1x4`` (state built on the mesh, batches staged on it):
    the losses of each run and the local shapes of the mesh run's
    parameters."""
    from repro_torch.launch import train
    argv = ["--arch", "llama3_8b", "--reduced", "--steps", "2", "--batch",
            "4", "--seq", "8", "--microbatches", "2", "--device", "cpu"]
    out = {}
    for name, extra in (("plain", []), ("mesh", ["--mesh", "1x4"])):
        params, _, m = train.main(argv + extra)
        out[name] = float(m["loss"])
    out["local_shapes"] = sorted({tuple(t._local_tensor.shape)
                                  for t in _leaves(params)})
    return out


CASES = {"pop": case_pop, "psum": case_psum, "train": case_train,
         "serve": case_serve, "checkpoint": case_checkpoint,
         "init": case_init, "driver": case_driver}


def _rank_main(rank: int, store: str, ref_path: str, out_path: str):
    from datetime import timedelta

    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, WORLD),
                            rank=rank, world_size=WORLD,
                            timeout=timedelta(seconds=120))
    with open(ref_path, "rb") as fh:
        ref = pickle.load(fh)
    results = {}
    for name, fn in CASES.items():
        try:
            results[name] = fn(rank, ref)
        except Exception:                  # reported by the case's test
            results[name] = {"error": traceback.format_exc()}
    with open(out_path, "wb") as fh:
        pickle.dump(results, fh)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(reference results, [each rank's results])``."""
    d = tmp_path_factory.mktemp("mesh")
    ref_path = str(d / "ref.pkl")
    args = pickle.dumps((B, S, FIXED_KW, PSUM_SEED, TRAIN_ARCHS)).hex()
    ref = subprocess.run(
        [sys.executable, "-c", REFERENCE, ref_path, args],
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        capture_output=True, text=True, timeout=RUN_TIMEOUT_S)
    assert ref.returncode == 0, ref.stderr[-4000:]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(d / "store"),
         ref_path, str(d / f"rank{r}.pkl")], env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    logs = [p.communicate(timeout=RUN_TIMEOUT_S)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    with open(ref_path, "rb") as fh:
        want = pickle.load(fh)
    got = []
    for r in range(WORLD):
        with open(d / f"rank{r}.pkl", "rb") as fh:
            got.append(pickle.load(fh))
    return want, got


def _case(runs, name):
    ranks = [r[name] for r in runs[1]]
    for r in ranks:
        assert "error" not in r, r.get("error")
    return ranks


# ---------------------------------------------------------------------------
# POP's map backends
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["shard_map", "pmap"])
def test_map_backend_bit_equal_to_vmap(runs, backend):
    """k=6 lanes over 4 ranks (padded to 8): every field bit-equal to
    vmap's on every rank."""
    for r in _case(runs, "pop"):
        want, got = r["solves"]["vmap"], r["solves"][backend]
        for f, v in want.items():
            np.testing.assert_array_equal(got[f], v, err_msg=f)


@pytest.mark.parametrize("backend", ["vmap", "shard_map", "pmap"])
def test_map_backend_matches_reference_shard_map(runs, backend):
    """Each backend within the conformance standard of the reference's
    shard_map on a forced 4-device host mesh (fixed budget)."""
    want = runs[0]["pop"]
    got = _case(runs, "pop")[0]["solves"][backend]
    np.testing.assert_allclose(got["x"], want["x"], **MAP_TOL)
    np.testing.assert_allclose(got["y"], want["y"], **MAP_TOL)
    np.testing.assert_array_equal(got["iterations"], want["iterations"])


@pytest.mark.parametrize("backend", ["shard_map", "pmap"])
def test_gavel_session_backend_bit_equal_to_vmap(runs, backend):
    """A three-step Gavel session (cold, drift, churn) at k=6: the same
    allocations, per-lane iterations and verdicts as vmap's."""
    for r in _case(runs, "pop"):
        for (b, alloc, its, verdict), (_, a0, i0, v0) in zip(
                r["sessions"][backend], r["sessions"]["vmap"]):
            assert b == backend and verdict == v0
            np.testing.assert_array_equal(alloc, a0)
            np.testing.assert_array_equal(its, i0)


def test_auto_selects_shard_map_on_several_ranks(runs):
    """On a mesh of four ranks handed over in the backend opts; without
    one, "auto" stays on this rank's device."""
    for r in _case(runs, "pop"):
        assert r["auto"]["mesh"] == "shard_map"
        assert r["auto"]["alone"] == "vmap"


# ---------------------------------------------------------------------------
# compressed_psum
# ---------------------------------------------------------------------------

def test_compressed_psum_matches_reference(runs):
    """Two rounds (the second carries the first's error feedback); the
    tolerance is PSUM_TOL of the round's largest gradient, the scale of
    ``grad + residual``."""
    want = runs[0]["psum"]
    G = np.random.default_rng(PSUM_SEED).normal(size=(4, 300))
    for rank, r in enumerate(_case(runs, "psum")):
        for i, ((m, res), (wm, wr)) in enumerate(zip(r["rounds"], want)):
            tol = PSUM_TOL * float(np.abs(G * (i + 1)).max())
            np.testing.assert_allclose(m, wm[rank], rtol=0, atol=tol)
            np.testing.assert_allclose(res, wr[rank], rtol=0, atol=tol)


def test_compressed_psum_is_the_mean_of_the_payloads(runs):
    """The mean of every rank's dequantised payload, summed in rank order;
    each rank's residual is its own local error feedback."""
    ranks = _case(runs, "psum")
    deq = ranks[0]["deq0"]
    mean = deq[0]
    for d in deq[1:]:
        mean = mean + d
    mean = mean / np.float32(WORLD)
    for r in ranks:
        np.testing.assert_array_equal(r["rounds"][0][0], mean)
        np.testing.assert_array_equal(r["rounds"][0][1], r["local"][0][1])


# ---------------------------------------------------------------------------
# the sharded train step
# ---------------------------------------------------------------------------

def test_train_mesh_and_cpu_refusal(runs):
    for r in _case(runs, "train"):
        assert r["mesh"] == (2, 2)
        assert r["cpu_refused"]


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_jit_train_step_matches_unsharded(runs, arch):
    for r in _case(runs, "train"):
        got = r[arch]
        for a, b in zip(got["metrics"]["mesh"], got["metrics"]["plain"]):
            assert a["lr"] == b["lr"]
            assert abs(a["loss"] - b["loss"]) <= STEP_TOL
            assert abs(a["grad_norm"] - b["grad_norm"]) <= \
                STEP_TOL * b["grad_norm"]
        for f, d in got["diffs"].items():
            assert d <= STEP_TOL, (f, d)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_jit_train_step_shards_by_param_specs(runs, arch):
    """The matrices are sharded over ``model``, no leaf over ``data``."""
    placements = _case(runs, "train")[0][arch + "_placements"]
    assert any("Shard" in p[1] for p in placements)
    assert all(p[0] == "Replicate()" for p in placements)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_jit_train_step_matches_reference(runs, arch):
    from repro_torch.interop import _paths
    want = runs[0][arch]
    got = _case(runs, "train")[0][arch]
    for a, b in zip(got["metrics"]["mesh"], want["metrics"]):
        assert abs(a["loss"] - b["loss"]) <= REF_TOL
        assert abs(a["grad_norm"] - b["grad_norm"]) <= \
            REF_TOL * b["grad_norm"]
        assert a["lr"] == b["lr"]
    ref = {k: np.asarray(v) for k, v in _paths(want["final"]).items()}
    assert set(ref) == set(got["final"])
    for k, v in ref.items():
        assert float(np.abs(got["final"][k] - v).max()) <= REF_TOL, k


# ---------------------------------------------------------------------------
# the sharded serve step and checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_jit_serve_step_tokens_equal(runs, arch):
    for r in _case(runs, "serve"):
        np.testing.assert_array_equal(r[arch]["mesh"], r[arch]["plain"])
    placements = _case(runs, "serve")[0][arch]["cache_placements"]
    assert any("Shard(dim=1)" in p[0] for p in placements)   # batch on data


@pytest.mark.parametrize("layout", SERVE_LAYOUTS)
def test_jit_serve_step_attends_on_cache_blocks(runs, layout):
    """Attention reads each rank's KV cache block where it lies: equal
    greedy tokens, the last logits within SERVE_TOL (f32; a split head_dim
    or sequence adds partial sums in another order), the cache split as
    the rules say, and a step sends at most a quarter of the KV cache's
    bytes over the mesh beside its parameter gathers (gathering the
    cache's blocks would send at least half)."""
    want_places = SERVE_LAYOUTS[layout][2]
    for r in _case(runs, "serve"):
        got = r[layout]
        np.testing.assert_array_equal(got["mesh"], got["plain"])
        np.testing.assert_allclose(got["mesh_logits"], got["plain_logits"],
                                   rtol=0, atol=SERVE_TOL)
        assert want_places in got["cache_placements"]
        assert 0 < got["other_collective_bytes"] <= got["kv_bytes"] / 4


def test_sharded_init_keeps_blocks_as_it_draws(runs):
    """On a 1 x 4 mesh each rank's peak of live tensor bytes while the
    parameters and AdamW's moments are built stays within its own blocks
    (parameters, m, v) plus twice the largest part drawn whole (a draw
    and its scaled copy): below the whole f32 parameters alone, a third
    of what building the state whole and then placing it would hold.
    The parameters equal the whole model's draws bit for bit."""
    for r in _case(runs, "init"):
        assert r["equal"] and r["moments_zero"]
        assert len(r["local_shapes"]) > 1
        assert r["local"] < 3 * r["whole_params"] / 2
        assert r["peak"] <= r["local"] + 2 * r["largest_part"]
        assert r["peak"] < r["whole_params"]


def test_train_driver_on_a_mesh(runs):
    for r in _case(runs, "driver"):
        assert abs(r["mesh"] - r["plain"]) <= STEP_TOL
        assert len(r["local_shapes"]) > 1


def test_checkpoint_restores_across_meshes(runs):
    for r in _case(runs, "checkpoint"):
        assert r["on14_equal"] and r["plain_equal"]
        assert not r["plain_is_dtensor"]
        assert r["extras"] == {"step": 1}
        assert len(r["local_shapes"]) > 1


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4])
