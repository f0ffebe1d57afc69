#!/usr/bin/env python3
"""The port's multi-device paths across the four cards of one host, over
NCCL, through the normal entry points.

    python3 tools/across_cards.py [--deadline SECONDS]

It refuses to start with fewer than four cards (it never falls back to
gloo or to one card).  It builds the lane kernels once, then starts four
ranks, one per card, as ``python -m torch.distributed.run
--nproc_per_node 4`` would: this file again with ``--rank``, and
``RANK``/``LOCAL_RANK``/``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT`` in
the environment.  Each rank takes card ``LOCAL_RANK`` and joins an NCCL
group with a timeout.  A rank still running at the deadline is killed,
and so are the others once one has failed; every rank's log is printed.
Phases, in each rank:

cards-pop    the main path's Gavel session (16,384 jobs on 12,288
             accelerators, the ``gavel`` defaults: k=8, stratified,
             equilibrate; cold, a +-3% drift, 5% churn) through
             ``PopService`` with ``backend="shard_map"`` on the default
             mesh over the four ranks (2 lanes a rank, the default
             ``chunk``), then again at ``chunk=1``.  The lane kernels'
             launches are counted on every rank, and each rank's lane slice
             is held against the plain versions;
cards-serve  llama3-8b at full width in bf16 (batch 8, a 2,048-slot cache,
             a 16-token prompt, 16 steps).  Rank 0 runs the world of one on
             card 0 first.  Then the four ranks run the (1, 4) mesh through
             ``launch.serve``'s parameters and ``jit_serve_step``,
             teacher-forced with the world of one's tokens (ms a step from
             CUDA events, each rank's ``max_memory_allocated``; one more
             step under the profiler: kernels, device time, NCCL's part),
             and last ``launch.serve --mesh 1x4`` itself;
cards-train  llama3-8b cut to 8 layers through ``launch.train`` on card 0
             alone (bf16, then f32; 2 steps of 8 x 1,024 tokens, 2
             microbatches), then on ``--mesh 1x4`` (bf16); then llama3-8b
             at all 32 layers on ``--mesh 1x4``, 4 steps and a fifth under
             the profiler.  Each step is timed with CUDA events, and each
             rank's ``max_memory_allocated`` is read;
cards-ckpt   llama3-8b cut to 2 layers in f32 through ``launch.train
             --mesh 1x4 --ckpt-dir``: 4 steps with a checkpoint after step
             2 (written whole by rank 0), then a run that restores it onto
             the mesh and takes step 3 again.

Then, in this process once the ranks are gone, comes cards-pop's
one-process half: the same session through ``vmap`` on card 0 and
through ``pmap`` over its default devices (``cuda:0`` to ``cuda:3``).
Last come the checks:

- each ``shard_map`` and ``pmap`` step's allocation and per-lane
  iterations are bit-equal to ``vmap``'s;
- every split serving step's logits lie within its
  ``testing.bf16_logit_tol``, and a rank's peak is at most 0.35 of the
  world of one's;
- every 32-layer loss is finite;
- the 8-layer split step is within ``bf16_logit_tol`` of the one-card
  step;
- the restored step is bit-equal.

Every printed number stands beside the cards' names and power limits.
The ranks' logs are written under ``chiprun_out/across_cards/``, and
their reports and the checkpoint under ``build/across_cards/`` (the
checkpoint, about 18 GB, is deleted).  The script exits non-zero if any
check fails.  ``tests/test_torch_across_cards.py`` rehearses the rank
bodies on four gloo processes on the CPU at reduced sizes.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import os
import shutil
import socket
import subprocess
import sys
import time
import traceback
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"
LOGS = ROOT / "chiprun_out" / "across_cards"
WORK = ROOT / "build" / "across_cards"
WORLD = 4
# a collective not matched on every rank hangs: NCCL's watchdog ends it
# after this long (the longest wait is rank 0's one-card runs, about a
# minute)
PG_TIMEOUT_S = 300
DEADLINE_S = 1500
# a failed rank leaves the others inside a collective: they are killed
# this long after it
GRACE_S = 30

# cards-pop: the main path's session
N_JOBS, NUM_WORKERS, CHURN = 16_384, (4096, 4096, 4096), 0.05
SHARD_RUNS = (("shard_map", {}), ("shard_map chunk=1", {"chunk": 1}))
# cards-serve: a rank's peak against the world of one's (a quarter of the
# weights and of the cache, plus activations)
SERVE_PEAK_SHARE = 0.35
# cards-train
TRAIN_ARCH = "llama3_8b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO = 8, 1024, 2
TRAIN_STEPS = 4
CUT_LAYERS, CUT_STEPS = 8, 2
PEAK_BF16_PER_S = 989e12
# cards-ckpt: the checkpoint after step CKPT_EVERY of CKPT_STEPS
CKPT_LAYERS, CKPT_STEPS, CKPT_EVERY = 2, 4, 2


def _smoke():
    """``chip_smoke.py``'s module (its helpers and constants)."""
    for p in (str(ROOT), str(SRC)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import chip_smoke
    return chip_smoke


def log(msg: str) -> None:
    print(msg, flush=True)


# --------------------------------------------------------------------------
# what a phase records
# --------------------------------------------------------------------------

def _step_record(a) -> dict:
    """One session step's :class:`Allocation`, as plain values."""
    return dict(alloc=np.asarray(a.alloc),
                iterations=np.asarray(a.raw.iterations),
                converged=np.asarray(a.raw.converged),
                plan_cache=a.plan_cache, backend=a.backend, engine=a.engine,
                build_s=a.build_time_s, solve_s=a.solve_time_s)


@contextlib.contextmanager
def _recording():
    """Within the block, every lane stack a map backend solves is appended
    to the list it yields."""
    from repro_torch.core import backends
    launched, inner = [], backends._solve_batch

    def recording(batch, *a, **kw):
        launched.append(batch[0])
        return inner(batch, *a, **kw)

    backends._solve_batch = recording
    try:
        yield launched
    finally:
        backends._solve_batch = inner


def _session(device, insts, backend, opts) -> dict:
    """The session's three steps through ``backend`` with the lane
    kernels' launches counted over them: ``{steps, launches, per_call,
    slices}``, ``slices`` the lane stacks it solved (not recorded)."""
    smoke = _smoke()
    from repro_torch.kernels import structured_pdhg_step as kernel_mod
    with _recording() as launched:
        smoke.zero_launches(kernel_mod)
        allocs = smoke._backend_session(device, insts, backend, opts)
        launches = dict(kernel_mod.LAUNCHES)
        per_call = smoke.per_half_step(kernel_mod)
    return dict(steps=[_step_record(a) for a in allocs], launches=launches,
                per_call=per_call, slices=list(launched))


def _hold(tag: str, op) -> None:
    """The lane kernels against their plain versions on the lane stack
    ``op`` (on its card, that card current)."""
    smoke = _smoke()
    from repro_torch.core import pdhg
    with torch.cuda.device(op.c.device):
        smoke.hold_at_shape(tag, op, pdhg.fused_structured_engine(),
                            pdhg.fused_structured_engine("ref"),
                            smoke.lane_calls, op.c.device,
                            prefix="cards-pop")


def _profiled(run) -> dict:
    """One call of ``run`` under ``torch.profiler`` (CPU and, on the card,
    CUDA activity): its wall, the kernels it launched, their device time
    and the NCCL kernels' part of it (which includes a rank's wait for the
    others)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    evs = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.count]
    nccl = [e for e in evs if "nccl" in e.key.lower()]
    return dict(wall_ms=wall * 1e3, kernels=sum(e.count for e in evs),
                device_ms=sum(e.self_device_time_total for e in evs) / 1e3,
                nccl_kernels=sum(e.count for e in nccl),
                nccl_ms=sum(e.self_device_time_total for e in nccl) / 1e3)


# --------------------------------------------------------------------------
# the ranks' phases
# --------------------------------------------------------------------------

def cards_pop(rank: int, device) -> dict:
    """The session through ``shard_map`` on the default mesh over every
    rank, at the default chunk and at ``chunk=1``."""
    from repro_torch import testing
    insts = testing.session_instances(N_JOBS, NUM_WORKERS, CHURN)
    out = {}
    for name, opts in SHARD_RUNS:
        run = _session(device, insts, "shard_map", opts)
        slices = run.pop("slices")
        run["lanes"] = [int(s.c.shape[0]) for s in slices]
        out[name] = run
        log(f"[cards-pop] rank {rank} {name}: lanes a solve {run['lanes']}, "
            f"launches {run['launches']}, CUDA launches a call "
            f"{run['per_call']}")
        if device.type == "cuda":
            _hold(f"rank {rank}'s {name} lane slice", slices[0])
    return out


def cards_serve(rank: int, device) -> dict:
    """llama3-8b split four ways against the world of one on card 0."""
    import torch.distributed as dist

    from repro_torch import configs, models
    from repro_torch.launch import serve, train
    from repro_torch.serve.engine import (ServeConfig, jit_serve_step,
                                          place_cache)
    smoke = _smoke()
    world = dist.get_world_size()
    cfg = configs.get_config(smoke.SERVE_ARCH)
    batch, max_seq = smoke.SERVE_BATCH, smoke.SERVE_MAX_SEQ
    prompt = serve.random_prompt(cfg, batch, smoke.MESH_SERVE_PROMPT,
                                 smoke.SERVE_SEED, device)
    out = {}
    if rank == 0:
        out["one"] = smoke._tp_serve_one(cfg, device, prompt)
    # the split run is teacher-forced with the world of one's tokens
    box = [out["one"]["bfloat16"][1] if rank == 0 else None]
    dist.broadcast_object_list(box, src=0)
    mesh = train.mesh_for((1, world), device)
    params = serve.build_params(cfg, smoke.SERVE_SEED, device, mesh=mesh)
    scfg = ServeConfig(batch=batch, max_seq=max_seq)
    cache = place_cache(models.init_cache(cfg, batch, max_seq,
                                          kv_dtype=scfg.dtype,
                                          device=device), batch, mesh, scfg)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    step = jit_serve_step(cfg, scfg, mesh, device=device.type,
                          with_logits=True)
    with torch.no_grad():
        tp = smoke._tp_greedy(step, params, cache, prompt,
                              smoke.MESH_TP_TOKENS, forced=box[0])
    out["peak"] = torch.cuda.max_memory_allocated(device)
    out["weight_bytes"] = sum(t.to_local().numel() *
                              t.to_local().element_size()
                              for t in models.transformer.leaves(params))
    out["split_ms"] = tp[3]
    # one more split step, profiled after every timed one
    token = box[0][:, -1:].to(device)
    with torch.no_grad():
        out["profile"] = _profiled(lambda: step(params, cache, token))
    if rank == 0:
        out["tp"] = tp
    del params, cache, step
    torch.cuda.empty_cache()
    # the serving driver itself on the mesh (greedy, not forced)
    argv = ["--arch", smoke.SERVE_ARCH, "--batch", str(batch), "--max-seq",
            str(max_seq), "--prompt", str(smoke.MESH_SERVE_PROMPT),
            "--tokens", str(smoke.MESH_TP_TOKENS), "--mesh", f"1x{world}"]
    run = serve.main(argv + _device_args(device))
    out["driver"] = dict(step_ms=run.step_ms, peak=run.peak_bytes,
                         tokens=run.tokens,
                         finite=bool(torch.isfinite(run.final_logits).all()))
    torch.cuda.empty_cache()
    return out


def _device_args(device) -> list:
    """The drivers' ``--device``: their default (the card) on the card."""
    return [] if device.type == "cuda" else ["--device", device.type]


def _driver_run(argv, layers=None, f32=False, keep=False,
                profile_at=None) -> dict:
    """``launch.train.main(argv)`` with its depth cut to ``layers`` and, with
    ``f32``, its ``TrainConfig`` built in f32; each step timed with CUDA
    events: ``{steps: [{ms, loss, grad_norm, lr}], peak, wall_s}`` and,
    with ``keep``, host copies of this rank's blocks of the final
    parameters, m and v.  Step ``profile_at`` runs under the profiler
    (``profile``; its ``ms`` is not a timing)."""
    from unittest import mock

    from repro_torch.launch import train
    from repro_torch.models.transformer import leaves
    smoke = _smoke()
    steps, profiled = [], {}

    def timed(make):
        @functools.wraps(make)
        def build(*a, **kw):
            step = make(*a, **kw)

            def run(params, opt, batch):
                if len(steps) == profile_at:
                    got = []
                    prof = _profiled(lambda: got.append(
                        step(params, opt, batch)))
                    profiled.update(prof)
                    out = got[0]
                    steps.append(dict(ms=None, **{k: float(v) for k, v in
                                                  out[2].items()}))
                    return out
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = step(params, opt, batch)
                end.record()
                end.synchronize()
                steps.append(dict(ms=start.elapsed_time(end),
                                  **{k: float(v) for k, v in
                                     out[2].items()}))
                return out
            return run
        return build

    get = train.get_config
    patches = [mock.patch.object(train, "make_train_step",
                                 timed(train.make_train_step)),
               mock.patch.object(train, "jit_train_step",
                                 timed(train.jit_train_step))]
    if layers is not None:
        patches.append(mock.patch.object(
            train, "get_config",
            lambda arch: smoke.cut_depth(get(arch), layers)))
    if f32:
        patches.append(mock.patch.object(
            train, "TrainConfig",
            functools.partial(train.TrainConfig, compute_dtype="float32")))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        params, opt, _ = train.main(argv)
    out = dict(steps=steps, wall_s=time.perf_counter() - t0,
               peak=torch.cuda.max_memory_allocated(), profile=profiled)
    if keep:
        out["blocks"] = [_local(t).detach().to("cpu", copy=True)
                         for tree in (params, opt.m, opt.v)
                         for t in leaves(tree)]
    del params, opt
    torch.cuda.empty_cache()
    return out


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def _train_args(device, steps: int) -> list:
    return (["--arch", TRAIN_ARCH, "--batch", str(TRAIN_BATCH), "--seq",
             str(TRAIN_SEQ), "--microbatches", str(TRAIN_MICRO), "--steps",
             str(steps)] + _device_args(device))


def cards_train(rank: int, device) -> dict:
    """llama3-8b cut to CUT_LAYERS on card 0 alone and on 1 x 4, then at
    its full depth on 1 x 4."""
    import torch.distributed as dist
    world = dist.get_world_size()
    mesh = ["--mesh", f"1x{world}"]
    out = {}
    if rank == 0:
        out["one"] = {dt: _driver_run(_train_args(device, CUT_STEPS),
                                      CUT_LAYERS, f32=dt == "float32")
                      for dt in ("bfloat16", "float32")}
    dist.barrier()
    out["cut"] = _driver_run(_train_args(device, CUT_STEPS) + mesh,
                             CUT_LAYERS)
    # one more step than TRAIN_STEPS, profiled after the timed ones
    out["full"] = _driver_run(_train_args(device, TRAIN_STEPS + 1) + mesh,
                              profile_at=TRAIN_STEPS)
    for name in ("cut", "full"):
        run = out[name]
        log(f"[cards-train] rank {rank} {name}: losses "
            f"{[s['loss'] for s in run['steps']]}, ms a step "
            f"{[s['ms'] for s in run['steps']]}, peak "
            f"{run['peak'] / 1e9:.3f} GB")
    return out


def cards_ckpt(rank: int, device) -> dict:
    """CKPT_STEPS f32 steps of llama3-8b cut to CKPT_LAYERS on 1 x 4 with a
    checkpoint after step CKPT_EVERY, then a run restored from it that
    takes the next step again."""
    import torch.distributed as dist
    directory = WORK / "ckpt"
    if rank == 0:
        shutil.rmtree(directory, ignore_errors=True)
    dist.barrier()
    args = ["--mesh", f"1x{dist.get_world_size()}", "--ckpt-dir",
            str(directory)]
    whole = _driver_run(_train_args(device, CKPT_STEPS) + args + [
        "--ckpt-every", str(CKPT_EVERY)], CKPT_LAYERS, f32=True, keep=True)
    ckpt_bytes = sum(p.stat().st_size for p in directory.rglob("*")
                     if p.is_file())
    dist.barrier()
    # restored from step CKPT_EVERY, the run takes step CKPT_EVERY + 1
    # and stops (no checkpoint written)
    resumed = _driver_run(_train_args(device, CKPT_EVERY + 1) + args + [
        "--ckpt-every", str(10 * CKPT_STEPS)], CKPT_LAYERS, f32=True,
        keep=True)
    equal = [bool(torch.equal(a, b)) for a, b in
             zip(whole.pop("blocks"), resumed.pop("blocks"))]
    dist.barrier()
    if rank == 0:
        shutil.rmtree(directory, ignore_errors=True)
    return dict(whole=whole, resumed=resumed, equal=equal,
                ckpt_bytes=ckpt_bytes)


RANK_PHASES = (("cards-pop", cards_pop), ("cards-serve", cards_serve),
               ("cards-train", cards_train), ("cards-ckpt", cards_ckpt))


def rank_main(device_type: str = "cuda") -> int:
    """One rank under a ``torchrun``-style environment: card ``LOCAL_RANK``
    (the CPU for ``device_type="cpu"``, the rehearsal), a process group
    with a timeout, every phase in order; its report after each phase to
    ``WORK/rank{RANK}.pt``.  A failed phase ends the rank at once (the
    others are then stuck in a collective)."""
    import torch.distributed as dist

    from repro_torch.core.placement import backend_for
    rank, local = int(os.environ["RANK"]), int(os.environ["LOCAL_RANK"])
    if device_type == "cuda":
        torch.cuda.set_device(local)
        device = torch.device("cuda", local)
    else:
        device = torch.device(device_type)
    dist.init_process_group(backend_for(device),
                            timeout=timedelta(seconds=PG_TIMEOUT_S))
    path = WORK / f"rank{rank}.pt"
    report = {"rank": rank, "device": str(device)}
    for name, fn in RANK_PHASES:
        t0 = time.perf_counter()
        try:
            report[name] = fn(rank, device)
        except Exception:
            report[name] = {"error": traceback.format_exc()}
            print(report[name]["error"], file=sys.stderr, flush=True)
            torch.save(report, path)
            return 1
        report[name]["wall_s"] = time.perf_counter() - t0
        torch.save(report, path)
        log(f"[{name}] rank {rank}: phase wall "
            f"{report[name]['wall_s']:.2f} s")
    dist.barrier()
    dist.destroy_process_group()
    return 0


# --------------------------------------------------------------------------
# the launcher's half: one process over every card
# --------------------------------------------------------------------------

def pop_one_process(device, pmap_opts=None) -> dict:
    """The session through ``vmap`` on ``device`` and through ``pmap`` with
    ``pmap_opts`` (default: none, so every visible device of the
    batch's type); each card's lane slice held against the plain
    versions."""
    from repro_torch import testing
    insts = testing.session_instances(N_JOBS, NUM_WORKERS, CHURN)
    out = {"vmap": _session(device, insts, "vmap", {})}
    out["vmap"].pop("slices")
    out["pmap"] = run = _session(device, insts, "pmap", pmap_opts or {})
    slices = run.pop("slices")
    run["devices"] = sorted({str(s.c.device) for s in slices})
    if device.type == "cuda":
        for dev in run["devices"]:
            _hold(f"pmap's slice on {dev}",
                  next(s for s in slices if str(s.c.device) == dev))
    return out


# --------------------------------------------------------------------------
# the checks
# --------------------------------------------------------------------------

class Verdicts:
    """The checks over the ranks' reports; ``cards`` is printed beside
    every number, and the launch and memory checks run ``on_card``
    only."""

    def __init__(self, reports: list, one_process: dict, cards: str,
                 on_card: bool = True):
        self.reports, self.one = reports, one_process
        self.cards, self.on_card = cards, on_card
        self.smoke = _smoke()

    def say(self, tag: str, msg: str) -> None:
        log(f"[{tag}] {msg} (on {self.cards})")

    def phase(self, name: str) -> list:
        got = [r.get(name, {"error": "not run"}) for r in self.reports]
        for r, g in enumerate(got):
            self.smoke.check("error" not in g,
                             f"{name} rank {r}: {g.get('error')}")
        return got

    def pop(self) -> None:
        check = self.smoke.check
        want = self.one["vmap"]["steps"]
        verdicts = [s["plan_cache"] for s in want]
        check(verdicts == ["miss", "hit", "repair"],
              f"vmap verdicts {verdicts}")
        for s in want:
            check(s["converged"].all(), "a vmap lane did not converge")
        runs = [(f"{name} rank {r}", "shard_map", rep[name])
                for r, rep in enumerate(self.phase("cards-pop"))
                for name, _ in SHARD_RUNS]
        runs.append(("pmap", "pmap", self.one["pmap"]))
        for tag, backend, run in runs:
            for got, ref in zip(run["steps"], want):
                self.say("cards-pop", f"{tag} {got['plan_cache']}: "
                         f"backend {got['backend']}, engine "
                         f"{got['engine']}, build_s {got['build_s']:.4f} / "
                         f"solve_s {got['solve_s']:.4f} (vmap "
                         f"{ref['build_s']:.4f} / {ref['solve_s']:.4f}), "
                         f"iterations {got['iterations'].tolist()}")
                check(got["backend"] == backend and
                      got["engine"] == ref["engine"],
                      f"{tag}: ran {got['backend']} / {got['engine']}")
                check(got["plan_cache"] == ref["plan_cache"],
                      f"{tag}: verdict {got['plan_cache']} against "
                      f"{ref['plan_cache']}")
                check(np.array_equal(got["alloc"], ref["alloc"]),
                      f"{tag} {got['plan_cache']}: allocation differs from "
                      "vmap's")
                check(np.array_equal(got["iterations"], ref["iterations"]),
                      f"{tag} {got['plan_cache']}: per-lane iterations "
                      "differ from vmap's")
            self.say("cards-pop", f"{tag}: all three steps bit-equal to "
                     f"vmap's; lane-kernel launches {run['launches']}, CUDA "
                     f"launches a call {run['per_call']}")
            if self.on_card:
                for kernel, n in run["launches"].items():
                    check(n > 0, f"{kernel} was not launched by {tag}")
                for kernel, per in run["per_call"].items():
                    check(per == 1, f"{tag}: {kernel} {per} CUDA launches "
                          "a call")
        devices = self.one["pmap"]["devices"]
        self.say("cards-pop", f"pmap solved its slices on {devices}")
        if self.on_card:
            check(devices == [f"cuda:{i}" for i in range(WORLD)],
                  f"pmap ran on {devices}")

    def serve(self) -> None:
        check = self.smoke.check
        ranks = self.phase("cards-serve")
        peaks = [(r["peak"], r["weight_bytes"]) for r in ranks]
        self.smoke.tp_serve_verdict(
            "cards-serve", ranks[0]["one"], ranks[0]["tp"], peaks,
            SERVE_PEAK_SHARE,
            f"{WORLD} ranks over {'NCCL' if self.on_card else 'gloo'}")
        self.say("cards-serve", "split ms a step on each rank "
                 f"{[round(r['split_ms'], 3) for r in ranks]}; the world "
                 f"of one's peak {ranks[0]['one']['bfloat16_peak'] / 1e9:.3f}"
                 " GB")
        drv = [r["driver"] for r in ranks]
        self.say("cards-serve", "launch.serve --mesh 1x4: ms a step "
                 f"{[d['step_ms'] for d in drv]}, max_memory_allocated "
                 f"{[None if d['peak'] is None else round(d['peak'] / 1e9, 3) for d in drv]}"
                 " GB")
        for r, d in enumerate(drv):
            check(d["finite"], f"launch.serve rank {r}: non-finite logits")
            check(torch.equal(d["tokens"], drv[0]["tokens"]),
                  f"launch.serve rank {r}: tokens differ from rank 0's")
        self.profile_line("cards-serve", "one more split decode step",
                          [r["profile"] for r in ranks])

    def profile_line(self, tag: str, what: str, profiles: list) -> None:
        """Each rank's profiled step: its wall, kernels, device time and
        the NCCL kernels' part of it."""
        self.say(tag, f"{what} under the profiler, each rank: wall ms "
                 f"{[round(p['wall_ms'], 2) for p in profiles]}, kernels "
                 f"{[p['kernels'] for p in profiles]}, device ms "
                 f"{[round(p['device_ms'], 2) for p in profiles]}, of which "
                 f"NCCL {[round(p['nccl_ms'], 2) for p in profiles]} ms in "
                 f"{[p['nccl_kernels'] for p in profiles]} kernels")

    def train(self) -> None:
        from repro_torch import configs, testing
        check = self.smoke.check
        ranks = self.phase("cards-train")
        for r, rep in enumerate(ranks):
            losses = [s["loss"] for s in rep["full"]["steps"]]
            check(len(losses) == TRAIN_STEPS + 1 and
                  all(math.isfinite(v) for v in losses),
                  f"cards-train rank {r}: losses {losses}")
            check(losses == [s["loss"] for s in
                             ranks[0]["full"]["steps"]],
                  f"cards-train rank {r}: losses differ from rank 0's")
        cfg = configs.get_config(TRAIN_ARCH)
        tokens = TRAIN_BATCH * TRAIN_SEQ
        flops = self.smoke.train_flops(cfg, tokens, TRAIN_SEQ, remat=False)
        full = ranks[0]["full"]["steps"][:TRAIN_STEPS]
        ms = [round(s["ms"], 2) for s in full]
        self.say("cards-train", f"{cfg.name} at {cfg.n_layers} layers on "
                 f"1 x {WORLD}: losses {[s['loss'] for s in full]}, "
                 f"grad_norm {[round(s['grad_norm'], 4) for s in full]}, ms "
                 f"a step {ms}, {tokens / (full[-1]['ms'] / 1e3):.1f} "
                 f"tokens/s; {flops:.4g} model FLOPs a step = "
                 f"{flops / (full[-1]['ms'] / 1e3) / (WORLD * PEAK_BF16_PER_S):.3f}"
                 f" of {WORLD} x the dense bf16 peak at the last step (with "
                 "remat's second forward "
                 f"{self.smoke.train_flops(cfg, tokens, TRAIN_SEQ, remat=True) / (full[-1]['ms'] / 1e3) / (WORLD * PEAK_BF16_PER_S):.3f})")
        self.say("cards-train", "max_memory_allocated a rank "
                 f"{[round(r['full']['peak'] / 1e9, 3) for r in ranks]} GB "
                 f"(f32 state {16 * self._params(cfg) / WORLD / 1e9:.1f} GB "
                 "a rank)")
        self.profile_line("cards-train", f"step {TRAIN_STEPS + 1}",
                          [r["full"]["profile"] for r in ranks])
        one = ranks[0]["one"]
        cut = ranks[0]["cut"]["steps"]
        b16 = one["bfloat16"]["steps"][-1]["loss"]
        f32 = one["float32"]["steps"][-1]["loss"]
        tol = testing.bf16_logit_tol(f32, b16)
        self.say("cards-train", f"{CUT_LAYERS} layers: 1 x {WORLD} losses "
                 f"{[s['loss'] for s in cut]} against card 0 alone's bf16 "
                 f"{[s['loss'] for s in one['bfloat16']['steps']]} and f32 "
                 f"{[s['loss'] for s in one['float32']['steps']]}; ms a step "
                 f"{[round(s['ms'], 2) for s in cut]} against "
                 f"{[round(s['ms'], 2) for s in one['bfloat16']['steps']]};"
                 f" peaks {[round(r['cut']['peak'] / 1e9, 3) for r in ranks]}"
                 f" GB against {one['bfloat16']['peak'] / 1e9:.3f}")
        check(abs(cut[-1]["loss"] - b16) <= tol,
              f"{CUT_LAYERS} layers: the split loss {cut[-1]['loss']} off "
              f"card 0's {b16} by more than {tol}")

    @staticmethod
    def _params(cfg) -> int:
        from repro_torch import models
        from repro_torch.models.transformer import leaves
        return sum(t.numel() for t in leaves(models.init_params(None, cfg)))

    def ckpt(self) -> None:
        check = self.smoke.check
        ranks = self.phase("cards-ckpt")
        for r, rep in enumerate(ranks):
            whole = rep["whole"]["steps"]
            resumed = rep["resumed"]["steps"]
            check(len(resumed) == 1,
                  f"cards-ckpt rank {r}: the restored run took "
                  f"{len(resumed)} steps, not one")
            got = {k: v for k, v in resumed[0].items() if k != "ms"}
            want = {k: v for k, v in whole[CKPT_EVERY + 1].items()
                    if k != "ms"}
            check(got == want, f"cards-ckpt rank {r}: the restored step "
                  f"{got} against {want}")
            check(all(rep["equal"]), f"cards-ckpt rank {r}: "
                  f"{rep['equal'].count(False)} blocks differ")
        rep = ranks[0]
        self.say("cards-ckpt", f"a {CKPT_LAYERS}-layer f32 checkpoint of "
                 f"{rep['ckpt_bytes'] / 1e9:.3f} GB after step {CKPT_EVERY} "
                 f"on 1 x {WORLD}, restored onto 1 x {WORLD}: step "
                 f"{CKPT_EVERY + 1}'s metrics {rep['resumed']['steps'][0]} "
                 "and every rank's blocks of the parameters, m and v "
                 "bit-equal to the uninterrupted run's; walls "
                 f"{rep['whole']['wall_s']:.1f} s (with the save) and "
                 f"{rep['resumed']['wall_s']:.1f} s (with the restore)")

    def all(self) -> None:
        self.pop()
        self.serve()
        self.train()
        self.ckpt()


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def card_lines() -> list:
    """Each card's name and power limit as nvidia-smi prints them."""
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr.strip()}")
    return [ln.strip() for ln in proc.stdout.splitlines() if ln.strip()]


def _run_ranks(deadline_s: float) -> list:
    """Start the WORLD ranks and wait for them: each one's exit code (None:
    killed at the deadline, or after another rank failed)."""
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE=str(WORLD),
               LOCAL_WORLD_SIZE=str(WORLD),
               PYTHONPATH=os.pathsep.join(
                   [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")]
                                 if p]))
    # every rank is on this host: NCCL's bootstrap over the loopback
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    procs, files = [], []
    try:
        for r in range(WORLD):
            fh = open(LOGS / f"rank{r}.log", "w")
            files.append(fh)
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--rank"],
                cwd=ROOT, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                stdout=fh, stderr=subprocess.STDOUT))
        end = time.monotonic() + deadline_s
        failed_at = None
        while any(p.poll() is None for p in procs):
            now = time.monotonic()
            if failed_at is None and any(p.poll() not in (None, 0)
                                         for p in procs):
                failed_at = now
            if now > end or (failed_at is not None
                             and now > failed_at + GRACE_S):
                break
            time.sleep(1)
    finally:
        codes = []
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
                codes.append(None)
            else:
                codes.append(p.returncode)
        for fh in files:
            fh.close()
    return codes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--deadline", type=float, default=DEADLINE_S,
                    help="seconds the ranks may run before they are killed")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available() or torch.cuda.device_count() < WORLD:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"across_cards: needs {WORLD} CUDA devices, found {n}",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"across_cards: {SRC / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    smoke = _smoke()
    cards = card_lines()
    kinds = sorted(set(cards))
    where = (f"{WORLD} x {kinds[0]}" if len(kinds) == 1
             else "; ".join(cards))
    log(f"[cards] {where}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} devices")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smoke.phase_build()
    LOGS.mkdir(parents=True, exist_ok=True)
    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    t0 = time.perf_counter()
    codes = _run_ranks(a.deadline)
    ranks_wall = time.perf_counter() - t0
    for r in range(WORLD):
        text = (LOGS / f"rank{r}.log").read_text(errors="replace")
        log(f"[cards] rank {r}'s log, on card {r} ({cards[r]}):")
        for line in text.splitlines():
            log(f"rank {r}| {line}")
    log(f"[cards] ranks' exit codes {codes} after {ranks_wall:.1f} s "
        f"(None: killed)")
    ok = codes == [0] * WORLD
    reports = [torch.load(WORK / f"rank{r}.pt", weights_only=False)
               if (WORK / f"rank{r}.pt").is_file() else {}
               for r in range(WORLD)]
    try:
        t1 = time.perf_counter()
        one = pop_one_process(torch.device("cuda", 0))
        log(f"[cards-pop] vmap and pmap in this process: "
            f"{time.perf_counter() - t1:.1f} s")
        Verdicts(reports, one, where).all()
    except Exception:
        traceback.print_exc()
        ok = False
    walls = {name: [r.get(name, {}).get("wall_s") for r in reports]
             for name, _ in RANK_PHASES}
    print(json.dumps({"ok": ok, "cards": cards, "ranks_wall_s": ranks_wall,
                      "phase_walls_s": walls}))
    return 0 if ok else 1


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.path[:0] = [str(SRC), str(ROOT)]
        sys.exit(rank_main())
    sys.exit(main())
