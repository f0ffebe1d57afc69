"""Dry run: every (arch x input-shape x mesh) cell runs one step of the port
on meta tensors under a fake process group of 256 (16 x 16) or 512
(2 x 16 x 16) ranks, and the roofline inputs are counted from what ran —
the port of ``repro/launch/dryrun.py``.

Nothing is allocated and nothing runs on a device: parameters, optimizer
state, caches and batches are ``meta`` tensors placed as DTensors by the
reference's sharding rules, and the fake group's collectives return at
once.  Counted per device, on rank 0's own shapes:

* FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over the step.  The
  port's sharded steps compute on local tensors (each rank's rows of the
  batch and, over ``model``, its share of every split product: its
  heads, its FFN columns, its vocab block), so the count is this rank's
  work, not the global op's (``FlopCounterMode`` over DTensor ops would
  count the global op);
* bytes: every op's tensor inputs read once and outputs written once
  (views excepted) — an unfused upper bound, as the reference's CPU-backend
  HLO bytes;
* collectives: the result bytes of every collective, by kind
  (``hlo_stats.CollectiveLog``).

XLA counts a while-loop body once, so the reference rebuilds scanned
costs from probes at 1 and 2 periods; the port's loops are Python, so
``probe_costs`` keeps the reference's output schema and counts every
period directly.  A train cell runs one microbatch (the global batch over
``n_micro``) and multiplies its counts by ``n_micro``, as the reference's
probe does: the optimizer update and the step's data-axis sums are then
counted ``n_micro - 1`` extra times (no FLOPs, a few bytes a parameter).

Usage:
    python -m repro_torch.launch.dryrun --arch llama3_8b --shape train_4k \\
        --mesh single
    python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]

Outputs one JSON per cell under ``experiments/dryrun_torch/<mesh>/``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from ..configs import ARCH_IDS, get_config
from ..models import transformer as tf
from ..serve.engine import ServeConfig, jit_serve_step, place_cache
from ..train.train_step import (TrainConfig, jit_train_step, place_batch,
                                place_opt_state, place_params)
from ..core import placement as pl
from . import shardings as sh
from . import specs as sp
from .hlo_stats import (CollectiveLog, active_param_counts, collective_bytes,
                        collective_kind)
from .mesh import MULTI_POD, SINGLE_POD, mesh_chip_count

OUT_ROOT = os.path.normpath(os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "experiments",
    "dryrun_torch"))
META = torch.device("meta")


def fake_world(n_ranks: int) -> None:
    """A fake process group of ``n_ranks`` in this process, rank 0 (a
    group of another size or backend is replaced)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == n_ranks:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n_ranks)


def fake_mesh(shape, names):
    """A mesh of ``shape`` over a fake group of as many ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    fake_world(math.prod(shape))
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))


def _probe_cfg(cfg, seg_periods, moe_cf=None):
    """Config clone with per-segment period counts replaced (and optionally
    a different MoE capacity factor, a perf experiment)."""
    segs = tuple(dataclasses.replace(s, n_periods=n)
                 for s, n in zip(cfg.segments, seg_periods))
    moe = cfg.moe
    if moe_cf is not None and moe is not None:
        moe = dataclasses.replace(moe, capacity_factor=float(moe_cf))
    return dataclasses.replace(cfg, segments=segs, moe=moe)


class ByteCounter(TorchDispatchMode):
    """Bytes every op reads (its tensor inputs) and writes (its outputs),
    views and collectives excepted; ``last_op`` names the op that ran
    last (a failing cell reports it)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0
        self.last_op = None

    @staticmethod
    def _nbytes(x) -> int:
        if isinstance(x, torch.Tensor):
            return math.prod(x.shape) * x.element_size()
        if isinstance(x, (list, tuple)):
            return sum(ByteCounter._nbytes(v) for v in x)
        return 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.last_op = str(func)
        out = func(*args, **(kwargs or {}))
        if not func.is_view and collective_kind(str(func)) is None:
            self.ops += 1
            self.bytes += (self._nbytes(args)
                           + self._nbytes(list((kwargs or {}).values()))
                           + self._nbytes(out))
        return out


# the flags that change what a cell runs: the serve step's cache layouts,
# the MoE capacity factor, and the model options of
# ``models.transformer.ModelOpts`` (a decode step's one position never
# runs sequence-parallel)
MODEL_FLAGS = ("sp_residual", "gather_once", "bf16_barrier")
FLAGS = ("shard_cache_seq", "cache_seq_on_model", "moe_cf") + MODEL_FLAGS


def check_flags(flags: dict) -> dict:
    for k in flags:
        if k not in FLAGS:
            raise ValueError(
                f"flag {k!r} is not one the port's steps act on "
                f"({', '.join(FLAGS)})")
    return flags


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor
    return sum(math.prod(t._local_tensor.shape if isinstance(t, DTensor)
                         else t.shape) * t.element_size()
               for t in tf.leaves(tree))


def _run(cfg, cell, mesh, n_dp, flags=None, n_micro=None):
    """One step of ``cell`` on meta tensors, counted: ``(flops, bytes,
    collectives dict, ops, argument bytes)`` per device (a train cell: one
    microbatch's counts times ``n_micro``).  ``n_micro`` replaces the
    cell's microbatching policy (``microbatches_for``)."""
    flags = check_flags(flags or {})
    model_flags = {k: bool(flags[k]) for k in MODEL_FLAGS if k in flags}
    params = place_params(sp.params_shape(cfg), mesh)
    counter = ByteCounter()
    log = CollectiveLog()
    flop = FlopCounterMode(display=False)
    try:
        scale = 1
        if cell.kind == "train":
            scale = n_micro or sp.microbatches_for(cell, n_dp)
            micro = dataclasses.replace(
                cell, global_batch=max(cell.global_batch // scale, n_dp))
            tcfg = TrainConfig(n_microbatches=1, unroll_segments=True,
                               **model_flags)
            opt = place_opt_state(sp.opt_shape(sp.params_shape(cfg)), mesh)
            batch = place_batch(sp.batch_specs(cfg, micro), mesh)
            args = (params, opt, batch)
            step = jit_train_step(cfg, tcfg, mesh, device="cpu")
            with log, flop, counter:
                step(*args)
        elif cell.kind == "prefill":
            batch = place_batch(sp.batch_specs(cfg, cell), mesh)
            batch.pop("labels")
            args = (params, batch)
            opts = tf.ModelOpts(mesh=mesh, places=pl.places_of(params),
                                **model_flags)
            enc = batch.get("enc_embeddings")
            with log, flop, counter, torch.no_grad():
                tf.forward_train(
                    pl.local_tree(params), cfg, batch["tokens"]._local_tensor,
                    enc_embeddings=None if enc is None else enc._local_tensor,
                    remat=False, unroll=True, opts=opts)
        else:
            token, cache, memory = sp.decode_specs(cfg, cell)
            scfg = ServeConfig(
                batch=cell.global_batch, max_seq=cell.seq_len,
                shard_cache_seq=flags.get("shard_cache_seq",
                                          cell.name == "long_500k"),
                unroll_segments=True,
                cache_seq_on_model=flags.get("cache_seq_on_model", False))
            cache = place_cache(cache, scfg.batch, mesh, scfg)
            args = (params, cache, token, memory)
            step = jit_serve_step(cfg, scfg, mesh, device="cpu")
            with log, flop, counter, torch.no_grad():
                step(*args)
    except Exception as exc:
        exc.last_op = counter.last_op
        raise
    arg_bytes = sum(_local_bytes(a) if isinstance(a, (dict, tuple))
                    else _local_bytes([a]) for a in args if a is not None)
    coll = {k: v * scale for k, v in collective_bytes(log).items()}
    return (float(flop.get_total_flops()) * scale,
            float(counter.bytes) * scale, coll, counter.ops * scale,
            arg_bytes)


def probe_costs(cfg, cell, mesh, n_dp, flags=None) -> dict:
    """Per-device costs of one step of ``cell``, in the reference's schema.

    The reference rebuilds a scanned stack's cost from probes at one and
    two periods, since XLA counts a while body once; the port's period
    loop is Python, so the full config is counted directly and
    ``probe_base`` holds that count (flops, bytes, collective bytes)."""
    moe_cf = (flags or {}).get("moe_cf")
    if moe_cf is not None:
        cfg = _probe_cfg(cfg, [s.n_periods for s in cfg.segments], moe_cf)
    flops, nbytes, coll, _, _ = _run(cfg, cell, mesh, n_dp, flags)
    n_micro = sp.microbatches_for(cell, n_dp) if cell.kind == "train" else 1
    return {"flops_per_device": flops, "bytes_per_device": nbytes,
            "collective_bytes_per_device": float(coll["total"]),
            "n_micro": n_micro,
            "probe_base": [flops, nbytes, float(coll["total"])]}


def model_flops(cfg, cell) -> float:
    counts = active_param_counts(cfg)
    non_embed = counts["active"] - counts["embed"]
    tokens = cell.global_batch * cell.seq_len
    if cell.kind == "train":
        return 6.0 * non_embed * tokens
    if cell.kind == "prefill":
        return 2.0 * non_embed * tokens
    return 2.0 * non_embed * cell.global_batch


def lower_cell(arch_id: str, shape_name: str, multi_pod: bool, *,
               cfg=None, mesh_shape=None, cell=None, n_micro=None) -> dict:
    """One cell's result (the reference's JSON fields).  ``cfg``,
    ``mesh_shape`` (axes ("data", "model")), ``cell`` and ``n_micro``
    replace the registry's config, the production mesh,
    ``SHAPES[shape_name]`` and its microbatching (the tests' reduced
    cells, the smoke's cut llama3-8b)."""
    cfg = cfg or get_config(arch_id)
    cell = cell or sp.SHAPES[shape_name]
    mesh_name = "multi" if multi_pod else "single"
    ok, reason = sp.cell_is_runnable(cfg, cell)
    if not ok:
        return {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": reason}
    if mesh_shape is not None:
        mesh = fake_mesh(mesh_shape, ("data", "model"))
    else:
        mesh = fake_mesh(*(MULTI_POD if multi_pod else SINGLE_POD))
    chips = mesh_chip_count(mesh)
    n_dp = pl.dp_size(mesh)
    t0 = time.perf_counter()
    flops, nbytes, coll, n_ops, arg_bytes = _run(cfg, cell, mesh, n_dp,
                                                 n_micro=n_micro)
    lower_s = time.perf_counter() - t0
    counts = active_param_counts(cfg)
    if cell.kind != "train":
        n_micro = 1
    n_micro = n_micro or sp.microbatches_for(cell, n_dp)
    probes = None
    if not multi_pod:
        probes = {"flops_per_device": flops, "bytes_per_device": nbytes,
                  "collective_bytes_per_device": float(coll["total"]),
                  "n_micro": n_micro,
                  "probe_base": [flops, nbytes, float(coll["total"])]}
    return {
        "arch": arch_id, "shape": shape_name, "mesh": mesh_name,
        "status": "ok",
        "chips": chips,
        "n_dp": n_dp,
        "lower_s": round(lower_s, 2),
        "compile_s": 0.0,            # nothing is compiled
        "flops": flops,
        "bytes_accessed": nbytes,
        "collectives": coll,
        "params_total": counts["total"],
        "params_active": counts["active"],
        "params_embed": counts["embed"],
        "model_flops": model_flops(cfg, cell),
        "hlo_bytes": None,           # no program text: ops counted instead
        "ops": n_ops,
        "probes": probes,
        "mem_argument_size_in_bytes": arg_bytes,
    }


def run_cell(arch_id: str, shape_name: str, multi_pod: bool, **kw) -> dict:
    """:func:`lower_cell`, with a failure written as ``status: "error"``
    naming the op that raised."""
    try:
        return lower_cell(arch_id, shape_name, multi_pod, **kw)
    except Exception as e:                               # noqa: BLE001
        return {"arch": arch_id, "shape": shape_name,
                "mesh": "multi" if multi_pod else "single",
                "status": "error", "op": getattr(e, "last_op", None),
                "error": f"{type(e).__name__}: {e}",
                "trace": traceback.format_exc()[-2000:]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--shard", default=None, help="i/n split of the cells")
    ap.add_argument("--out", default=OUT_ROOT)
    ap.add_argument("--force", action="store_true",
                    help="run cells that already have a JSON")
    args = ap.parse_args(argv)

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    archs = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    shapes = (list(sp.SHAPES) if (args.all or args.shape is None)
              else [args.shape])
    cells = [(a, s, m) for m in meshes for a in archs for s in shapes]
    if args.shard:
        i, n = map(int, args.shard.split("/"))
        cells = cells[i::n]

    failures = 0
    for a, s, m in cells:
        mesh_name = "multi" if m else "single"
        out_dir = os.path.join(args.out, mesh_name)
        os.makedirs(out_dir, exist_ok=True)
        out_path = os.path.join(out_dir, f"{a}__{s}.json")
        if os.path.exists(out_path) and not args.force:
            print(f"[skip-cached] {a} {s} {mesh_name}")
            continue
        print(f"[trace] {a} {s} {mesh_name} ...", flush=True)
        res = run_cell(a, s, m)
        failures += res["status"] == "error"
        with open(out_path, "w") as f:
            json.dump(res, f, indent=1)
        print(f"   -> {res['status']}"
              + (f" trace={res['lower_s']}s flops/dev={res['flops']:.3g}"
                 if res["status"] == "ok" else
                 f" ({res.get('reason', res.get('error', ''))[:120]})"),
              flush=True)
    print(f"done; {failures} failures")
    if dist.is_initialized():
        dist.destroy_process_group()
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
