"""Training driver: config-driven, fault-tolerant — the port of
``repro/launch/train.py`` on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_8b \\
        --steps 100 [--reduced] [--ckpt-dir DIR]
    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm_350m \\
        --steps 8 --ckpt-every 4 --ckpt-dir build/ckpt

Runs on the CUDA device unless ``--device cpu`` is given (with no card it
refuses).  Parameters are drawn from the seed ``SEED`` on the device,
batches come from ``TokenPipeline`` through ``DevicePrefetcher``, and with
``--ckpt-dir`` the run resumes from the directory's latest checkpoint
(parameters, optimizer state and the data cursor) and writes one every
``--ckpt-every`` steps.  Every clock is read after a device
synchronisation.

``--mesh DATAxMODEL`` runs the sharded step (``jit_train_step``) on a
("data", "model") mesh over the process group's ranks: a world of one in
this process, or the world a launcher such as ``torchrun`` describes in
``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT``.  Batches are
staged onto the data axes (``DevicePrefetcher(mesh=)``), each rank keeps
only its blocks of the parameters and of AdamW's m and v from the moment
they are drawn (``init_placed_params``), each rank computes its share of
every product the rules split over ``model`` (``perf_policy`` turns on
the sequence-parallel residual where the heads do not fill that axis),
and checkpoints are written whole by rank 0 and restored onto the mesh.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_8b \
        --reduced --steps 4 --mesh 1x1
"""

from __future__ import annotations

import argparse
import time

import torch

from ..checkpoint import Checkpointer
from .mesh import make_host_mesh
from ..configs import get_config, get_reduced
from ..core.problem import resolve_device
from ..data import DevicePrefetcher, TokenPipeline
from ..models import init_params
from ..models import transformer as tf
from ..train import optimizer as opt_mod
from ..train.train_step import (TrainConfig, init_placed_params,
                                init_placed_state, jit_train_step,
                                make_train_step)

SEED = 0          # the reference's driver draws from PRNGKey(0)


def perf_policy(cfg, mesh) -> dict:
    """Per-arch mesh flags, the reference's rule: the sequence-parallel
    residual where attention cannot use the whole model axis (fewer
    heads than ranks), measured there as -57% collective bytes for
    gemma3 and 3x worse for llama3.  ``mesh``: a ``DeviceMesh`` or any
    object with ``axis_names`` and a ``shape`` mapping (None: no
    flags)."""
    from ..core.placement import axis_names, axis_size
    if mesh is None or "model" not in axis_names(mesh):
        return {}
    return {"sp_residual": cfg.n_heads < axis_size(mesh, "model")}


def parse_mesh(text):
    """``"DATAxMODEL"`` -> ``(data, model)``; None stays None."""
    if text is None:
        return None
    data, model = (int(v) for v in text.lower().split("x"))
    return data, model


def mesh_for(shape, device):
    """The ("data", "model") mesh of ``shape`` over the process group (a
    launcher's world when its environment names one, else a world of one);
    another world size raises."""
    import os

    import torch.distributed as dist

    from .mesh import backend_for
    if shape is None:
        return None
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend_for(device))
    mesh = make_host_mesh(model_parallel=shape[1], device=device)
    if tuple(mesh.shape) != tuple(shape):
        raise ValueError(f"--mesh {shape[0]}x{shape[1]} needs "
                         f"{shape[0] * shape[1]} ranks; the process group "
                         f"has {mesh.size()}")
    return mesh


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3_8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device (refused without one)")
    ap.add_argument("--mesh", default=None,
                    help="DATAxMODEL: the sharded step on a device mesh")
    a = ap.parse_args(argv)

    device = resolve_device(a.device)
    mesh = mesh_for(parse_mesh(a.mesh), device)
    if mesh is not None and device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    cfg = get_reduced(a.arch) if a.reduced else get_config(a.arch)
    tcfg = TrainConfig(
        n_microbatches=a.microbatches,
        adamw=opt_mod.AdamWConfig(peak_lr=3e-3, warmup_steps=10,
                                  total_steps=a.steps),
        **perf_policy(cfg, mesh))

    gen = torch.Generator(device).manual_seed(SEED)
    if mesh is None:
        params = init_params(gen, cfg)
        opt = opt_mod.init_state(params)
    else:
        params = init_placed_params(gen, cfg, mesh)
        opt = init_placed_state(params)
    n = sum(t.numel() for t in tf.leaves(params))
    where = ("" if mesh is None else
             f" on a {'x'.join(map(str, mesh.shape))} mesh")
    print(f"training {cfg.name}: {n/1e6:.1f}M params, {a.steps} steps"
          f"{where}")

    step_fn = (make_train_step(cfg, tcfg) if mesh is None
               else jit_train_step(cfg, tcfg, mesh, device=a.device))
    pipe = TokenPipeline(vocab=cfg.vocab, batch=a.batch, seq=a.seq, seed=0,
                         enc_seq=64 if cfg.enc_segments else 0,
                         d_model=cfg.d_model)
    ck = Checkpointer(a.ckpt_dir) if a.ckpt_dir else None
    start = 0
    if ck and ck.latest() is not None:
        restored, extras = ck.restore(ck.latest(),
                                      {"params": params, "opt": opt},
                                      mesh=mesh)
        params, opt = restored["params"], restored["opt"]
        pipe.restore(extras["pipeline"])
        start = extras["step"]
        print(f"resumed from step {start}")

    batches = DevicePrefetcher(pipe, device, mesh=mesh)
    try:
        for s in range(start, a.steps):
            batch = next(batches)
            _sync(device)
            t0 = time.perf_counter()
            params, opt, m = step_fn(params, opt, batch)
            if ck and s and s % a.ckpt_every == 0:
                ck.save_async(s, {"params": params, "opt": opt},
                              extras={"pipeline": batches.state(),
                                      "step": s})
            if s % 10 == 0:
                _sync(device)
                print(f"step {s:5d} loss={float(m['loss']):.4f} "
                      f"gnorm={float(m['grad_norm']):.2f} "
                      f"({time.perf_counter()-t0:.2f}s)")
    finally:
        batches.close()
    if ck:
        ck.wait()
    print(f"done: final loss {float(m['loss']):.4f}")
    return params, opt, m


if __name__ == "__main__":
    main()
