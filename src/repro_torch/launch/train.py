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
synchronisation.  The per-arch mesh policy (``perf_policy``) acts only
through a device mesh, ROADMAP item 14.5.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..checkpoint import Checkpointer
from ..configs import get_config, get_reduced
from ..core.problem import resolve_device
from ..data import DevicePrefetcher, TokenPipeline
from ..models import init_params
from ..models import transformer as tf
from ..train import optimizer as opt_mod
from ..train.train_step import TrainConfig, make_train_step

SEED = 0          # the reference's driver draws from PRNGKey(0)


def perf_policy(cfg, mesh) -> dict:
    """Per-arch mesh flags: the sequence-parallel residual pays off exactly
    when attention cannot use the whole model axis (heads < axis).  No
    flag without a mesh."""
    if mesh is None or "model" not in mesh.axis_names:
        return {}
    return {"sp_residual": cfg.n_heads < mesh.shape["model"]}


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
    a = ap.parse_args(argv)

    device = resolve_device(a.device)
    cfg = get_reduced(a.arch) if a.reduced else get_config(a.arch)
    tcfg = TrainConfig(
        n_microbatches=a.microbatches,
        adamw=opt_mod.AdamWConfig(peak_lr=3e-3, warmup_steps=10,
                                  total_steps=a.steps),
        **perf_policy(cfg, None))

    params = init_params(torch.Generator(device).manual_seed(SEED), cfg)
    opt = opt_mod.init_state(params)
    n = sum(t.numel() for t in tf.leaves(params))
    print(f"training {cfg.name}: {n/1e6:.1f}M params, {a.steps} steps")

    step_fn = make_train_step(cfg, tcfg)
    pipe = TokenPipeline(vocab=cfg.vocab, batch=a.batch, seq=a.seq, seed=0,
                         enc_seq=64 if cfg.enc_segments else 0,
                         d_model=cfg.d_model)
    ck = Checkpointer(a.ckpt_dir) if a.ckpt_dir else None
    start = 0
    if ck and ck.latest() is not None:
        restored, extras = ck.restore(ck.latest(),
                                      {"params": params, "opt": opt})
        params, opt = restored["params"], restored["opt"]
        pipe.restore(extras["pipeline"])
        start = extras["step"]
        print(f"resumed from step {start}")

    batches = DevicePrefetcher(pipe, device)
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
