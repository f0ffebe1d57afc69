"""End-to-end training driver on the PyTorch port, with the full
substrate:

  data pipeline -> train step (grad accumulation, bf16 compute) -> AdamW
  -> async checkpointing -> SIMULATED MID-RUN FAILURE -> restart from the
  latest checkpoint (+ data-cursor restore) -> elastic remesh plan -> the
  loss curve continues.

The twin of ``examples/train_e2e.py``.  Default config is CPU-budgeted
(~10M params, 120 steps); ``--model-scale full`` is the ~100M-class run.

    PYTHONPATH=src python examples_torch/train_e2e.py [--device cpu]

Runs on the CUDA device unless ``--device`` names another (with no card
the default refuses).  Checkpoints go to ``experiments/e2e_ckpt_torch``.
A step after a restore is bit-equal to the uninterrupted one on the CPU
and on the card without ``torch.use_deterministic_algorithms``: the
embedding's backward (``F.embedding``) adds each row's gradients in a
fixed order.
"""

import argparse
import os
import shutil
import time

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.core.problem import resolve_device
from repro_torch.data import DevicePrefetcher, TokenPipeline
from repro_torch.models import init_params
from repro_torch.models.transformer import ArchCfg, BlockCfg, Segment, leaves
from repro_torch.sched.elastic import HeartbeatMonitor, plan_remesh
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.train_step import TrainConfig, make_train_step

CKPT_DIR = os.path.join(os.path.dirname(__file__), "..", "experiments",
                        "e2e_ckpt_torch")


def model_cfg(scale: str) -> ArchCfg:
    block = BlockCfg(mixer="attn", ffn="dense", window=None)
    if scale == "full":       # ~100M-class
        return ArchCfg(name="e2e-100m", d_model=640, n_heads=10, n_kv=5,
                       head_dim=64, d_ff=2560, vocab=32_000,
                       segments=(Segment(period=(block,), n_periods=12),))
    return ArchCfg(name="e2e-10m", d_model=256, n_heads=8, n_kv=4,
                   head_dim=32, d_ff=1024, vocab=8_000,
                   segments=(Segment(period=(block,), n_periods=4),))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-scale", default="small", choices=["small", "full"])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--fail-at", type=int, default=60,
                    help="simulate a worker failure at this step")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device (refused without one)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    cfg = model_cfg(args.model_scale)
    B, S = (8, 128) if args.model_scale == "small" else (8, 512)
    tcfg = TrainConfig(n_microbatches=2, adamw=opt_mod.AdamWConfig(
        peak_lr=3e-3, warmup_steps=20, total_steps=args.steps))

    params = init_params(torch.Generator(device).manual_seed(0), cfg)
    n_params = sum(t.numel() for t in leaves(params))
    print(f"== e2e training: {cfg.name} ({n_params/1e6:.1f}M params, "
          f"{args.steps} steps, B={B} S={S}) on {device} ==")

    opt = opt_mod.init_state(params)
    step_fn = make_train_step(cfg, tcfg)
    ck = Checkpointer(CKPT_DIR)
    hb = HeartbeatMonitor(timeout_s=5.0)

    def run_until(params, opt, pipe, start, stop, tag):
        batches = DevicePrefetcher(pipe, device)
        losses = []
        try:
            for s in range(start, stop):
                batch = next(batches)
                t0 = time.perf_counter()
                params, opt, m = step_fn(params, opt, batch)
                hb.beat(0)
                losses.append(float(m["loss"]))      # synchronises
                if s % args.ckpt_every == 0 and s > 0:
                    ck.save_async(s, {"params": params, "opt": opt},
                                  extras={"pipeline": batches.state(),
                                          "step": s})
                if s % 20 == 0:
                    print(f"  [{tag}] step {s:4d} loss={losses[-1]:.4f} "
                          f"({time.perf_counter()-t0:.2f}s/step)")
        finally:
            batches.close()
        return params, opt, losses

    pipe = TokenPipeline(vocab=cfg.vocab, batch=B, seq=S, seed=1)
    params, opt, losses_a = run_until(params, opt, pipe, 0, args.fail_at,
                                      "run-1")
    ck.wait()

    # ---- simulated failure + restart -----------------------------------
    print(f"  !! simulating worker failure at step {args.fail_at}; "
          f"restarting from latest checkpoint")
    latest = ck.latest()
    plan = plan_remesh(n_alive=255 * 2, model_parallel=16)   # 1 chip died
    print(f"  elastic plan after failure: mesh={plan['mesh_shape']} "
          f"spares={plan['spares']}")
    restored, extras = ck.restore(latest, {"params": params, "opt": opt})
    pipe2 = TokenPipeline(vocab=cfg.vocab, batch=B, seq=S, seed=1)
    pipe2.restore(extras["pipeline"])
    print(f"  restored step {extras['step']} (data cursor "
          f"{extras['pipeline']['cursor']})")

    params, opt, losses_b = run_until(restored["params"], restored["opt"],
                                      pipe2, extras["step"], args.steps,
                                      "run-2")
    ck.wait()
    full = losses_a[: extras["step"]] + losses_b
    print(f"final loss {full[-1]:.4f} (start {full[0]:.4f}) — "
          f"{'DECREASED' if full[-1] < full[0] else 'flat'} across restart")
    return {"losses": full, "restored_step": extras["step"],
            "n_params": n_params}


if __name__ == "__main__":
    main()
