"""The training step: microbatched gradient accumulation, bf16 compute
over f32 master parameters, per-period rematerialisation — the port of
``repro/train/train_step.py`` on one device.

Gradients come from autograd.  Each parameter leaf takes ``requires_grad``
for the step, and every microbatch's backward accumulates into the
leaf's one f32 ``.grad`` buffer (no gradient tree per microbatch); the sum
is divided by the number of microbatches, as the reference's scan does.
AdamW then updates the parameters and moments in place.

The reference's mesh path (``jit_train_step``: shardings and donation
under ``jax.jit``) waits for ROADMAP item 14.5.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..models import transformer as tf
from . import optimizer as opt_mod

ROADMAP_MESH = ("a device mesh for training (shardings, donation, "
                "collectives) is not ported: ROADMAP item 14.5")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    n_microbatches: int = 1
    compute_dtype: str = "bfloat16"
    remat: bool = True
    unroll_segments: bool = False    # the dry run's cost probe (item 14.5)
    sp_residual: bool = False        # mesh knobs: no effect without a mesh
    bf16_barrier: bool = False
    gather_once: bool = False
    adamw: opt_mod.AdamWConfig = opt_mod.AdamWConfig()


def cross_entropy(logits, labels):
    """Mean cross-entropy over all positions, in f32."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - gold)


def make_loss_fn(cfg: tf.ArchCfg, tcfg: TrainConfig, mesh=None):
    if mesh is not None:
        raise NotImplementedError(ROADMAP_MESH)
    if tcfg.unroll_segments:
        raise NotImplementedError(
            "unroll_segments is the dry run's cost probe: ROADMAP item 14.5")
    dtype = (torch.bfloat16 if tcfg.compute_dtype == "bfloat16"
             else torch.float32)
    opts = tf.ModelOpts(sp_residual=tcfg.sp_residual,
                        bf16_barrier=tcfg.bf16_barrier,
                        gather_once=tcfg.gather_once)

    def loss_fn(params, batch):
        logits = tf.forward_train(
            params, cfg, batch["tokens"],
            enc_embeddings=batch.get("enc_embeddings"),
            remat=tcfg.remat, compute_dtype=dtype, opts=opts)
        return cross_entropy(logits, batch["labels"])

    return loss_fn


def _grads(tree):
    """The tree of ``.grad`` buffers of a parameter tree (zeros where a
    leaf took no gradient, as ``jax.grad`` gives)."""
    if isinstance(tree, dict):
        return {k: _grads(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_grads(v) for v in tree]
    if tree.grad is None:
        tree.grad = torch.zeros_like(tree, dtype=torch.float32)
    return tree.grad


def make_train_step(cfg: tf.ArchCfg, tcfg: TrainConfig, mesh=None):
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``.

    ``batch`` holds ``[B, ...]`` tensors on the parameters' device; with
    ``n_microbatches > 1`` it is cut into that many contiguous row blocks
    (``B`` must divide).  The parameters and ``opt_state``'s moments are
    updated in place and returned; ``metrics`` (``loss``, ``lr``,
    ``grad_norm``) are 0-d device tensors."""
    loss_fn = make_loss_fn(cfg, tcfg, mesh)
    n_micro = tcfg.n_microbatches

    def train_step(params, opt_state, batch):
        rows = batch["tokens"].shape[0]
        if rows % n_micro:
            raise ValueError(f"a batch of {rows} rows does not split into "
                             f"{n_micro} microbatches")
        size = rows // n_micro
        leaves = list(tf.leaves(params))
        for p in leaves:
            p.grad = None
            p.requires_grad_(True)
        try:
            with torch.enable_grad():
                if n_micro == 1:
                    loss = loss_fn(params, batch)
                    loss.backward()
                    loss = loss.detach()
                else:
                    loss = torch.zeros((), dtype=torch.float32,
                                       device=batch["tokens"].device)
                    for i in range(n_micro):
                        micro = {k: v[i * size:(i + 1) * size]
                                 for k, v in batch.items()}
                        part = loss_fn(params, micro)
                        part.backward()
                        loss += part.detach()
                    loss /= n_micro
        finally:
            for p in leaves:
                p.requires_grad_(False)
        grads = _grads(params)
        if n_micro > 1:
            for g in tf.leaves(grads):
                g.div_(n_micro)
        params, opt_state, metrics = opt_mod.apply_updates(
            tcfg.adamw, params, grads, opt_state)
        for p in leaves:
            p.grad = None
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def jit_train_step(cfg: tf.ArchCfg, tcfg: TrainConfig, mesh,
                   params_shape=None, batch_shape=None):
    """The reference's sharded, donated step under ``jax.jit``: ROADMAP
    item 14.5."""
    raise NotImplementedError(ROADMAP_MESH)
