"""The training step: microbatched gradient accumulation, bf16 compute
over f32 master parameters, per-period rematerialisation — the port of
``repro/train/train_step.py`` on one device.

Gradients come from autograd.  Each parameter leaf takes ``requires_grad``
for the step, and every microbatch's backward accumulates into the
leaf's one f32 ``.grad`` buffer (no gradient tree per microbatch); the sum
is divided by the number of microbatches, as the reference's scan does.
AdamW then updates the parameters and moments in place.

On a device mesh (``make_train_step(mesh=)``, ``jit_train_step``) the
parameters and AdamW's m and v are DTensors placed by the reference's
``param_specs`` and the batch by its ``batch_spec`` (rows over the data
axes).  The step is FSDP-like: each rank keeps its blocks, gathers a
period's parameters whole where the forward uses them (inside the period's
``checkpoint``, so remat gathers again in the backward), and runs the
whole model on its own rows; the gradient of a gathered block is its own
block (every rank of a ``model`` group runs the same rows), the data axes
are summed once a step, and AdamW updates each rank's blocks in place.
The ``model`` axis therefore shards memory, not work: each rank of a
``model`` group computes the same thing.  The reference shards the work
too (GSPMD's tensor parallelism); here that waits for DTensor sharding
rules of every op the models use (``topk`` and the one-hot dispatch of
``models/moe.py``, ``F.embedding``, the sLSTM loop).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core import placement as pl
from ..core.problem import resolve_device
from ..launch import shardings as sh
from ..models import transformer as tf
from . import optimizer as opt_mod

@dataclasses.dataclass(frozen=True)
class TrainConfig:
    n_microbatches: int = 1
    compute_dtype: str = "bfloat16"
    remat: bool = True
    unroll_segments: bool = False    # the dry run's cost probe (a no-op)
    # the reference's mesh knobs, which do nothing in the port (see
    # models.transformer.ModelOpts)
    sp_residual: bool = False
    bf16_barrier: bool = False
    gather_once: bool = False
    adamw: opt_mod.AdamWConfig = opt_mod.AdamWConfig()


def cross_entropy(logits, labels):
    """Mean cross-entropy over all positions, in f32."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - gold)


def make_loss_fn(cfg: tf.ArchCfg, tcfg: TrainConfig, mesh=None,
                 places=None):
    """``loss_fn(params, batch)``: the mean cross-entropy of the batch.
    On a mesh, ``places`` are the parameters' placements and ``params``
    this rank's blocks (see the module docstring)."""
    dtype = (torch.bfloat16 if tcfg.compute_dtype == "bfloat16"
             else torch.float32)
    opts = tf.ModelOpts(mesh=mesh, places=places)

    def loss_fn(params, batch):
        logits = tf.forward_train(
            params, cfg, batch["tokens"],
            enc_embeddings=batch.get("enc_embeddings"),
            remat=tcfg.remat, compute_dtype=dtype,
            unroll=tcfg.unroll_segments, opts=opts)
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


def _accumulate(loss_fn, params, batch, n_micro: int):
    """Forward and backward of every microbatch (contiguous row blocks of
    ``batch``) into each leaf's ``.grad``; returns ``(summed grads, mean
    loss)``.  The grads are the sum over microbatches, not yet divided."""
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
    return _grads(params), loss


def make_train_step(cfg: tf.ArchCfg, tcfg: TrainConfig, mesh=None):
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``.

    ``batch`` holds ``[B, ...]`` tensors on the parameters' device; with
    ``n_microbatches > 1`` it is cut into that many contiguous row blocks
    (``B`` must divide).  The parameters and ``opt_state``'s moments are
    updated in place and returned; ``metrics`` (``loss``, ``lr``,
    ``grad_norm``) are 0-d device tensors.  With ``mesh`` the step is the
    sharded one of :func:`jit_train_step` (DTensor inputs)."""
    if mesh is not None:
        return _sharded_step(cfg, tcfg, mesh)
    loss_fn = make_loss_fn(cfg, tcfg)
    n_micro = tcfg.n_microbatches

    def train_step(params, opt_state, batch):
        grads, loss = _accumulate(loss_fn, params, batch, n_micro)
        if n_micro > 1:
            for g in tf.leaves(grads):
                g.div_(n_micro)
        params, opt_state, metrics = opt_mod.apply_updates(
            tcfg.adamw, params, grads, opt_state)
        for p in tf.leaves(params):
            p.grad = None
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


# ---------------------------------------------------------------------------
# the sharded step
# ---------------------------------------------------------------------------

def _dp_all_reduce(t: torch.Tensor, mesh) -> None:
    """Sum ``t`` in place over every data-parallel axis of ``mesh``."""
    import torch.distributed as dist
    for axis in pl.dp_axes(mesh):
        dist.all_reduce(t, group=mesh.get_group(axis))


def _model_sharded(places, mesh) -> bool:
    """Whether a leaf's placements shard it over a ``model`` axis of more
    than one rank."""
    names = pl.axis_names(mesh)
    return any(p.is_shard() and names[i] == "model" and mesh.size(i) > 1
               for i, p in enumerate(places))


def sharded_global_norm(grads, places, mesh) -> torch.Tensor:
    """The global norm of gradients held as blocks: each leaf's sum of
    squares, a model-sharded leaf's summed over its ``model`` group, added
    in leaf order.  With no model axis of more than one rank this is
    ``optimizer.global_norm`` itself, op for op."""
    import torch.distributed as dist
    pairs = [(g, pl) for _, g, pl in opt_mod._zip_named(grads, places)]
    sums = [torch.sum(torch.square(g.to(torch.float32))) for g, _ in pairs]
    shard = [i for i, (_, pl) in enumerate(pairs) if _model_sharded(pl, mesh)]
    if shard:
        part = torch.stack([sums[i] for i in shard])
        dist.all_reduce(part, group=mesh.get_group("model"))
        for j, i in enumerate(shard):
            sums[i] = part[j]
    return torch.sqrt(sum(sums))


def _local(t):
    from torch.distributed.tensor import DTensor
    return t._local_tensor if isinstance(t, DTensor) else t


def _sharded_step(cfg: tf.ArchCfg, tcfg: TrainConfig, mesh):
    """The step on DTensor inputs: ``params``, ``opt_state.m``/``.v``
    placed by ``param_specs``, ``opt_state.step`` replicated, the batch
    by ``batch_spec``.  See the module docstring."""
    from torch.distributed.tensor import DTensor, Replicate
    n_micro = tcfg.n_microbatches
    n_dp = pl.dp_size(mesh)
    state = {}

    def train_step(params, opt_state, batch):
        if "places" not in state:
            state["places"] = pl.places_of(params)
            state["loss_fn"] = make_loss_fn(cfg, tcfg, mesh,
                                            state["places"])
        places = state["places"]
        local = pl.local_tree(params)
        grads, loss = _accumulate(state["loss_fn"], local,
                                  pl.local_tree(batch), n_micro)
        _dp_all_reduce(loss, mesh)
        loss /= n_dp
        for g in tf.leaves(grads):
            _dp_all_reduce(g, mesh)
            if n_micro * n_dp > 1:
                g.div_(n_micro * n_dp)
        gnorm = sharded_global_norm(grads, places, mesh)
        step = _local(opt_state.step)
        _, new_state, metrics = opt_mod.apply_updates(
            tcfg.adamw, local, grads,
            opt_mod.AdamWState(step=step, m=pl.local_tree(opt_state.m),
                               v=pl.local_tree(opt_state.v)),
            gnorm=gnorm)
        for p in tf.leaves(local):
            p.grad = None
        replicate = [Replicate()] * mesh.ndim
        opt_state = opt_mod.AdamWState(
            step=DTensor.from_local(new_state.step, mesh, replicate,
                                    run_check=False),
            m=opt_state.m, v=opt_state.v)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def place_params(params, mesh):
    """Global parameters (equal on every rank) as DTensors placed by
    ``param_specs``: each rank keeps its blocks, no collective runs."""
    return pl.distribute_tree(params, sh.param_specs(params, mesh), mesh)


def init_placed_params(gen: torch.Generator, cfg: tf.ArchCfg, mesh,
                       cast=None):
    """``init_params(gen, cfg)`` placed by ``param_specs``, each rank
    keeping its blocks as the parameters are drawn: the draws are the
    whole model's, in its order, so the parameters equal
    ``place_params(init_params(gen, cfg), mesh)``, but at most one period
    (or one unstacked leaf such as the embedding) lives whole beside this
    rank's blocks.  ``cast(subtree)`` is applied to each part's blocks
    (``models.serving_params`` for serving)."""
    def keep(tree):
        tree = pl.zip_map(lambda t, s: pl.block(t, pl.placements(s, mesh),
                                                mesh),
                          tree, sh.param_specs(tree, mesh))
        return tree if cast is None else cast(tree)

    shapes = tf.init_params(None, cfg)
    local = tf.init_params(gen, cfg, keep=keep)
    return pl.zip_map(lambda t, s, g: pl.from_local(
        t, pl.placements(s, mesh), mesh, g.shape),
        local, sh.param_specs(shapes, mesh), shapes)


def init_placed_state(params) -> opt_mod.AdamWState:
    """AdamW's state for placed parameters, built on their blocks: m and v
    zero and placed as the parameters, the step count replicated."""
    from torch.distributed.tensor import DTensor, Replicate
    local = opt_mod.init_state(pl.local_tree(params))

    def like(tree):
        return pl.zip_map(lambda t, p: DTensor.from_local(
            t, p.device_mesh, p.placements, run_check=False, shape=p.shape,
            stride=p.stride()), tree, params)

    mesh = next(tf.leaves(params)).device_mesh
    return opt_mod.AdamWState(
        step=DTensor.from_local(local.step, mesh,
                                [Replicate()] * mesh.ndim, run_check=False),
        m=like(local.m), v=like(local.v))


def place_opt_state(opt_state, mesh):
    """A global AdamW state placed as its parameters (``opt_state_specs``),
    the step count replicated."""
    specs = sh.opt_state_specs(sh.param_specs(opt_state.m, mesh))
    return opt_mod.AdamWState(
        step=pl.distribute(opt_state.step, pl.placements(pl.P(), mesh), mesh),
        m=pl.distribute_tree(opt_state.m, specs, mesh),
        v=pl.distribute_tree(opt_state.v, specs, mesh))


def place_batch(batch, mesh):
    """A global batch with its rows over the data axes (``batch_spec`` for
    [B, S] leaves, the rows alone for the others)."""
    return {k: pl.distribute(v, pl.placements(pl.leading_spec(mesh, v.ndim),
                                              mesh), mesh)
            for k, v in batch.items()}


def check_mesh_device(mesh, device=None) -> None:
    """Refuse a mesh off the card unless the caller named its device type
    (``device="cpu"``); with no card and no ``device`` this raises."""
    want = resolve_device(device)
    if mesh.device_type != want.type:
        raise ValueError(f"the mesh lies on {mesh.device_type!r}, not on "
                         f"{want.type!r}: pass device={mesh.device_type!r} "
                         "to run there")


def jit_train_step(cfg: tf.ArchCfg, tcfg: TrainConfig, mesh,
                   params_shape=None, batch_shape=None, device=None):
    """The sharded step with the reference's placements: parameters and
    AdamW's m/v by ``param_specs``, the step count and the metrics
    replicated, the batch by ``batch_spec``.  Inputs that are not
    DTensors yet (global tensors, equal on every rank) are placed on the
    way in; the returned parameters and state are the same DTensors,
    updated in place (the reference's donation).  ``params_shape`` and
    ``batch_shape`` are accepted for the reference's signature; the
    placements are read from the inputs themselves.  The mesh must lie
    on the card unless ``device`` names its device type
    (``check_mesh_device``)."""
    del params_shape, batch_shape
    check_mesh_device(mesh, device)
    from torch.distributed.tensor import DTensor
    step = _sharded_step(cfg, tcfg, mesh)

    def placed(params, opt_state, batch):
        if not isinstance(next(tf.leaves(params)), DTensor):
            params = place_params(params, mesh)
        if not isinstance(opt_state.step, DTensor):
            opt_state = place_opt_state(opt_state, mesh)
        if not isinstance(batch["tokens"], DTensor):
            batch = place_batch(batch, mesh)
        return step(params, opt_state, batch)

    return placed
