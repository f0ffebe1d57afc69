"""Mixture-of-Experts FFN and POP expert placement — the port of
``repro/models/moe.py``.

``moe`` is the reference's capacity-bounded top-k dispatch (Mesh-TF
style): each expert takes at most ``C = min(ceil(cf * S * top_k / E), S)``
tokens a sequence, a token's queue position in its expert is a cumulative
sum in f32, overflow drops the choice, and the renormalised gates combine
the experts' outputs; an always-on shared expert (Qwen-MoE) is added on
top.  ``expert_gate_load`` runs the same routing over a batch of
activations and sums each expert's normalised gate mass: the demand vector
of the registered ``moe_placement`` domain.  ``plan_expert_placement``
places the experts onto devices through that domain (the paper's
technique, fourth scenario).

On a mesh ``moe`` runs each rank's block of every expert's hidden dim
(``ax``); the dispatch is the same on every rank.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.problem import resolve_device
from .layers import activation_fn, init_mlp, mlp, normal


def init_moe(gen, d: int, d_ff_expert: int, n_experts: int,
             n_shared: int = 0, d_ff_shared: int = 0):
    s_in = 1.0 / math.sqrt(d)
    s_out = 1.0 / math.sqrt(d_ff_expert)
    p = {
        "router": normal(gen, (d, n_experts), s_in),
        "w_gate": normal(gen, (n_experts, d, d_ff_expert), s_in),
        "w_up": normal(gen, (n_experts, d, d_ff_expert), s_in),
        "w_down": normal(gen, (n_experts, d_ff_expert, d), s_out),
    }
    if n_shared > 0:
        p["shared"] = init_mlp(gen, d, d_ff_shared)
    return p


def _route(router, x, top_k: int):
    """The router's top-k: logits in ``x``'s dtype, softmax in f32, the
    chosen gates renormalised.  Returns ``(gate_vals, experts)``, each
    ``[B, S, top_k]``, highest gate first."""
    logits = torch.matmul(x, router.to(x.dtype))
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, experts = torch.topk(probs, top_k, dim=-1)
    return gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9), experts


def _routed(p, x, router, *, top_k: int, capacity_factor: float,
            activation: str):
    """The routed experts' output for ``x`` with ``router``'s top-k
    dispatch; the experts' leaves may be this rank's blocks of their
    hidden dim (the output is then this rank's part of the sum)."""
    B, S, D = x.shape
    E = router.shape[1]
    C = min(int(np.ceil(capacity_factor * S * top_k / E)), S)
    dt = x.dtype

    gate_vals, experts = _route(router, x, top_k)             # [B,S,k]
    # position of each (token, choice) in its expert's queue
    onehot = F.one_hot(experts, E).float()                    # [B,S,k,E]
    flat = onehot.reshape(B, S * top_k, E)
    pos_in_e = (torch.cumsum(flat, dim=1) * flat - 1.0).reshape(
        B, S, top_k, E)
    keep = (pos_in_e >= 0) & (pos_in_e < C)

    # dispatch / combine tensors [B, S, E, C]
    slot = torch.where(keep, pos_in_e, -1.0).long()
    cap_oh = F.one_hot(slot.clamp(min=0), C).float() * keep[..., None]
    kept = onehot * keep
    dispatch = torch.einsum("bske,bskec->bsec", kept, cap_oh)
    combine = torch.einsum("bsk,bske,bskec->bsec", gate_vals, kept, cap_oh)

    xe = torch.einsum("bsec,bsd->becd", dispatch.to(dt), x)   # [B,E,C,D]
    g = torch.einsum("becd,edf->becf", xe, p["w_gate"].to(dt))
    u = torch.einsum("becd,edf->becf", xe, p["w_up"].to(dt))
    ye = torch.einsum("becf,efd->becd", activation_fn(activation)(g) * u,
                      p["w_down"].to(dt))
    return torch.einsum("bsec,becd->bsd", combine.to(dt), ye)


def moe(p, x, *, top_k: int, capacity_factor: float = 1.25,
        activation: str = "silu", ax=None, places=None, sp: bool = False):
    """x: [B, S, D] -> [B, S, D].

    Capacity-bounded top-k dispatch: each expert processes at most
    ``C = ceil(cf * S * top_k / E)`` tokens a sequence (and never more than
    ``S``; 1 at decode); a choice past its expert's capacity is dropped.

    With ``ax`` (a ``ModelAxis``) ``x`` is the block's norm output and the
    experts' (and the shared expert's) leaves this rank's blocks of their
    hidden dim: the replicated router routes every token alike on every
    rank (its gradient is then partial), each rank runs its part of
    every expert, and the output is summed over the model axis once,
    after the combine.  A part whose hidden dim does not split runs whole
    on every rank."""
    kw = dict(top_k=top_k, capacity_factor=capacity_factor,
              activation=activation)
    if ax is None:
        y = _routed(p, x, p["router"], **kw)
        if "shared" in p:
            y = y + mlp(p["shared"], x, activation)
        return y
    hp, hr = ax.enter(x, sp)
    split = ax.dim(places["w_gate"]) is not None
    parts, whole = [], []
    (parts if split else whole).append(
        _routed(p, hp if split else hr, p["router"], **kw))
    if "shared" in p:
        if ax.dim(places["shared"]["w_gate"]) is not None:
            parts.append(mlp(p["shared"], hp, activation))
        else:
            whole.append(mlp(p["shared"], hr, activation))
    out = [ax.leave(_add(parts), sp)] if parts else []
    if whole:
        out.append(ax.leave_whole(_add(whole), sp))
    return _add(out)


def partial_leaves(ax, places) -> frozenset:
    """The replicated leaves whose gradient is partial on this rank: the
    router, where it feeds experts split on their hidden dim."""
    return frozenset({"router"} if ax.dim(places["w_gate"]) is not None
                     else ())


def _add(ts):
    return ts[0] if len(ts) == 1 else ts[0] + ts[1]


def expert_gate_load(p, x, *, top_k: int, device=None) -> np.ndarray:
    """Per-expert routing load from the router's gate statistics — the
    demand vector for POP expert placement (``repro_torch.domains.
    moe_placement``): the top-k routing of the reference's ``moe`` layer,
    each expert's normalised gate mass summed over every (batch, position,
    choice).

    ``p["router"]`` is the ``[D, E]`` router weight and ``x`` the ``[B, S,
    D]`` activations (tensors or arrays).  The logits are computed in
    ``x``'s dtype, the softmax in f32, as the reference does.  Runs on
    ``device`` (default: ``x``'s device when ``x`` is a tensor, else the
    CUDA device); returns float64 numpy ``[E]``."""
    if device is None and isinstance(x, torch.Tensor):
        device = x.device
    else:
        device = resolve_device(device)
    x = torch.as_tensor(x, device=device)
    router = torch.as_tensor(p["router"], device=device)
    E = router.shape[1]
    gate_vals, experts = _route(router, x, top_k)             # [B,S,k]
    load = torch.zeros(E, dtype=torch.float64, device=device).index_add_(
        0, experts.reshape(-1), gate_vals.reshape(-1).double())
    return load.cpu().numpy()


def plan_expert_placement(expert_load: np.ndarray, n_devices: int,
                          current: Optional[np.ndarray] = None, k: int = 4,
                          seed: int = 0, backend: str = "auto",
                          device=None) -> np.ndarray:
    """Place experts on devices to maximise the gate load served under
    per-device compute and memory caps, migrating as little expert-weight
    memory as possible — the registered ``moe_placement`` domain, solved on
    ``device`` (default: the CUDA device).  Returns the device id per
    expert."""
    from ..core.config import ExecConfig, SolveConfig
    from ..domains.moe_placement import (MoEPlacementInstance, SPEC,
                                         place_experts)

    expert_load = np.asarray(expert_load, np.float64)
    E = expert_load.shape[0]
    if current is None:
        current = np.arange(E) % n_devices
    inst = MoEPlacementInstance(
        load=expert_load, mem=np.ones(E),
        current=np.asarray(current, np.int64),
        cap=np.full(n_devices, np.ceil(2.0 * E / n_devices)),
        compute=np.full(n_devices, expert_load.sum() / n_devices))
    placement, _, _ = place_experts(
        inst,
        solve_cfg=SolveConfig(k=k, strategy="stratified", seed=seed,
                              min_per_sub=SPEC.default_solve.min_per_sub),
        exec_cfg=ExecConfig(backend=backend,
                            solver_kw=SPEC.default_exec.solver_kw),
        device=device)
    return placement
