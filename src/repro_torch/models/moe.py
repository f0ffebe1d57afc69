"""MoE routing statistics and POP expert placement — the port of
``repro/models/moe.py:95-138``.

``expert_gate_load`` runs the router's top-k over a batch of activations
and sums each expert's normalised gate mass: the demand vector of the
registered ``moe_placement`` domain.  ``plan_expert_placement`` places the
experts onto devices through that domain (the paper's technique, fourth
scenario).  Both run on an explicit torch device; the MoE layer itself
(``init_moe``, ``moe``) belongs to the LM substrate (ROADMAP open items
§1, item 14).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.problem import resolve_device


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
    logits = torch.einsum("bsd,de->bse", x, router.to(x.dtype))
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, experts = torch.topk(probs, top_k, dim=-1)      # [B,S,k]
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
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
