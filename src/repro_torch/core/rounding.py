"""MILP via LP relaxation + randomized rounding + greedy repair — the port
of ``repro/core/rounding.py``, numpy only and verbatim, so a given ``seed``
draws the same candidates bit for bit.

Branch-and-bound is a data-dependent tree search, so mixed-integer
allocation problems are solved the batched-accelerator way:

  1. solve the LP relaxation with PDHG (binary vars relaxed to [0, 1]),
  2. round the relaxation — deterministically (threshold) and with R
     randomized draws, keeping the best feasible candidate,
  3. hand near-feasible candidates to a domain-specific ``repair`` hook
     (e.g. load balancing greedily shifts fractional load between servers,
     ``problems/load_balancing.py``).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np


def round_relaxation(
    x_relaxed: np.ndarray,
    binary_mask: np.ndarray,
    *,
    feasible: Callable[[np.ndarray], bool],
    objective: Callable[[np.ndarray], float],
    repair: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    n_draws: int = 16,
    seed: int = 0,
) -> tuple[np.ndarray, float, bool]:
    """Return (x_int, objective, was_feasible)."""
    rng = np.random.default_rng(seed)
    frac = np.clip(x_relaxed[binary_mask], 0.0, 1.0)

    candidates = []
    det = x_relaxed.copy()
    det[binary_mask] = (frac >= 0.5).astype(x_relaxed.dtype)
    candidates.append(det)
    for _ in range(n_draws):
        draw = x_relaxed.copy()
        draw[binary_mask] = (rng.random(frac.shape) < frac).astype(x_relaxed.dtype)
        candidates.append(draw)

    best, best_obj, best_feas = None, np.inf, False
    for cand in candidates:
        if repair is not None:
            cand = repair(cand)
        feas = feasible(cand)
        obj = objective(cand)
        # prefer feasible; among feasible (or among infeasible), lower objective
        key = (not feas, obj)
        if best is None or key < (not best_feas, best_obj):
            best, best_obj, best_feas = cand, obj, feas
    return best, float(best_obj), bool(best_feas)
