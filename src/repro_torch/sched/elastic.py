"""Fault tolerance and elasticity runtime: heartbeats, straggler detection,
elastic remesh planning and POP sub-problem re-dispatch — the port's own
copy of ``repro/sched/elastic.py`` (numpy only, as the reference's is).

At 1000+ nodes the failure model is: pods die (heartbeat timeout), pods
straggle (step-time outliers), and capacity changes (preemption /
backfill).  The runtime's job is to (a) notice fast, (b) shrink or grow
the data-parallel axis without a cold restart, and (c) re-dispatch work.

POP sub-problems are idempotent and stateless, the natural unit of
re-execution: when a worker dies mid-map-step its sub-problems are re-dealt
to survivors (``redispatch``); when the mesh shrinks, ``plan_remesh`` picks
the largest valid (data, model) grid.  The module is pure planning and
state machines, execution-agnostic.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np


# ---------------------------------------------------------------------------
# heartbeat failure detector
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class HeartbeatMonitor:
    """Phi-accrual-lite: a worker is DEAD after ``timeout_s`` silence,
    SUSPECT after ``suspect_s``."""
    timeout_s: float = 30.0
    suspect_s: float = 10.0
    last_seen: Dict[int, float] = dataclasses.field(default_factory=dict)

    def beat(self, worker: int, now: Optional[float] = None):
        self.last_seen[worker] = time.monotonic() if now is None else now

    def status(self, now: Optional[float] = None) -> Dict[int, str]:
        now = time.monotonic() if now is None else now
        out = {}
        for w, t in self.last_seen.items():
            dt = now - t
            out[w] = ("dead" if dt > self.timeout_s
                      else "suspect" if dt > self.suspect_s else "alive")
        return out

    def alive(self, now: Optional[float] = None) -> List[int]:
        return [w for w, s in self.status(now).items() if s != "dead"]


# ---------------------------------------------------------------------------
# straggler detection (step-time outliers)
# ---------------------------------------------------------------------------

class StragglerDetector:
    """Rolling median/MAD over per-worker step durations; a worker whose
    recent steps exceed median + k*MAD is a straggler.  Mitigation at the
    POP layer: its queued sub-problems are re-dealt (cheap, idempotent);
    at the training layer: it is flagged for remesh on next checkpoint."""

    def __init__(self, window: int = 32, k: float = 4.0):
        self.window = window
        self.k = k
        self.hist: Dict[int, List[float]] = {}

    def record(self, worker: int, duration_s: float):
        h = self.hist.setdefault(worker, [])
        h.append(duration_s)
        if len(h) > self.window:
            h.pop(0)

    def stragglers(self) -> List[int]:
        if not self.hist:
            return []
        all_steps = np.concatenate([np.asarray(h) for h in self.hist.values()])
        med = np.median(all_steps)
        mad = np.median(np.abs(all_steps - med)) + 1e-9
        out = []
        for w, h in self.hist.items():
            recent = np.median(np.asarray(h[-8:]))
            if recent > med + self.k * mad:
                out.append(w)
        return out


# ---------------------------------------------------------------------------
# elastic remesh planning
# ---------------------------------------------------------------------------

def plan_remesh(n_alive: int, model_parallel: int,
                multi_pod_threshold: int = 512) -> dict:
    """Largest usable (pod, data, model) grid for the surviving chips.

    ``model`` is fixed (weights are laid out for it); the data axis absorbs
    the loss.  Returns the plan + how many chips idle (spares pool)."""
    if n_alive < model_parallel:
        return {"ok": False, "reason": "fewer chips than model-parallel group"}
    data = n_alive // model_parallel
    used = data * model_parallel
    shape = ((2, data // 2, model_parallel)
             if used >= multi_pod_threshold and data % 2 == 0
             else (data, model_parallel))
    return {
        "ok": True,
        "mesh_shape": shape,
        "axis_names": (("pod", "data", "model") if len(shape) == 3
                       else ("data", "model")),
        "chips_used": used,
        "spares": n_alive - used,
        # global batch is kept constant by scaling microbatches:
        "microbatch_scale": None,
    }


def scale_microbatches(global_batch: int, n_micro_old: int, data_old: int,
                       data_new: int) -> int:
    """Keep the global batch (and therefore the optimizer trajectory) fixed
    across a resize by growing grad-accumulation steps."""
    per_dev_micro = global_batch // (n_micro_old * data_old)
    n_new = int(np.ceil(global_batch / (per_dev_micro * data_new)))
    while global_batch % (n_new * data_new):
        n_new += 1
    return n_new


# ---------------------------------------------------------------------------
# POP sub-problem re-dispatch
# ---------------------------------------------------------------------------

def redispatch(assignment: Dict[int, List[int]], dead: List[int],
               alive: List[int]) -> Dict[int, List[int]]:
    """Re-deal sub-problems owned by dead workers to the least-loaded
    survivors.  Sub-problems are idempotent (pure LP solves) so this is
    safe even if a 'dead' worker later returns a stale answer."""
    assignment = {w: list(s) for w, s in assignment.items()}
    orphaned = []
    for w in dead:
        orphaned.extend(assignment.pop(w, []))
    for w in alive:
        assignment.setdefault(w, [])
    for sub in orphaned:
        target = min(alive, key=lambda w: len(assignment[w]))
        assignment[target].append(sub)
    return assignment


# ---------------------------------------------------------------------------
# deadline-based speculative re-execution (map-step stragglers)
# ---------------------------------------------------------------------------

def speculative_backups(pending: Dict[int, float], now: float,
                        deadline_s: float) -> List[int]:
    """Sub-problems past their deadline get a backup copy elsewhere (first
    answer wins) — classic MapReduce speculation, valid here because POP
    sub-problem solves are deterministic and side-effect-free."""
    return [sub for sub, started in pending.items()
            if now - started > deadline_s]
