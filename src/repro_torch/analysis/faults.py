"""Fault injection for the serving layer — the port of
``repro/analysis/faults.py``, written for warm iterates that may be torch
tensors on any device (a session restored from a checkpoint holds them on
the service's device) or host numpy (what a solve leaves).

Each injector pushes a live :class:`~repro_torch.service.PopSession` or a
checkpoint blob onto one rung of the serving ladder:

====================  =============================================
injector              intended rung / fault string
====================  =============================================
poison_warm           ``recovered`` via ``divergence:<n>`` (lane
                      quarantine, healthy lanes keep iterates)
drop_warm_plan        ``recovered`` via ``warm-state-mismatch``
mismatch_warm         ``recovered`` via ``warm-state-mismatch``
                      (iterate shapes disagree with the plan)
inflate_rates         ``degraded`` (``deadline:capped``/
                      ``deadline:best-effort``) or ``fallback``
                      (``deadline``) depending on the factor
truncate_checkpoint   cold restore, ``checkpoint_failures`` += 1
corrupt_checkpoint    cold restore, ``checkpoint_failures`` += 1
====================  =============================================

Injectors mutate in place (sessions) or return the damaged blob
(checkpoints); none of them touch solver internals — they only forge the
states a real deployment produces (a NaN'd iterate from a pathological
re-solve, a half-written checkpoint file, a machine running slow).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["FAULTS", "poison_warm", "drop_warm_plan", "mismatch_warm",
           "inflate_rates", "truncate_checkpoint", "corrupt_checkpoint"]


def poison_warm(session, lanes: Sequence[int] = (0,),
                value: float = np.nan) -> None:
    """NaN (or otherwise poison) the warm iterates of ``lanes`` — the state
    a diverging re-solve leaves behind.  The next ``step()`` must
    quarantine exactly those lanes and report ``divergence:<n>``."""
    warm = session._warm
    if warm is None or getattr(warm, "x", None) is None:
        raise ValueError("session has no pop warm state to poison — "
                         "step() it at least once first")
    # copy-then-replace, on the iterates' own device: the previous
    # result (and the caller's view of it) keeps its values
    x = (warm.x.clone() if isinstance(warm.x, torch.Tensor)
         else np.array(warm.x))
    x[list(np.asarray(lanes, int))] = value
    warm.x = x


def drop_warm_plan(session) -> None:
    """Drop the plan out from under the warm iterates — the shape of a bad
    deserialization or a stale hand-seeded result.  The next ``step()``
    must flag ``warm-state-mismatch`` and restart cold (no crash)."""
    warm = session._warm
    if warm is None:
        raise ValueError("session has no warm state to damage")
    warm.plan = None


def mismatch_warm(session, extra_cols: int = 3) -> None:
    """Resize the warm iterates so they no longer match the plan's shapes —
    a warm state carried across an instance-size change without a remap.
    Caught by the pre-solve shape check, never by the solver."""
    warm = session._warm
    if warm is None or getattr(warm, "x", None) is None:
        raise ValueError("session has no pop warm state to damage")
    x = warm.x
    if isinstance(x, torch.Tensor):
        warm.x = torch.cat([x, x.new_zeros((x.shape[0], extra_cols))], dim=1)
    else:
        x = np.asarray(x)
        warm.x = np.concatenate(
            [x, np.zeros((x.shape[0], extra_cols), x.dtype)], axis=1)


def inflate_rates(service, factor: float = 100.0,
                  key: Optional[tuple] = None) -> None:
    """Inflate the measured per-iteration solve rate(s) — the budget model
    now believes every iteration takes ``factor``x longer, which is what a
    thermally-throttled or oversubscribed host looks like.  Deadline-bound
    steps must degrade (capped/best-effort) or fall back, never blow the
    deadline silently."""
    keys = [key] if key is not None else list(service._rates)
    if not keys:
        raise ValueError("service has no measured rates yet — run at "
                         "least one fault-free step first")
    for k in keys:
        service._rates[k] = service._rates[k] * factor


def truncate_checkpoint(blob: bytes, keep_fraction: float = 0.5) -> bytes:
    """A torn write: keep only the first ``keep_fraction`` of the blob.
    ``restore()`` must report a failure and start cold, never crash."""
    return blob[:int(len(blob) * keep_fraction)]


def corrupt_checkpoint(blob: bytes, offset: Optional[int] = None) -> bytes:
    """Flip one byte (default: middle of the payload) — bit rot / a bad
    copy.  The payload hash check must catch it at restore time."""
    if not blob:
        raise ValueError("empty checkpoint blob")
    i = len(blob) // 2 if offset is None else offset
    out = bytearray(blob)
    out[i] ^= 0xFF
    return bytes(out)


# name -> injector, for table-driven chaos suites
FAULTS = {
    "poison-warm": poison_warm,
    "drop-warm-plan": drop_warm_plan,
    "mismatch-warm": mismatch_warm,
    "inflate-rates": inflate_rates,
    "truncate-checkpoint": truncate_checkpoint,
    "corrupt-checkpoint": corrupt_checkpoint,
}
