"""SLO-driven auto-tuning: measured curves choose the POP configuration
(the port of ``repro/tuning``).

Three layers:

* :mod:`repro_torch.tuning.profile` — the **offline profiler**: sweep
  (k, replication, backend, lanes) per domain on scaled-down probes on
  the device and seal the measurements into a versioned
  :class:`TuningProfile` artifact (``scripts/tune_torch.py``), in the
  reference's schema.  Every consumer validates with
  :func:`check_profile`.
* :mod:`repro_torch.tuning.slo` — the **SLO contract**: frozen, hashable
  :class:`SLOTarget` plus :func:`plan_for_slo`, the planner that picks
  the cheapest config whose interpolated curves meet the SLO (escalating
  hot-entity replication before shrinking k, per granular-POP).
* :mod:`repro_torch.tuning.online` — the **online refiner**
  (:class:`OnlineTuner`): per-session EMA curve estimates from each
  step's reported solve time/quality, re-planning only on violated or
  newly-slack SLOs, in power-of-two k moves routed through the plan
  repair path so warm state survives.

Entry point: ``PopService(profile=...).session(tenant, instance,
slo=SLOTarget(max_quality_loss=0.02))``.
"""

from __future__ import annotations

from .online import OnlineTuner, TuneEvent  # noqa: F401
from .profile import (  # noqa: F401
    PROFILE_VERSION,
    DomainCurves,
    ProfileError,
    TuningProfile,
    build_profile,
    check_profile,
    load_profile,
    profile_digest,
    save_profile,
)
from .slo import (  # noqa: F401
    SLOTarget,
    TunedPlan,
    latency_at,
    launch_defaults,
    plan_for_slo,
    quality_loss_at,
)

__all__ = [
    "PROFILE_VERSION",
    "TuningProfile",
    "DomainCurves",
    "ProfileError",
    "build_profile",
    "save_profile",
    "load_profile",
    "check_profile",
    "profile_digest",
    "SLOTarget",
    "TunedPlan",
    "plan_for_slo",
    "quality_loss_at",
    "latency_at",
    "launch_defaults",
    "OnlineTuner",
    "TuneEvent",
]
