"""``popcheck`` for the port: static analysis + runtime sanitizers for the
POP hot path — the counterpart of ``repro/analysis``.

The port's hot path rests on invariants nothing in Python enforces: the
builders cached on hashable configs and operator identity, no host sync
inside the map step beyond the loop's chunk check and result readback,
CUDA kernels that sum in a fixed order, domains that declare the hooks
their fill style needs.  This package machine-checks them:

* :mod:`repro_torch.analysis.core` — the rule framework (findings,
  suppression comments, baseline snapshots, the runner
  ``scripts/popcheck_torch.py`` wraps).
* :mod:`repro_torch.analysis.hotpath` — host-sync-in-hot-path rule.
* :mod:`repro_torch.analysis.retrace` — retrace-hazard rule (fresh
  objects into cached builders, per-call ``torch.compile`` / CUDA graph
  capture).
* :mod:`repro_torch.analysis.cuda` — cuda-no-float-atomics rule (the
  counterpart of the reference's Pallas rules).
* :mod:`repro_torch.analysis.contracts` — deprecated-door,
  dtype-promotion, registry-contract, config-hashability and
  silent-except rules.
* :mod:`repro_torch.analysis.profiles` — profile-staleness rule
  (TuningProfile reads must go through ``check_profile``).
* :mod:`repro_torch.analysis.surface` — public-API drift vs
  ``docs/api_surface_torch.txt``.
* :mod:`repro_torch.analysis.runtime` — runtime sanitizers: a build
  counter and a host-sync tripwire for asserting that a steady-state
  ``PopSession.step()`` builds nothing and syncs only where the loop does
  by design.
* :mod:`repro_torch.analysis.faults` — fault injection for the serving
  layer (poisoned/dropped warm state, damaged checkpoints, inflated solve
  rates) driving the chaos suite behind docs/ROBUSTNESS.md.

Rule catalog + suppression syntax: ``docs/LINTS_torch.md``.
"""

from __future__ import annotations

from .core import (  # noqa: F401
    Finding,
    Project,
    RULES,
    load_baseline,
    run_popcheck,
    write_baseline,
)
from .faults import (  # noqa: F401
    FAULTS,
    corrupt_checkpoint,
    drop_warm_plan,
    inflate_rates,
    mismatch_warm,
    poison_warm,
    truncate_checkpoint,
)
from .runtime import (  # noqa: F401
    HostSyncError,
    RetraceError,
    SanitizerStats,
    host_sync_tripwire,
    retrace_guard,
    steady_state_guard,
)

# importing the rule modules registers their rules in RULES
from . import hotpath as _hotpath      # noqa: F401,E402
from . import retrace as _retrace      # noqa: F401,E402
from . import cuda as _cuda            # noqa: F401,E402
from . import contracts as _contracts  # noqa: F401,E402
from . import profiles as _profiles    # noqa: F401,E402
from . import surface as _surface      # noqa: F401,E402

__all__ = [
    "Finding",
    "Project",
    "RULES",
    "run_popcheck",
    "load_baseline",
    "write_baseline",
    "RetraceError",
    "HostSyncError",
    "SanitizerStats",
    "retrace_guard",
    "host_sync_tripwire",
    "steady_state_guard",
    "FAULTS",
    "poison_warm",
    "drop_warm_plan",
    "mismatch_warm",
    "inflate_rates",
    "truncate_checkpoint",
    "corrupt_checkpoint",
]
