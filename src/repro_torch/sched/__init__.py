"""Cluster scheduling (POP-Gavel) and the fault-tolerance/elasticity
runtime — the port of ``repro/sched``."""
from .gavel_service import GavelScheduler, JobSpec, SchedulerConfig
from .elastic import (HeartbeatMonitor, StragglerDetector, plan_remesh,
                      redispatch, scale_microbatches, speculative_backups)

__all__ = ["GavelScheduler", "JobSpec", "SchedulerConfig",
           "HeartbeatMonitor", "StragglerDetector", "plan_remesh",
           "redispatch", "scale_microbatches", "speculative_backups"]
