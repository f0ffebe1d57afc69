"""Declarative POP domain registry (the port of ``repro/domains``).

Importing this package registers the paper's domains plus the MoE
placement scenario:

=================  =====================================================
``gavel``          max-min fair cluster scheduling (§3.1)
``load_balance``   E-Store shard placement (§3.3)
``moe_placement``  MoE expert placement (the §3.3 MILP re-targeted at an
                   expert fleet; onboarded through the registry alone)
``traffic``        WAN traffic engineering (§3.2)
=================  =====================================================
"""

from .base import DomainSpec, SpecProblem, StepOutcome
from .registry import get, names, register, spec_for

from . import gavel           # noqa: F401  (registers "gavel")
from . import traffic         # noqa: F401  (registers "traffic")
from . import load_balance    # noqa: F401  (registers "load_balance")
from . import moe_placement   # noqa: F401  (registers "moe_placement")

from .gavel import GavelInstance
from .load_balance import BalanceInstance
from .moe_placement import (MoEPlacementInstance, greedy_placement,
                            make_placement_instance, place_experts)

__all__ = [
    "DomainSpec", "SpecProblem", "StepOutcome",
    "register", "get", "names", "spec_for",
    "GavelInstance", "BalanceInstance", "MoEPlacementInstance",
    "make_placement_instance", "place_experts", "greedy_placement",
]
