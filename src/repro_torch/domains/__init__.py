"""Declarative POP domain registry (the port of ``repro/domains``).

Importing this package registers the domains ported so far:

================  ======================================================
``gavel``         max-min fair cluster scheduling (§3.1)
``load_balance``  E-Store shard placement (§3.3)
``traffic``       WAN traffic engineering (§3.2)
================  ======================================================
"""

from .base import DomainSpec, StepOutcome
from .registry import get, names, register, spec_for

from . import gavel           # noqa: F401  (registers "gavel")
from . import load_balance    # noqa: F401  (registers "load_balance")
from . import traffic         # noqa: F401  (registers "traffic")

from .gavel import GavelInstance
from .load_balance import BalanceInstance

__all__ = ["DomainSpec", "StepOutcome", "register", "get", "names",
           "spec_for", "GavelInstance", "BalanceInstance"]
