"""Declarative POP domain registry (the port of ``repro/domains``).

Importing this package registers the domains ported so far:

============  ==========================================================
``gavel``     max-min fair cluster scheduling (§3.1)
``traffic``   WAN traffic engineering (§3.2)
============  ==========================================================
"""

from .base import DomainSpec
from .registry import get, names, register, spec_for

from . import gavel           # noqa: F401  (registers "gavel")
from . import traffic         # noqa: F401  (registers "traffic")

from .gavel import GavelInstance

__all__ = ["DomainSpec", "register", "get", "names", "spec_for",
           "GavelInstance"]
