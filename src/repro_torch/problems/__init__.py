"""Problem domains ported so far: Gavel cluster scheduling (§3.1) and WAN
traffic engineering (§3.2), with the heuristic baselines the paper
compares against (Gandiva-like packing, CSPF)."""

from .cluster_scheduling import (GavelProblem, gandiva_heuristic,
                                 make_cluster_workload)
from .traffic_engineering import (TrafficProblem, cspf_heuristic,
                                  k_shortest_paths, make_demands,
                                  make_topology)

__all__ = [
    "GavelProblem", "gandiva_heuristic", "make_cluster_workload",
    "TrafficProblem", "cspf_heuristic", "make_topology", "make_demands",
    "k_shortest_paths",
]
