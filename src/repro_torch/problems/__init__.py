"""Problem domains ported so far: Gavel cluster scheduling (§3.1), WAN
traffic engineering (§3.2) and load balancing (§3.3), with the heuristic
baselines the paper compares against (Gandiva-like packing, CSPF,
E-Store's greedy)."""

from .cluster_scheduling import (GavelProblem, gandiva_heuristic,
                                 make_cluster_workload)
from .load_balancing import (LoadBalanceProblem, estore_greedy,
                             make_shard_workload)
from .traffic_engineering import (TrafficProblem, cspf_heuristic,
                                  k_shortest_paths, make_demands,
                                  make_topology)

__all__ = [
    "GavelProblem", "gandiva_heuristic", "make_cluster_workload",
    "LoadBalanceProblem", "estore_greedy", "make_shard_workload",
    "TrafficProblem", "cspf_heuristic", "make_topology", "make_demands",
    "k_shortest_paths",
]
