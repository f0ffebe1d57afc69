"""Max-min fairness as an epigraph LP (Gavel-style policies) — the port of
``repro/core/maxmin.py``, numpy only and verbatim.

    maximize   min_m  s_m . x                    (s_m = scaled throughput row)
    subject to domain constraints

is rewritten with an epigraph variable t appended to x:

    minimize   -t
    subject to t - s_m . x <= 0   for all m      (epigraph rows)
               (domain constraints unchanged)

The helper below just assembles the epigraph inequality block; domain
problems append it to their own constraint operators.  Exact (no bisection
needed): PDHG solves the joint (x, t) LP directly — this replaces Gavel's
water-filling + solver loop.
"""

from __future__ import annotations

import numpy as np


def epigraph_rows(S: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Dense epigraph block for  t <= S x  (row per entity).

    S : [n_entities, n_vars] scaled-throughput rows.
    Returns (G_block [n, n_vars+1], h_block [n]) where the last column is t.
    """
    n, v = S.shape
    G = np.zeros((n, v + 1))
    G[:, :v] = -S
    G[:, v] = 1.0
    return G, np.zeros(n)


def maxmin_objective(n_vars: int) -> np.ndarray:
    """c for min -t with t as the last of n_vars+1 variables."""
    c = np.zeros(n_vars + 1)
    c[-1] = -1.0
    return c
