"""WAN traffic engineering (paper §3.2) — the port of
``repro/problems/traffic_engineering.py``: max-total-flow on a path
formulation.

    maximize   sum_j f_j              f_j = sum_p f_j^p
    s.t.       f_j <= d_j                         ∀ demands j
               sum_{j, p: e in p} f_j^p <= c_e    ∀ edges e
               f_j^p >= 0

POP split (the paper's recipe): each sub-problem keeps the WHOLE network
but a 1/k fraction of every link capacity; *commodities* (demands) are
partitioned.

The topology generator (Kentucky-Data-Link-like: 754 nodes / 1790 edges,
geometric), k-shortest-path precomputation, demand draw, the COO of the
structured operator and the CSPF heuristic are the reference's numpy code,
verbatim, so the same seeds give bit-equal arrays; the per-lane matvecs
``_k_mv``/``_kt_mv`` are torch, with ``index_add_`` where the reference
calls ``jax.ops.segment_sum``.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Optional

import numpy as np
import torch

from ..core.pdhg import OperatorLP, structured_from_coo
from ..core.plan import SubLayout
from ..core.pop import POPProblem


# ---------------------------------------------------------------------------
# topology + demands
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Topology:
    n_nodes: int
    edges: np.ndarray        # [E, 2] directed node pairs
    capacity: np.ndarray     # [E]
    adj: list                # adjacency: node -> list of (nbr, edge_id, length)


def make_topology(n_nodes: int = 754, target_edges: int = 1790,
                  seed: int = 0) -> Topology:
    """KDL-like geometric network: nodes scattered in the plane, each
    connected to nearest neighbours until the undirected edge budget is hit.
    Returned edge set is DIRECTED (both orientations), capacities in Gbps
    drawn from a WAN-ish mix."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 1, (n_nodes, 2))
    xy[:, 0] *= 2.0                                  # east-west elongation, KDL-ish
    # connect k nearest neighbours, dedupe
    d2 = ((xy[:, None, :] - xy[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    und = set()
    k_nn = 2
    while len(und) < target_edges:
        for u in range(n_nodes):
            for v in np.argsort(d2[u])[:k_nn]:
                und.add((min(u, int(v)), max(u, int(v))))
        k_nn += 1
    und = sorted(und)[:target_edges]
    # directed
    edges = np.array([(u, v) for u, v in und] + [(v, u) for u, v in und])
    caps_und = rng.choice([10.0, 40.0, 100.0], len(und), p=[0.5, 0.3, 0.2])
    capacity = np.concatenate([caps_und, caps_und])
    lengths = np.sqrt(((xy[edges[:, 0]] - xy[edges[:, 1]]) ** 2).sum(-1))
    adj = [[] for _ in range(n_nodes)]
    for e, (u, v) in enumerate(edges):
        adj[u].append((int(v), e, float(lengths[e])))
    return Topology(n_nodes=n_nodes, edges=edges, capacity=capacity, adj=adj)


def _dijkstra_tree(topo: Topology, src: int, weight_jitter: np.ndarray):
    """Shortest-path tree from src; returns (prev_edge[node] or -1)."""
    n = topo.n_nodes
    dist = np.full(n, np.inf)
    prev_edge = np.full(n, -1, np.int64)
    dist[src] = 0.0
    pq = [(0.0, src)]
    while pq:
        d, u = heapq.heappop(pq)
        if d > dist[u] + 1e-12:
            continue
        for v, e, w in topo.adj[u]:
            nd = d + w * weight_jitter[e]
            if nd < dist[v] - 1e-12:
                dist[v] = nd
                prev_edge[v] = e
                heapq.heappush(pq, (nd, v))
    return prev_edge


def k_shortest_paths(topo: Topology, pairs: np.ndarray, n_paths: int = 4,
                     max_len: int = 48, seed: int = 0) -> np.ndarray:
    """Approximate k-shortest paths via weight-perturbed Dijkstra trees
    (one tree per (source, draw): efficient for many demands sharing
    sources).  Returns path_edges [n_demands, n_paths, max_len] int32,
    -1 padded; duplicate paths are kept (harmless: they split flow)."""
    rng = np.random.default_rng(seed)
    E = topo.edges.shape[0]
    srcs = np.unique(pairs[:, 0])
    out = np.full((pairs.shape[0], n_paths, max_len), -1, np.int64)
    for draw in range(n_paths):
        jitter = (np.ones(E) if draw == 0
                  else rng.uniform(1.0, 1.0 + 0.6 * draw, E))
        trees = {int(s): _dijkstra_tree(topo, int(s), jitter) for s in srcs}
        for j, (s, t) in enumerate(pairs):
            prev = trees[int(s)]
            path = []
            node = int(t)
            while node != int(s) and prev[node] >= 0 and len(path) < max_len:
                e = prev[node]
                path.append(e)
                node = int(topo.edges[e, 0])
            if node == int(s):
                out[j, draw, : len(path)] = path[::-1]
    return out


def make_demands(topo: Topology, n_demands: int, seed: int = 0):
    """Gravity-ish random demands between distinct node pairs."""
    rng = np.random.default_rng(seed)
    pairs = rng.integers(0, topo.n_nodes, (n_demands, 2))
    same = pairs[:, 0] == pairs[:, 1]
    pairs[same, 1] = (pairs[same, 1] + 1) % topo.n_nodes
    size = rng.lognormal(-2.0, 1.0, n_demands)
    return pairs, size


# ---------------------------------------------------------------------------
# structured constraint operator
# ---------------------------------------------------------------------------

def _k_mv(data, x):
    """Rows: [demand caps (n), edge caps (E)].  x = f [n*P] flattened."""
    path_edges, edge_proto = data        # [n, P, L] int32; [E+1] proto
    n, P, L = path_edges.shape
    E = edge_proto.shape[0] - 1
    f = x.reshape(n, P)
    dem = f.sum(dim=1)
    # each unit of f[j,p] loads every edge on its path
    contrib = f[:, :, None].expand(n, P, L).reshape(-1)
    pe = path_edges.reshape(-1).long()
    seg = torch.where(pe >= 0, pe, E)
    edge_load = torch.zeros(E + 1, dtype=x.dtype, device=x.device).index_add_(
        0, seg, contrib)[:E]
    return torch.cat([dem, edge_load])


def _kt_mv(data, y):
    path_edges, edge_proto = data
    n, P, L = path_edges.shape
    E = edge_proto.shape[0] - 1
    y_dem = y[:n]
    y_edge = torch.cat([y[n: n + E], torch.zeros(1, dtype=y.dtype,
                                                 device=y.device)])
    pe = path_edges.long()
    pe = torch.where(pe >= 0, pe, E)
    g = y_dem[:, None] + y_edge[pe].sum(dim=2)           # [n, P]
    return g.reshape(-1)


class TrafficProblem(POPProblem):
    """Max-total-flow TE, POP-partitioned over COMMODITIES (capacity/k)."""

    K_mv = staticmethod(_k_mv)
    KT_mv = staticmethod(_kt_mv)

    def __init__(self, topo: Topology, pairs: np.ndarray, demand: np.ndarray,
                 path_edges: np.ndarray, coef_dtype: str = "float32"):
        self.topo = topo
        self.pairs = pairs
        self.demand = demand
        self.path_edges = path_edges                       # [n, P, L]
        self.n_entities = pairs.shape[0]
        # ELL coefficient storage ("float32"/"bfloat16"/"int8" — see
        # core/pdhg.quantize_structured); TE coefficients are all 1.0, so
        # even int8 is exact here and just shrinks the streamed payload
        self.coef_dtype = coef_dtype

    # --- partitioning hooks ---------------------------------------------------
    def entity_attrs(self):
        plen = (self.path_edges >= 0).sum(axis=2).mean(axis=1)
        return np.stack([self.demand, plen], axis=1)

    def entity_scores(self):
        return self.demand

    def source_groups(self):
        """Group key for the paper's Fig. 6 skewed split (same-source)."""
        return self.pairs[:, 0]

    def sub_layout(self, n_slots: int) -> SubLayout:
        """Warm-start remap layout (``core/plan.py``): x = f [n_slots * P]
        (slot ``s`` owns its P per-path flows — each demand's path set is a
        property of the demand, so the flows travel with it); rows =
        [demand caps (n_slots), edge caps (E)] with the edge-capacity block
        lane-global."""
        P = self.path_edges.shape[1]
        E = self.topo.edges.shape[0]
        return SubLayout(
            x_slot=np.arange(n_slots)[:, None] * P + np.arange(P)[None, :],
            y_slot=np.arange(n_slots)[:, None],
            x_global=np.empty(0, np.int64),
            y_global=n_slots + np.arange(E))

    # --- LP construction --------------------------------------------------------
    def build_sub(self, idx_row: np.ndarray, frac: float,
                  scale: Optional[np.ndarray] = None) -> OperatorLP:
        n_local = idx_row.shape[0]
        valid = idx_row >= 0
        g = np.maximum(idx_row, 0)
        pe = np.where(valid[:, None, None], self.path_edges[g], -1)
        dem = np.where(valid, self.demand[g], 0.0)
        if scale is not None:
            dem = dem * scale                              # replicated entities
        P = pe.shape[1]
        n_var = n_local * P
        E = self.topo.edges.shape[0]

        c = -np.ones(n_var)                                # max total flow
        # kill flow variables with no real path (or padded demand slots)
        has_path = (pe >= 0).any(axis=2).reshape(-1)
        u = np.where(has_path, np.inf, 0.0)
        u = np.minimum(u, np.repeat(dem, P) + 1e-9)        # f_j^p <= d_j too
        l = np.zeros(n_var)
        q = np.concatenate([dem, self.topo.capacity * frac])
        data = (torch.as_tensor(pe.astype(np.int32)),
                torch.zeros(E + 1, dtype=torch.float32))

        # ELL index metadata: demand rows sum each commodity's P flows,
        # edge rows sum every (commodity, path) crossing the edge — the
        # per-commodity path segment-sums as explicit gathers, unlocking
        # engine="fused_structured" (and, for the full problem at scale,
        # "fused_structured_full").  Edge-row width is the lane's worst
        # path congestion (data-dependent; stack_ops pads across lanes).
        fcol = np.broadcast_to(
            (np.arange(n_local)[:, None] * P + np.arange(P)[None, :])[:, :, None],
            pe.shape)
        on_edge = pe >= 0
        rows = np.concatenate([np.repeat(np.arange(n_local), P),
                               n_local + pe[on_edge]])
        cols = np.concatenate([np.arange(n_local * P), fcol[on_edge]])
        vals = np.ones(rows.shape[0])
        structured = structured_from_coo(rows, cols, vals,
                                         n_local + E, n_var,
                                         coef_dtype=self.coef_dtype)
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
        return OperatorLP(
            c=f32(c), q=f32(q), l=f32(l), u=f32(u),
            ineq_mask=torch.ones(q.shape[0], dtype=torch.bool), data=data,
            structured=structured)

    # --- solution handling --------------------------------------------------------
    def extract(self, op: OperatorLP, x: np.ndarray, idx_row: np.ndarray):
        P = self.path_edges.shape[1]
        return x[: idx_row.shape[0] * P].reshape(-1, P)

    def evaluate(self, f: np.ndarray) -> dict:
        """f: [n, P] per-path flows in GLOBAL entity order."""
        flow = f.sum(axis=1)
        # feasibility: recompute edge loads
        E = self.topo.edges.shape[0]
        load = np.zeros(E + 1)
        pe = np.where(self.path_edges >= 0, self.path_edges, E)
        np.add.at(load, pe.reshape(-1),
                  np.broadcast_to(f[:, :, None], pe.shape).reshape(-1))
        util = load[:E] / self.topo.capacity
        return {
            "total_flow": float(flow.sum()),
            "demand_satisfaction": float(flow.sum() / self.demand.sum()),
            "max_edge_util": float(util.max()),
            "overflow": float(np.maximum(load[:E] - self.topo.capacity, 0).sum()),
        }


# ---------------------------------------------------------------------------
# CSPF heuristic baseline (constrained shortest path first, over k paths)
# ---------------------------------------------------------------------------

def cspf_heuristic(prob: TrafficProblem, seed: int = 0) -> np.ndarray:
    """Greedy CSPF: demands in descending size; each routed on whichever of
    its precomputed paths has the largest residual bottleneck; allocation =
    min(demand, bottleneck).  Returns f [n, P]."""
    topo = prob.topo
    residual = topo.capacity.astype(np.float64).copy()
    n, P, L = prob.path_edges.shape
    f = np.zeros((n, P))
    order = np.argsort(-prob.demand)
    for j in order:
        best_p, best_bn = -1, 0.0
        for p in range(P):
            es = prob.path_edges[j, p]
            es = es[es >= 0]
            if es.size == 0:
                continue
            bn = residual[es].min()
            if bn > best_bn:
                best_bn, best_p = bn, p
        if best_p < 0:
            continue
        amt = min(prob.demand[j], best_bn)
        if amt <= 0:
            continue
        es = prob.path_edges[j, best_p]
        es = es[es >= 0]
        residual[es] -= amt
        f[j, best_p] = amt
    return f
