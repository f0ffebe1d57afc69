"""Seeded inputs for holding the port against its plain versions and
against the reference package: one copy, used by ``tests/test_torch_*.py``
and by ``chip_smoke.py``.

* :func:`skewed_coo` / :func:`skewed_operator`: a stacked skewed K (one
  full row, one full column), the skewed shapes of the reference's kernel
  tests;
* :func:`step_operands` / :func:`step_tensors`: the vectors of one PDHG
  half-step pair, numpy f32 or tensors on a device;
* :func:`session_workloads` / :func:`session_instances`: a three-step Gavel
  session (cold, a +-3% throughput drift, then job churn under stable ids);
* :func:`balance_ops`: the stacked POP-k relaxation a cold load-balancing
  step builds (or the single-lane full one), optionally with its ELL
  metadata; :func:`balance_session`: a three-step load-balancing session
  (cold, a +-5% load drift on the previous placement, then shard churn
  under stable ids);
* :func:`moe_session`: a three-step MoE expert-placement session (cold, a
  load drift on the previous placement, then expert churn under stable
  ids);
* :func:`traffic_arrays` / :func:`traffic_problem`: a traffic-engineering
  instance (topology, demands, k-shortest paths) from three seeds;
* :func:`ragged_coo` / :func:`ragged_operator`: a single-lane K whose wide
  row bucket spans several ragged wide-block plan blocks;
* :func:`random_dense_lps` / :func:`dense_stack`: random bounded-feasible
  dense LPs and their stacked operator (the dense engine sweep's inputs);
* :func:`densify`: a prepared structured stack as its dense ``(K,)`` twin;
* :func:`to_device` / :func:`teacher_forcing`: an LM parameter tree moved to
  a device, and a model's teacher-forced logits beside its decode path's;
  :func:`bf16_logit_tol`: the bound on two bf16 evaluations of one model;
* :func:`router_tie_guard`: fail any MoE routing with a tie at the top-k
  cut; :func:`train_batch`: a seeded batch for one train step;
  :data:`PARITY_ADAMW`: the optimizer settings of train-step comparisons.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch


def skewed_coo(k: int, M: int, N: int, density: float, sparse: bool,
               seed: int = 0):
    """Per-lane ``(rows, cols, vals)`` of a stacked skewed K [k, M, N]:
    random entries at ``density`` plus one full row and one full column.
    Dense packing stores every entry, zeros included, so every segment is
    as wide as K and no bucket is wide; ``sparse`` stores only the
    nonzeros, which sends the full row and column to the wide buckets."""
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(k, M, N)) * (rng.random((k, M, N)) < density)
    G[:, M // 2, :] = rng.normal(size=(k, N))
    G[:, :, N // 3] = rng.normal(size=(k, M))
    coo = []
    for g in G:
        r, c = np.nonzero(g) if sparse else np.indices(g.shape).reshape(2, -1)
        coo.append((r, c, g[r, c]))
    return coo


def skewed_operator(k: int, M: int, N: int, density: float, sparse: bool,
                    seed: int = 0):
    """The port's stacked :class:`StructuredOperator` (CPU) of
    :func:`skewed_coo`."""
    from .core import pdhg
    lanes = [pdhg.OperatorLP(
        c=torch.zeros(N), q=torch.zeros(M), l=torch.zeros(N),
        u=torch.zeros(N), ineq_mask=torch.ones(M, dtype=torch.bool), data=(),
        structured=pdhg.structured_from_coo(r, c, v, M, N))
        for r, c, v in skewed_coo(k, M, N, density, sparse, seed)]
    return pdhg.stack_ops(lanes).structured


def step_operands(k: int, M: int, N: int, seed: int = 1) -> dict:
    """The operands of one forward and one backward half-step on a [k, M, N]
    stack, numpy f32 (``mask`` bool): iterates, costs and bounds with
    ``l < u``, step sizes in [0.01, 0.2]."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)
    x, c, kty = f(k, N), f(k, N), f(k, N)
    l = f(k, N) - 2.0
    u = l + rng.uniform(0.5, 3.0, (k, N)).astype(np.float32)
    tau = rng.uniform(0.01, 0.2, k).astype(np.float32)
    y, q, kxn, kxp = f(k, M), f(k, M), f(k, M), f(k, M)
    sigma = rng.uniform(0.01, 0.2, k).astype(np.float32)
    mask = rng.random((k, M)) < 0.6
    return dict(x=x, c=c, l=l, u=u, tau=tau, kty=kty, y=y, q=q, sigma=sigma,
                mask=mask, kxn=kxn, kxp=kxp)


def step_tensors(s, device, seed: int = 1) -> dict:
    """:func:`step_operands` for the stacked operator ``s``, as tensors on
    ``device``."""
    k, _, M = s.row_idx.shape
    return {name: torch.as_tensor(v, device=device) for name, v in
            step_operands(k, M, s.col_idx.shape[-1], seed).items()}


def session_workloads(n_jobs: int, num_workers, churn: float,
                      make_workload=None, seed: int = 0):
    """``[(workload, job_ids)]`` for three steps of one Gavel session: cold,
    a +-3% throughput drift on the same jobs, then ``churn`` of the jobs
    replaced by fresh ones under new ids (the rest keep theirs).

    ``make_workload`` defaults to the port's ``make_cluster_workload``; the
    parity tests pass the reference's, which draws the same arrays.
    ``seed`` draws another tenant: the workload from ``seed``, the drift
    from ``seed + 1`` and the fresh jobs from ``seed + 2`` (0 gives the
    arrays this function has always drawn)."""
    if make_workload is None:
        from .problems.cluster_scheduling import make_cluster_workload
        make_workload = make_cluster_workload
    wl = make_workload(n_jobs, num_workers=num_workers, seed=seed)
    ids = np.arange(n_jobs)
    rng = np.random.default_rng(seed + 1)
    wl2 = dataclasses.replace(wl, T=wl.T * rng.uniform(0.97, 1.03,
                                                      wl.T.shape))
    n_out = max(1, int(round(churn * n_jobs)))
    fresh = make_workload(n_out, num_workers=num_workers, seed=seed + 2)
    keep = np.arange(n_out, n_jobs)

    def cat(a, b):
        return np.concatenate([a[keep], b])

    wl3 = dataclasses.replace(
        wl2, T=cat(wl2.T, fresh.T), w=cat(wl2.w, fresh.w),
        z=cat(wl2.z, fresh.z),
        interference=cat(wl2.interference, fresh.interference),
        job_type=cat(wl2.job_type, fresh.job_type))
    ids3 = np.concatenate([ids[keep], n_jobs + np.arange(n_out)])
    return [(wl, ids), (wl2, ids), (wl3, ids3)]


def session_instances(n_jobs: int, num_workers, churn: float,
                      seed: int = 0):
    """:func:`session_workloads` as the port's ``GavelInstance`` list."""
    from .domains import GavelInstance
    return [GavelInstance(wl, job_ids=ids)
            for wl, ids in session_workloads(n_jobs, num_workers, churn,
                                             seed=seed)]


def balance_ops(prob, k: int, device, structured: bool = False):
    """The stacked POP-k operator ``LoadBalanceProblem.pop_solve`` builds on
    a cold step (its server grouping, shard subsets and load windows) on
    ``device``, with the ELL metadata when ``structured``; for ``k == 1``
    the single-lane full relaxation (a k=1 stack)."""
    from .core import pdhg
    wl = prob.wl
    if k == 1:
        op = prob._relax_op(np.arange(wl.n_shards), np.arange(wl.n_servers),
                            wl.n_shards, wl.n_servers, structured=structured,
                            device=device)
        return pdhg.map_arrays(lambda a: a[None], op)
    groups, shard_sets, s_pad, n_pad, _, _ = prob._pop_split(k)
    windows = prob._sub_windows(shard_sets, groups)
    return pdhg.stack_ops([
        prob._relax_op(s, g, n_pad, s_pad, L_target=wl.target, eps_eff=e,
                       structured=structured, device=device)
        for s, g, e in zip(shard_sets, groups, windows)])


def balance_session(step, n_shards: int, n_servers: int, churn: float, *,
                    eps_frac: float = 0.15, seed: int = 0,
                    make_workload=None, instance=None):
    """Drive three ticks of a load-balancing session through ``step(inst)
    -> Allocation`` and return ``(instances, allocations)``:

    1. cold: ``make_shard_workload(n_shards, n_servers, eps_frac=eps_frac,
       seed=seed)`` on its own skewed placement, ids ``arange(n_shards)``;
    2. drift: every load x U(0.95, 1.05), the previous step's placement as
       the current one, the same ids;
    3. churn: ``int(churn * n_shards)`` shards leave, as many arrive from a
       pool of ``2 * n_shards`` (seed 9) onto uniformly drawn servers with
       fresh ids; every load x U(0.97, 1.03); survivors keep their ids and
       their placement.

    ``make_workload`` / ``instance`` default to the port's
    ``make_shard_workload`` / ``BalanceInstance``; the parity tests pass
    the reference's, which draw the same arrays."""
    if make_workload is None:
        from .problems.load_balancing import make_shard_workload
        make_workload = make_shard_workload
    if instance is None:
        from .domains import BalanceInstance
        instance = BalanceInstance
    wl = make_workload(n_shards, n_servers, eps_frac=eps_frac, seed=seed)
    pool = make_workload(2 * n_shards, n_servers, eps_frac=eps_frac, seed=9)
    rng = np.random.default_rng(1_000 + seed)
    ids = np.arange(n_shards)
    insts = [instance(wl.load, n_servers, current=wl.placement,
                      eps_frac=eps_frac, ids=ids)]
    allocs = [step(insts[-1])]
    load = wl.load * rng.uniform(0.95, 1.05, n_shards)
    insts.append(instance(load, n_servers, current=allocs[-1].alloc,
                          eps_frac=eps_frac, ids=ids))
    allocs.append(step(insts[-1]))
    n_out = int(churn * n_shards)
    keep = np.sort(rng.choice(n_shards, n_shards - n_out, replace=False))
    new = rng.choice(2 * n_shards, n_out, replace=False)
    insts.append(instance(
        np.concatenate([load[keep], pool.load[new]])
        * rng.uniform(0.97, 1.03, n_shards), n_servers,
        current=np.concatenate([allocs[-1].alloc[keep],
                                rng.integers(0, n_servers, n_out)]),
        eps_frac=eps_frac,
        ids=np.concatenate([ids[keep], n_shards + np.arange(n_out)])))
    allocs.append(step(insts[-1]))
    return insts, allocs


def moe_session(step, n_experts: int, n_devices: int, drift: float,
                churn: float):
    """Drive three ticks of an MoE expert-placement session through
    ``step(inst) -> Allocation`` and return ``(instances, allocations)``:

    1. cold: ``make_placement_instance(n_experts, n_devices, seed=0)``
       on its own load-oblivious placement, ids ``arange(n_experts)``;
    2. drift: every load x ``drift``, the previous step's placement as the
       current one, the same ids;
    3. churn: ``int(churn * n_experts)`` experts retire, as many arrive
       from a pool of ``2 * n_experts`` (seed 9) onto uniformly drawn
       devices with fresh ids; survivors keep their ids and placement."""
    from .domains import make_placement_instance
    inst = make_placement_instance(n_experts, n_devices, seed=0)
    pool = make_placement_instance(2 * n_experts, n_devices, seed=9)
    rng = np.random.default_rng(2_000)
    ids = np.arange(n_experts)
    insts = [dataclasses.replace(inst, ids=ids)]
    allocs = [step(insts[-1])]
    insts.append(dataclasses.replace(insts[-1], load=inst.load * drift,
                                     current=allocs[-1].alloc))
    allocs.append(step(insts[-1]))
    n_out = int(churn * n_experts)
    keep = np.sort(rng.choice(n_experts, n_experts - n_out, replace=False))
    new = rng.choice(2 * n_experts, n_out, replace=False)
    prev = insts[-1]
    insts.append(dataclasses.replace(
        prev, load=np.concatenate([prev.load[keep], pool.load[new]]),
        mem=np.concatenate([prev.mem[keep], pool.mem[new]]),
        current=np.concatenate([allocs[-1].alloc[keep],
                                rng.integers(0, n_devices, n_out)]),
        ids=np.concatenate([ids[keep], n_experts + np.arange(n_out)])))
    allocs.append(step(insts[-1]))
    return insts, allocs


def traffic_arrays(n_demands: int, n_nodes: int = 754,
                   target_edges: int = 1790, n_paths: int = 4,
                   max_len: int = 48, topo_seed: int = 0,
                   demand_seed: int = 1, path_seed: int = 2,
                   make=None):
    """``(topology, pairs, demand, path_edges)`` of one traffic-engineering
    instance: a KDL-like topology (754 nodes, 1,790 undirected edges by
    default), ``n_demands`` demands and ``n_paths`` k-shortest paths of at
    most ``max_len`` edges per demand.  ``make`` is a module providing
    ``make_topology``/``make_demands``/``k_shortest_paths`` (default: the
    port's; the parity tests pass the reference's, which draws the same
    arrays)."""
    if make is None:
        from .problems import traffic_engineering as make
    topo = make.make_topology(n_nodes, target_edges, seed=topo_seed)
    pairs, demand = make.make_demands(topo, n_demands, seed=demand_seed)
    paths = make.k_shortest_paths(topo, pairs, n_paths=n_paths,
                                  max_len=max_len, seed=path_seed)
    return topo, pairs, demand, paths


def traffic_problem(n_demands: int, coef_dtype: str = "float32", **kw):
    """The port's ``TrafficProblem`` over :func:`traffic_arrays`."""
    from .problems.traffic_engineering import TrafficProblem
    return TrafficProblem(*traffic_arrays(n_demands, **kw),
                          coef_dtype=coef_dtype)


def ragged_coo(n_wide: int = 300, n_narrow: int = 400, n_cols: int = 6000,
               max_width: int = 300, seed: int = 0):
    """``(rows, cols, vals, n_rows, n_cols)`` of a block-diagonal
    ``K = [[A, 0], [0, B^T]]``: A and B each have ``n_wide`` wide rows
    (widths drawn in ``[20, max_width]``) and ``n_narrow`` rows of 1-3
    entries over ``n_cols`` columns.  Both wide buckets then span several
    128-column plan blocks of different depths, deeper than one row chunk
    of the CUDA kernels, while the median segment stays narrow."""
    rng = np.random.default_rng(seed)

    def block():
        widths = np.concatenate([rng.integers(20, max_width + 1, n_wide),
                                 rng.integers(1, 4, n_narrow)])
        r = np.repeat(np.arange(widths.size), widths)
        c = np.concatenate([rng.choice(n_cols, w, replace=False)
                            for w in widths])
        return r, c, rng.normal(size=r.size)

    (ra, ca, va), (rb, cb, vb) = block(), block()
    m_a = n_wide + n_narrow
    rows = np.concatenate([ra, m_a + cb])
    cols = np.concatenate([ca, n_cols + rb])
    return rows, cols, np.concatenate([va, vb]), m_a + n_cols, n_cols + m_a


def ragged_operator(coef_dtype: str = "float32", **kw):
    """The port's single-lane (``[1, ...]``) :class:`StructuredOperator`
    (CPU) of :func:`ragged_coo`."""
    from .core import pdhg
    s = pdhg.structured_from_coo(*ragged_coo(**kw), coef_dtype=coef_dtype)
    return pdhg.map_arrays(lambda a: a[None], s)


def shared_segment_operator(M: int = 500, N: int = 700, n_wide: int = 6,
                            seed: int = 14):
    """A single-lane (``[1, ...]``) :class:`StructuredOperator` (CPU) of
    random sparse entries plus ``n_wide`` rows over 300 columns each and
    ``n_wide`` columns over 300 rows each (``n_wide`` real bucket columns
    on each side), whose second and third bucket columns on each side are
    then sent onto the first one's segment: three bucket columns add onto
    one segment, as the plain version's ``index_add_`` allows."""
    from .core import pdhg
    rng = np.random.default_rng(seed)
    rows, cols = [rng.integers(0, M, 4000)], [rng.integers(0, N, 4000)]
    for d in range(n_wide):
        rows += [np.full(300, 7 * d), rng.integers(0, M, 300)]
        cols += [rng.choice(N, 300, replace=False), np.full(300, 11 * d)]
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    s = pdhg.structured_from_coo(rows, cols, rng.normal(size=rows.size),
                                 M, N)
    s = pdhg.map_arrays(lambda a: a[None], s)
    ids = {}
    for name in ("wrow_ids", "wcol_ids"):
        wids = getattr(s, name).clone()
        wids[0, 1:3] = wids[0, 0]
        ids[name] = wids
    return s._replace(**ids)


def random_dense_lps(k: int, n: int, mi: int, seed: int = 0) -> list:
    """``[(c, G, h)]``, float64 numpy, of ``k`` random bounded-feasible LPs
    ``min c x, G x <= h, 0 <= x <= 1`` (``h`` leaves slack at an interior
    point), drawn in turn from one ``default_rng(seed)`` as the reference's
    engine sweep draws them (``benchmarks/bench_pop_scaling.py``)."""
    rng = np.random.default_rng(seed)
    parts = []
    for _ in range(k):
        c = rng.normal(size=n)
        G = rng.normal(size=(mi, n))
        h = G @ rng.uniform(0.2, 0.8, n) + rng.uniform(0.1, 1.0, mi)
        parts.append((c, G, h))
    return parts


def dense_stack(parts, device):
    """The stacked dense :class:`~repro_torch.core.pdhg.OperatorLP` of
    :func:`random_dense_lps`' parts on ``device``: each LP built (and
    128-padded) by ``LinearProgram.build`` with the box [0, 1]."""
    from .core import pdhg
    from .core.problem import LinearProgram
    lps = [LinearProgram.build(c=c, G=G, h=h, l=np.zeros(c.shape[0]),
                               u=np.ones(c.shape[0]), device=device)
           for c, G, h in parts]
    return pdhg.stack_ops([pdhg.dense_ops(lp) for lp in lps])


def densify(ops):
    """A stacked structured operator's dense twin: ``data = (K,)`` with K
    ``[k, M, N]`` materialised by ``pdhg.structured_to_dense`` (on the
    host) and moved to the device of ``ops``; ``structured`` dropped."""
    from .core import pdhg
    K = pdhg.structured_to_dense(ops.structured).to(ops.c.device)
    return ops._replace(data=(K,), structured=None)


def to_device(tree, device):
    """A copy of an LM parameter tree (dicts and lists of tensors) on
    ``device`` (a copy on the same device too: a train step updates its
    parameters in place)."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device, copy=True)


def teacher_forcing(params, cfg, toks, dtype, enc=None):
    """``(forward_train``'s logits, the decode path's logits token by
    token``)``, each ``[B, S, V]`` f32 on the host; computed in ``dtype``
    on the device of ``toks``, with a cache in ``dtype``."""
    from . import models
    train = models.forward_train(params, cfg, toks, enc_embeddings=enc,
                                 compute_dtype=dtype)
    mem = (None if enc is None
           else models.encode(params, cfg, enc, compute_dtype=dtype))
    cache = models.init_cache(cfg, toks.shape[0], toks.shape[1],
                              kv_dtype=dtype, device=toks.device)
    out = []
    for i in range(toks.shape[1]):
        lg, cache = models.forward_decode(params, cfg, toks[:, i: i + 1],
                                          cache, enc_memory=mem,
                                          compute_dtype=dtype)
        out.append(lg[:, 0])
    return train.float().cpu(), torch.stack(out, 1).float().cpu()


def bf16_logit_tol(f32_logits, bf16_logits) -> float:
    """The bound on two bf16 evaluations of one model's logits (another
    implementation, or another path through the same one), given a
    trusted pair: ``bf16_logits`` from a trusted path in bf16 and
    ``f32_logits`` from it in f32.  Each bf16 evaluation lies about
    ``e = max|bf16 - f32|`` from the f32 result, so two of them lie within
    ``2 e`` of each other (the triangle inequality, with the other path no
    less accurate than the trusted one).  Readings and controls:
    ``tools/bf16_bound.py``."""
    f32 = np.asarray(f32_logits, np.float32)
    bf16 = np.asarray(bf16_logits, np.float32)
    return 2.0 * float(np.abs(bf16 - f32).max())


# AdamW's fields for holding two train steps against each other (the
# port against the reference, the card against the CPU): the reference's
# arch smoke schedule (the full 3e-4 at step 1) with eps 1e-6.  At the
# default eps of 1e-8 the first update is g / (|g| + 1e-8), so an element
# whose gradient lies within f32 noise of zero (measured on zamba2:
# |g| about 1e-9, of opposite signs in the two packages) moves by
# anything within +-lr, and the parameters would compare noise.
PARITY_ADAMW = dict(warmup_steps=1, total_steps=4, eps=1e-6)


@contextlib.contextmanager
def router_tie_guard():
    """While active, every MoE routing of the port checks that no two gates
    tie at the top-k cut and raises ``AssertionError`` if they do:
    ``torch.topk`` may order equal gates differently on another device or
    in another package, so a comparison with a tie is no comparison."""
    from .models import moe
    route = moe._route

    def checked(router, x, top_k):
        probs = torch.softmax(torch.matmul(x, router.to(x.dtype)).float(),
                              dim=-1)
        top = torch.topk(probs, min(top_k + 1, probs.shape[-1]), dim=-1)[0]
        if not bool(((top[..., :-1] - top[..., 1:]) > 0).all()):
            raise AssertionError("tied router gates at the top-k")
        return route(router, x, top_k)

    moe._route = checked
    try:
        yield
    finally:
        moe._route = route


def train_batch(cfg, batch: int, seq: int, seed: int = 0, device="cpu"):
    """``{"tokens", "labels"[, "enc_embeddings"]}`` drawn with numpy from
    ``seed`` (labels independent of the tokens; six encoder frames for an
    encoder-decoder config) as tensors on ``device``."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (batch, seq)),
           "labels": rng.integers(0, cfg.vocab, (batch, seq))}
    if cfg.enc_segments:
        out["enc_embeddings"] = rng.normal(
            0, 1, (batch, 6, cfg.d_model)).astype(np.float32)
    return {k: torch.as_tensor(v).to(device) for k, v in out.items()}


@contextlib.contextmanager
def gloo_world():
    """A ("data", "model") mesh over a gloo world of one in this process
    (``make_host_mesh(device="cpu")``); a process group this block started
    is destroyed when it ends, so no later code in the process sees it."""
    import torch.distributed as dist

    from .launch.mesh import make_host_mesh
    started = not dist.is_initialized()
    try:
        yield make_host_mesh(device="cpu")
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
