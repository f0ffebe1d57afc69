#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of POP (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which must pass:

1. card      the card's name and power limit (nvidia-smi); TF32 off;
2. build     compile the hand-written CUDA kernels from the sources in
             ``src/repro_torch/kernels/csrc`` (one nvcc per source, all
             started together, sm_90a);
3. lm-reduced each of the 10 architectures of ``repro_torch.configs`` at
             its reduced size: one parameter set made on the host and
             carried to the card, ``forward_train`` and 8 ``forward_decode``
             steps (f32, TF32 off, an f32 cache) against the same port on
             the CPU within 1e-4, with equal greedy tokens; then one train
             step (2 microbatches, f32, ``testing.PARITY_ADAMW``, every
             MoE routing checked for a top-k tie) on the card against the
             CPU: loss, grad_norm (relative), parameters, m and v within
             1e-4;
4. serve     llama3-8b at full width (32 layers, d_model 4,096, GQA 32/8,
             vocab 128,256; random f32 parameters from a seed on the card)
             through ``repro_torch.launch.serve``: teacher forcing on a
             16-token prefix in f32 (within 1e-3) and, after the serving
             cast to bf16, in bf16 (within ``testing.bf16_logit_tol``:
             twice the f32-to-bf16 distance of forward_train); then 8
             sequences, a 2,048-slot bf16 KV cache, a 128-token prompt
             prefilled through the decode path and 64 greedy tokens, twice
             from the same seed (bit-equal tokens, finite logits): ms per
             decode step from CUDA events, tokens per second,
             ``max_memory_allocated`` and the step's bound (the bf16
             weights read once, the embedding table only gathered, plus the
             KV cache, over 3.35 TB/s);
5. serve-balanced ``examples_torch/serve_balanced.py --fast`` on the card:
             the balancer session's placements valid, each replica's
             greedy tokens in the vocabulary;
6. train     llama3-8b at full width with its depth cut from 32 to 8
             layers by memory (f32 parameters, gradients, m and v: 16 B a
             parameter, 128.5 GB whole, 44.7 GB at 8 layers): 6 steps of
             8 x 1,024 tokens from ``TokenPipeline`` through
             ``DevicePrefetcher``, 2 microbatches, bf16 compute, remat,
             the reference's AdamW defaults; ms a step from CUDA events,
             tokens/s, the model FLOPs' share of the bf16 peak,
             ``max_memory_allocated`` against the state; loss and
             grad_norm finite, the last loss below the first, every leaf
             changed; then remat on against off (2 layers, f32, every
             gradient within 1e-6 of its leaf's largest) and one f32 step
             of 1 layer on 2 x 64 tokens on the card against the CPU (loss
             and grad_norm within 1e-4, parameters within 1e-5);
7. train-driver xlstm-350m whole (24 layers) through ``python -m
             repro_torch.launch.train`` in a child process: 8 steps with a
             checkpoint at step 4, then 12 steps resumed from it (``resumed
             from step 4``, a finite final loss); each run's wall;
8. train-e2e ``examples_torch/train_e2e.py --model-scale full --steps 8
             --fail-at 4 --ckpt-every 2`` in a child process (``across
             restart``), then the reference's restart check at that
             scale: the step after a restored checkpoint bit-equal to the
             uninterrupted one (loss and every parameter);
9. kernels   each kernel against its plain PyTorch version on the card:
             the lane kernels at the main path's stacked Gavel shapes and
             at skewed test shapes; the full-problem kernels at the
             traffic-engineering shape of 20,000 demands, at the Gavel
             full LP of 16,384 jobs and at two small ragged cases, each in
             f32, bf16 and int8 coefficient storage; each with its time
             beside the plain version's, a ``torch.sparse`` CSR product of
             the same K (timed in turns with the kernel) and the bound, and
             the earlier design's times beside; where each structured
             wrapper's host time goes (``[host]``: ops dispatch, checks,
             allocations, the ctypes call, 1,000 calls each);
10. main      the main path: an online Gavel POP session through
             ``PopService(device="cuda")`` at 16,384 jobs on 12,288
             accelerators, registry defaults (k=8, equilibrate), three
             steps (cold, a +-3% throughput drift, 5% job churn with
             stable ids); every lane converges and the allocation beats
             the Gandiva heuristic's fairness twice over, as the
             reference's own test holds it (``tests/test_problems.py``);
11. tune      the tuner: ``tuning.build_profile`` over the gavel, traffic
             and moe_placement probes at ``fast=False`` on the card, with
             no other thread running (its curves, launch line,
             ``launch_defaults``, thresholds, the engines its solves ran
             and its wall); its seal through ``save_profile`` /
             ``load_profile``; a session on the main path's fleet planned
             from it at ``SLOTarget(max_quality_loss=0.02)`` (cold, drift,
             churn: the planned k, predicted against measured step, each
             lane converged or run to the domain's cap, above twice
             Gandiva's fairness, within the SLO of the untuned k=8 steps,
             and equal bit for bit to an untuned session at the planned
             configs); a session under an impossible
             deadline stepped until the online tuner doubles k (the next
             steps warm); the lane kernels against their plain versions at
             both sessions' stacks; ``dispatch=True`` sized by the launch
             line;
12. moe       MoE expert placement: ``benchmarks/bench_moe_placement.py``'s
             defaults (512 experts on 16 devices: full, POP-4, POP-8, the
             greedy) held to ``tests/test_domains.py``'s gates; a
             ``moe_placement`` session at 4,096 experts on 64 devices
             (cold, a +3% drift, 10% churn) with the greedy beside each
             step; ``expert_gate_load`` at DeepSeek-V3's router width
             (7,168 x 256, top-8, bf16, 16,384 tokens) fed to
             ``plan_expert_placement`` onto 64 devices;
13. robust    the serving ladder on the main path's instances through its
             own ``PopService`` (``main``'s session untouched): a cold
             step and a hit to measure the ladder's rates; NaN in warm
             lane 3 and a step on the drifted fleet, which must come back
             ``recovered`` with the lane quarantined, 8/8 converged and
             beating Gandiva's mean throughput, the retry (one lane cold
             beside seven warm) through the lane kernels, one CUDA launch
             per half-step; deadlines of 100 s (``ok``), a budget of about
             1,000 iterations (``degraded``) and inflated rates
             (``fallback`` to the previous allocation within twice its
             deadline); a checkpoint restored into a fresh service, its
             next step a warm hit matching the uninterrupted session's;
             truncated and corrupted blobs restored cold; two tenants
             under ``max_resident=1``, the paged-in one a warm hit; the
             lane kernels' counts put back afterwards;
steady       the main path's steady state under
             ``repro_torch.analysis.runtime``: the tripwire's own check
             (a ``.item()`` on the armed thread denied twice under
             ``torch.cuda.set_sync_debug_mode("warn")``); a fresh
             16,384-job session warmed through miss, hit and repair, then
             four warm steps (three hits, a churn repair) each under
             ``steady_state_guard(max_retraces=0)``: no build, no denied
             sync, the chunk checks (lane-max iterations over 40, plus the
             exit test) and the ten readbacks counted, every lane
             converged, the session's peak device memory; then four
             tenants in one held round of a 32-lane dispatcher, guarded
             the same way; ``[steady]`` lines;
quickstart   ``examples_torch/quickstart.py`` at its default size in a
             child process: every line checked, the full LP on
             ``fused_structured_full`` (rows 3-4) and the sessions on
             ``fused_structured`` (rows 1-2), each kernel launched in the
             child, the full LP's peak device memory;
14. async     async serving through ``PopService(dispatch=
             DispatchConfig(max_lanes=32))``: four tenants of the main
             path's size (seeds 0-3) step cold, then drifted, through
             ``step_async`` under ``hold()``, each round one 32-lane launch
             of the lane kernels (one CUDA launch a half-step, no group
             fallback); three of them churned (24 lanes, padded to 32);
             then a mixed round: two tenants share a 16-lane launch, an
             8,192-job tenant launches on its own key, and a k=1 tenant of
             512 jobs on the streaming engine launches inline on its own
             thread (the full kernels).  Every step against the same step
             run one after another without a dispatcher (equal per-lane
             iterations, ``mean_norm_throughput`` within 1e-4), every lane
             converged and the minimum above twice Gandiva's; then the
             first two rounds through ``step_async`` without a dispatcher;
             steps per second of the three ways, each round's prepare
             share, ``side_pack`` per new operator, and a profiled round's
             device busy share;
15. profile   one more warm step under ``torch.profiler``: device time by
             kernel and the device's busy share;
steady-profile one more warm step of ``steady``'s session, a profiler
             session (CUDA activity) around its map step: the CUDA
             runtime's synchronizing calls it records, less an empty
             session's (the profiler's own ``cudaDeviceSynchronize``),
             equal the tripwire's allowed count;
16. full      the unpartitioned traffic-engineering baseline at 20,000
             demands on the KDL-like topology through ``pop.solve_full_ex``
             (the ``fused_structured_full`` engine): the domain's
             defaults, then int8 coefficient storage (the same trajectory:
             TE coefficients are all 1.0), then a fixed budget against the
             plain engine on the same card inputs, then the f32 solve at
             30,000 iterations (the full-LP quality gate); then profiled
             fixed budgets of the full solve at the traffic shape (f32,
             int8) and at the Gavel full shape (f32, equilibrated);
17. traffic   a POP session on the same instance (domain defaults: k=8
             stratified): a cold step, every demand x 1.05 (a warm hit),
             and the CSPF heuristic beside POP and the full LP; a
             converged full LP must carry at least 99% of CSPF's flow;
18. gavel-full the unpartitioned Gavel LP of the main path's fleet (Gavel
             defaults, equilibrate), its fairness beside POP's;
19. balance-kernels the lane and full kernels at load-balancing shapes
             (1,024 shards on 64 servers): the stacked POP-4 relaxation and
             the single-lane full one with their ELL metadata, each solved
             at the conformance budget with the kernels, their plain
             versions on the card and the ``matvec`` engine (within 1e-5,
             equal iterations, one CUDA launch per half-step), their ELL
             fill and per-call times;
20. balance  the paper's Fig. 5 (``benchmarks/bench_load_balancing.py``):
             the full relax-and-round, POP-k for k = 2, 4, 8, 16 and
             E-Store's greedy at 1,024 shards on 64 servers, held to the
             reference's gates (``tests/test_problems.py``); the matvec
             engine's stacked and per-lane forms at POP-16 in turns; CUDA
             kernels per PDHG iteration of each run (two profiled fixed
             budgets); the host's relaxation build and repair, timed by
             wrapping them from here;
21. balance-session the ``load_balance`` domain through
             ``PopService(device="cuda")`` at its defaults (k=4): 8,192
             shards on 256 servers, cold, a +-5% load drift (a hit), 5%
             shard churn (a repair, warm fraction 0.950), E-Store's greedy
             beside each step; valid placements within twice the load
             window;
22. moe-profile one more step of the MoE session (a hit) under the
             profiler: kernels and device time per PDHG iteration;
23. redesign the redesigned kernels' device times under the profiler:
             ``structured_forward_step`` and ``structured_backward_step``
             at 4, 8 and 16 blocks a lane (main-path shape),
             ``structured_full_forward_step`` in one launch and after a
             tail launch, in turns (traffic shape), and
             ``structured_full_backward_step`` at the traffic shape (f32,
             int8) and the Gavel full shape; run after the paths, since a
             profiler session slows every later host call;
24. kernels-dense the four dense kernels (``bmatvec``, ``bmatvec_t``,
             ``fused_forward_step``, ``fused_backward_step``) against their
             plain versions at the densified main-path stack [8, 4,099,
             6,145], the dense engine sweep's [32, 256, 256] and the
             reference's ragged kernel-test shapes, f32 and (for the
             matvecs) bf16 coefficients; each with its time beside the
             plain version's, one ``torch.bmm`` of the same product (plus
             the tail in torch for the half-steps, timed in turns) and the
             bound;
25. redesign-dense the redesigned matvecs' device times under the
             profiler at the densified stack, f32 and bf16 A, in turns
             with ``torch.bmm``, each one CUDA launch a call and
             bit-for-bit the same twice, beside the earlier design's;
26. dense    the main path's k=8 Gavel stack densified
             (``pdhg.structured_to_dense``) through ``backends.solve_map(
             engine="auto")``, which must take the ``fused`` engine: the
             launch counts against the count the code predicts, a fixed
             budget against ``fused_structured`` on the same stack, a solve
             at the Gavel defaults (every lane converges, fairness within
             1e-3 of the structured path's solve of the same instance), and
             a profiled fixed budget; one CUDA launch a matvec call, and
             fairness within 1e-4 of the earlier design's;
27. dense-sweep ``fused`` against ``matvec`` on random dense LP stacks
             [k, 256, 256], k = 1..32 (the reference's engine sweep,
             ``benchmarks/bench_pop_scaling.py``), a fixed budget of 2,000
             iterations: equal iterations, times, the engines' distance;
28. solve-dense ``pdhg.solve_dense`` at the reference's ``pdhg_vs_scipy``
             size against scipy's HiGHS, at the reference test's bounds.

The mesh layer (``torch.distributed`` on an NCCL world of one, the
("data", "model") mesh of ``make_host_mesh()``) runs in five phases, the
first four after train-e2e, the last after main:

mesh-train   llama3-8b at full width cut to 8 layers, 2 steps of 8 x 1,024
             tokens (2 microbatches, bf16, remat) through
             ``make_train_step`` and through ``jit_train_step`` on the
             (1, 1) mesh from the same seed and batches (state built on
             the mesh by ``init_placed_params``, batches staged by
             ``DevicePrefetcher(mesh=)``): losses, grad norms and every
             parameter bit-equal; ms a step, tokens/s,
             ``max_memory_allocated``; the FLOPs ``launch.dryrun`` counts
             for the same cell (a child process); a checkpoint of the
             embedding and final norm written from the mesh;
mesh-serve   llama3-8b at full width, batch 8, a 2,048-slot cache, a
             16-token prompt and 16 greedy tokens through the unsharded
             step and through ``jit_serve_step`` on the mesh: tokens and
             the final logits (the step's own) bit-equal, ms a step of
             each;
mesh-collectives ``compressed_psum`` over NCCL against the local int8
             round trip with error feedback (two rounds, bit for bit);
             mesh-train's checkpoint restored onto the mesh, bit-equal;
mesh-tp      tensor parallelism across two processes on the one card, a
             (1, 2) mesh over gloo (NCCL refuses two ranks on one
             device): llama3-8b at full width in bf16, batch 8, a
             2,048-slot cache, a 16-token prompt and 16 decode steps,
             each rank computing its heads, its FFN columns and its vocab
             block, held against the world-of-one step run first in the
             same call: the split run is teacher-forced with the world of
             one's 16 greedy tokens, and every step's logits lie within
             that step's ``testing.bf16_logit_tol`` of the world of one's
             (its f32 and bf16 logits from the same tokens); the split
             run's own greedy token equals the world of one's except
             where its top two logits lie closer than that tolerance;
             ms a step of each and each rank's
             ``max_memory_allocated`` (at most 0.6 of the world of one's);
             then one f32 train step of llama3-8b cut to 2 layers under
             ``testing.PARITY_ADAMW`` within 1e-5 of the unsharded step
             (loss, grad_norm, every parameter block);
mesh-pop     the main path's three steps through ``PopService`` with
             ``backend="shard_map"`` (the mesh's "data" axis), again at
             ``chunk=1``, and ``backend="pmap"`` over its default devices
             (``[cuda:0]`` on one card): allocations and
             per-lane iterations bit-equal to main's ``vmap`` session,
             build_s / solve_s beside vmap's, the lane kernels' launches
             over each session (zeroed just before), and the lane kernels
             held against their plain versions at a lane slice
             ``shard_map`` launched.

The kernels' launch counts (calls and, for the structured kernels and the
matvecs, the CUDA launches the calls made, printed per call on the
``[launches]`` lines) are set to 0 just before each path and read just
after it: the lane kernels' over the main path, over the tune phase's
profile and its tuned session, and over each round of the async phase
(with the full kernels'; put back afterwards); the full
kernels' over
each of the traffic f32 solve (the count the JSON line reports), the int8
solve, the fixed-budget kernel run and the Gavel full solve; the lane and
full kernels' again over each kernel solve of the balance-kernels phase;
the dense
kernels' over the dense path's Gavel-defaults solve (the count the JSON
line reports) and its fixed budget.  Prints one JSON line of kernel
results, then the card line, and as the last line ``{"ok": true,
"device": {...}}``.  Exits nonzero, printing no result, without a CUDA
device or outside the repository.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import shutil
import subprocess
import sys
import time
import traceback
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

N_JOBS = 16_384
NUM_WORKERS = (4096, 4096, 4096)
CHURN = 0.05
# traffic engineering: the KDL-like topology (754 nodes, 1,790 undirected
# edges; topology seed 0, demands seed 1, paths seed 2), 4 paths of at most
# 48 edges, the default size of benchmarks/bench_traffic_engineering.py
TE_DEMANDS = 20_000
FULL_FIXED_ITERS = 200
# the full-LP quality gate's budget: the reference converges TE-20k at
# 27,000 iterations (tools/te_full_reference.py)
TE_LONG_ITERS = 30_000
PROFILE_FULL_ITERS = 400
# NVIDIA H100 SXM data sheet: HBM3 rate and f32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# tails: bit-equal (every op rounded to nearest, no FMA, as the plain
# version's separate elementwise ops); products: another summation order,
# held at the reference's product tolerance (tests/test_kernels.py)
PRODUCT_RTOL = PRODUCT_ATOL = 1e-4
# fixed-budget solves, kernel engine against the plain engine on the card
SOLVE_ATOL = SOLVE_RTOL = 1e-4
KERNEL_SOURCE = {
    "structured_forward_step":
        "src/repro_torch/kernels/csrc/structured_pdhg_step.cu",
    "structured_backward_step":
        "src/repro_torch/kernels/csrc/structured_pdhg_step.cu",
    "structured_full_forward_step":
        "src/repro_torch/kernels/csrc/structured_full_pdhg_step.cu",
    "structured_full_backward_step":
        "src/repro_torch/kernels/csrc/structured_full_pdhg_step.cu",
    "fused_forward_step": "src/repro_torch/kernels/csrc/fused_pdhg_step.cu",
    "fused_backward_step": "src/repro_torch/kernels/csrc/fused_pdhg_step.cu",
    "bmatvec": "src/repro_torch/kernels/csrc/pdhg_matvec.cu",
    "bmatvec_t": "src/repro_torch/kernels/csrc/pdhg_matvec.cu",
}
REPLACES = {
    "structured_forward_step": "src/repro/kernels/structured_pdhg_step.py:110",
    "structured_backward_step": "src/repro/kernels/structured_pdhg_step.py:141",
    "structured_full_forward_step":
        "src/repro/kernels/structured_pdhg_step.py:312",
    "structured_full_backward_step":
        "src/repro/kernels/structured_pdhg_step.py:334",
    "fused_forward_step": "src/repro/kernels/fused_pdhg_step.py:87",
    "fused_backward_step": "src/repro/kernels/fused_pdhg_step.py:116",
    "bmatvec": "src/repro/kernels/pdhg_matvec.py:67",
    "bmatvec_t": "src/repro/kernels/pdhg_matvec.py:89",
}
COEF_DTYPES = ("float32", "bfloat16", "int8")
# the dense path: the reference's ragged kernel-test shapes
# (tests/test_kernels.py) and its engine sweep's LPs (benchmarks/
# bench_pop_scaling.py: n=150, mi=90, padded to [256, 256], k = 1..32) at
# its 2,000 iterations, as a fixed budget: at its tolerances of 1e-6 a
# lane's f32 score sits near the threshold, so the two engines' sums in
# another order can stop it one check apart, and the engines would not do
# the same work
DENSE_TEST_SHAPES = ((1, 128, 128), (3, 300, 180), (4, 64, 512),
                     (2, 512, 64), (8, 129, 257))
SWEEP_KS = (1, 2, 4, 8, 16, 32)
SWEEP_N, SWEEP_MI = 150, 90
SWEEP_KW = dict(max_iters=2_000, tol_primal=0.0, tol_gap=0.0)
SWEEP_REPEATS = 3
DENSE_FIXED_ITERS = 200
PROFILE_DENSE_ITERS = 400
# bf16 coefficients: the reference's kernel-test tolerance
BF16_RTOL = BF16_ATOL = 2e-2
# the reference's pdhg_vs_scipy size and tests/test_pdhg.py's bounds
SCIPY_N, SCIPY_MI = 300, 200
# PERF.md section 6: the structured kernels' times before their redesign
# to one launch a half-step (NVIDIA H100 80GB HBM3, 700 W): per call, ms
# with the host, device ms and the torch.sparse CSR product's ms, printed
# beside this run's; each from the last whole run of its earlier design
EARLIER_MS = {
    "structured_forward_step": (0.0264, 0.0058, 0.0314),
    "structured_backward_step": (0.0450, 0.0056, 0.0252),
    "structured_full_forward_step": (0.0831, 0.0316, 0.0399),
    "structured_full_backward_step": (0.0604, 0.0258, 0.0477),
    # the dense matvecs before their redesign to a stream of whole-row
    # slabs (the last whole run of the earlier design, PERF.md section 6),
    # at the densified stack [8, 4,099, 6,145], f32 and bf16 A, the
    # library call torch.bmm; no device time was taken in bf16
    ("bmatvec", "float32"): (0.2810, 0.2799, 0.2791),
    ("bmatvec_t", "float32"): (0.3152, 0.3097, 0.3102),
    ("bmatvec", "bfloat16"): (0.2267, None, 0.1658),
    ("bmatvec_t", "bfloat16"): (0.1806, None, 0.1770),
}
STRUCTURED_NAMES = ("structured_forward_step", "structured_backward_step",
                    "structured_full_forward_step",
                    "structured_full_backward_step")
MATVEC_NAMES = ("bmatvec", "bmatvec_t")
# the dense path's Gavel-defaults solve before the matvecs' redesign:
# mean_norm_throughput, held within DENSE_MEAN_TOL (the power iteration
# sums in another order now, so its iterations may move)
DENSE_MEAN_EARLIER = 0.414357
DENSE_MEAN_TOL = 1e-4
# the redesigned kernels: the lane kernels' block counts and the forward
# full kernel's single and two-launch variants measured, calls per
# profiled window, calls per piece of the host breakdown
CLUSTERS = (4, 8, 16)
FULL_VARIANTS = (1, 2)
PROFILE_CALLS = 200
HOST_CALLS = 1_000
# load balancing: the Fig. 5 comparison at the default size of
# benchmarks/bench_load_balancing.py, held at the conformance matrix's
# budget (tests/test_engine_conformance.py) for the kernels, and a
# session at 8x its shard count with bench_churn.py's 32 shards a server
BALANCE_SHARDS, BALANCE_SERVERS = 1_024, 64
BALANCE_KS = (2, 4, 8, 16)
BALANCE_KW = dict(max_iters=12_000, tol_primal=1e-4, tol_gap=1e-4)
CONFORMANCE_KW = dict(max_iters=120, check_every=40, tol_primal=0.0,
                      tol_gap=0.0)
BALANCE_TOL = 1e-5
SESSION_SHARDS, SESSION_SERVERS = 8_192, 256
SESSION_EPS, SESSION_CHURN = 0.15, 0.05
# fixed budgets: the matvec forms in turns, and the two profiled budgets
# whose difference gives the kernels per PDHG iteration
FORM_ITERS = 400
LAUNCH_ITERS = (80, 160)
# async serving: four Gavel tenants at the main path's size, coalesced
ASYNC_SEEDS = (0, 1, 2, 3)
ASYNC_LANES = 32
# the mixed round's two tenants that cannot share the 16,384-job launch: a
# Gavel tenant of 8,192 jobs (other lane shapes, its own key) and a k=1
# tenant of 512 jobs on the streaming engine (no key: it launches inline;
# converged in about 3,000 iterations on the CPU, where 1,024 jobs ran to
# the 20,000-iteration cap)
ASYNC_OTHER_JOBS = 8_192
ASYNC_FULL_JOBS = 512
ASYNC_FULL_WORKERS = (128, 128, 128)
# the dispatcher's window: wide enough that a released round's last ticket
# joins it; a full 32-lane group launches at once
ASYNC_WAIT_MS = 20.0
# each tenant against its synchronous step
ASYNC_MEAN_TOL = 1e-4
# the profiled round's fixed budget: its length does not hang on one lane
ASYNC_PROFILE_ITERS = 2_000
# a round of four 16,384-job tenants against PERF.md's step limit (printed)
ASYNC_STEP_LIMIT_S = 2.0
# the kernels on the async path's operators against their plain versions:
# a conformance-budget solve's x and y (rtol = atol), as balance-kernels
ASYNC_KERNEL_TOL = 1e-5
# the steady phase: the solve loop's chunk (pdhg.solve_stacked's
# check_every), the seed of its churned and drifted instances, and the CUDA
# runtime calls that block the host (a plain cudaMemcpy* counts too)
STEADY_CHECK_EVERY = 40
STEADY_CHURN_SEED = 11
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cuStreamSynchronize",
              "cuCtxSynchronize", "cuEventSynchronize")
QUICKSTART = ROOT / "examples_torch" / "quickstart.py"
# the tuner: build_profile over the generic domains at fast=False (what
# scripts/tune.py writes by default), a session on the main path's fleet
# at a 2% quality loss, and a session under tests/test_tuning.py's
# impossible deadline, stepped until the online tuner retunes k
TUNE_DOMAINS = ("gavel", "traffic", "moe_placement")
TUNE_SLO_LOSS = 0.02
TUNE_DEADLINE_S = 1e-4
TUNE_MAX_STEPS = 4
# MoE expert placement: benchmarks/bench_moe_placement.py's defaults, held
# to tests/test_domains.py's gates; a session of 16 DeepSeek-V3 MoE layers'
# 256 routed experts placed together on a 64-GPU expert-parallel group
# (domain defaults: k=4, min_per_sub=8, 8,000 iterations), a +3% load
# drift, then 10% of the experts replaced; the router statistics at
# DeepSeek-V3's width (d_model 7,168, 256 routed experts, top-8) over
# 16,384 tokens of seeded random bf16 weights and activations
MOE_BENCH_EXPERTS, MOE_BENCH_DEVICES = 512, 16
MOE_BENCH_KS = (4, 8)
MOE_SESSION_EXPERTS, MOE_SESSION_DEVICES = 4_096, 64
MOE_DRIFT, MOE_CHURN = 1.03, 0.10
GATE_D, GATE_E, GATE_TOP_K, GATE_TOKENS = 7_168, 256, 8, 16_384
GATE_DEVICES = 64
GATE_SUM_RTOL = 1e-3
# each expert's load against its plain host version on the same inputs:
# in f32 within GATE_F32_RTOL; in bf16 a top-8 cut tied within one bf16
# step may go either way, so an expert may differ by its mass in such ties
# (printed) plus GATE_BF16_RTOL of its load
GATE_F32_RTOL = 1e-2
GATE_BF16_RTOL = 1e-3
# the language-model serving path: the 10 reduced architectures on the card
# against the port on the CPU (f32, TF32 off, an f32 cache); llama3-8b at
# full width served in bf16 through launch/serve (8 sequences, a 2,048-slot
# cache, a 128-token prompt prefilled through the decode path, 64 greedy
# tokens); teacher forcing on a 16-token prefix in f32 (the reference's
# decode test bound) and in bf16 (testing.bf16_logit_tol)
LM_SEED = 1
LM_BATCH, LM_SEQ = 2, 8
LM_TOL = 1e-4
SERVE_ARCH = "llama3_8b"
SERVE_BATCH, SERVE_MAX_SEQ = 8, 2048
SERVE_PROMPT, SERVE_TOKENS = 128, 64
SERVE_SEED = 0
SERVE_PREFIX = 16
SERVE_F32_TOL = 1e-3
# the training path: each reduced architecture's train step (2
# microbatches, f32, TF32 off) on the card against the CPU within LM_TOL;
# llama3-8b at full width, its depth cut to TRAIN_LAYERS by memory (f32
# parameters, gradients, m and v are 16 B a parameter: 128.5 GB whole),
# TRAIN_STEPS bf16 steps of TRAIN_BATCH x TRAIN_SEQ tokens; then a
# 2-layer f32 step with remat on against off (gradients within
# REMAT_RTOL of the largest of each leaf) and a 1-layer f32 step on the
# card against the CPU (loss and grad_norm within LM_TOL, parameters
# within TRAIN_PARAM_TOL); xlstm-350m whole through launch/train; the
# train_e2e twin at --model-scale full and the restart step bit for bit
TRAIN_ARCH = "llama3_8b"
TRAIN_LAYERS = 8
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 1024, 6
TRAIN_SEED = 0
REMAT_LAYERS, REMAT_BATCH, REMAT_SEQ = 2, 2, 256
REMAT_RTOL = 1e-6
TRAIN_CPU_LAYERS, TRAIN_CPU_BATCH, TRAIN_CPU_SEQ = 1, 2, 64
TRAIN_PARAM_TOL = 1e-5
PEAK_BF16_PER_S = 989e12
DRIVER_ARCH = "xlstm_350m"
DRIVER_RUNS = (("--steps", "8", "--ckpt-every", "4"), ("--steps", "12"))
E2E_ARGS = ("--model-scale", "full", "--steps", "8", "--fail-at", "4",
            "--ckpt-every", "2")
CHILD_TIMEOUT_S = 300


class SmokeError(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def zero_launches(mod) -> None:
    """Set every launch count of the wrapper module ``mod`` to 0: calls and,
    where the module counts them, CUDA launches."""
    for counts in (mod.LAUNCHES, getattr(mod, "CUDA_LAUNCHES", {})):
        for name in counts:
            counts[name] = 0


def per_half_step(mod) -> dict:
    """{wrapper: CUDA launches per call} since the counts were last set to
    0 (None for a wrapper not called)."""
    return {name: (mod.CUDA_LAUNCHES[name] / n if n else None)
            for name, n in mod.LAUNCHES.items()}


# --------------------------------------------------------------------------
# timing and bounds
# --------------------------------------------------------------------------

def event_ms(fn, reps: int = 200, warmup: int = 10) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream, from CUDA
    events around ``reps`` back-to-back calls (L2 warm, as in the solve
    loop, which reuses one operator every iteration).  Where the host takes
    longer to issue a call than the card takes to run it, this is the
    host's rate; the profile phase gives the device time alone."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def turns_ms(fns: dict) -> dict:
    """{name: ms} of each function of ``fns`` by :func:`event_ms`, run in
    turns (a, b, b, a) and the least of the two kept: the kernel and its
    library call meet the same state of the host."""
    order = list(fns) + list(fns)[::-1]
    out: dict = {}
    for name in order:
        ms = event_ms(fns[name])
        out[name] = min(out.get(name, ms), ms)
    return out


def device_ms(fn, calls: int = PROFILE_CALLS):
    """Device milliseconds per call of ``fn``, whose every kernel launches
    once a call, from the profiler over ``calls`` back-to-back calls: the
    sum over its kernels of each one's mean time per recorded launch (the
    profiler drops a few launches: 195 of 200 on the card).  None, not
    measured, where it recorded no device time or under 90% of the
    launches of a kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.key_averages()
           if ev.device_type == DeviceType.CUDA and ev.count]
    counts = [ev.count for ev in evs]
    if not evs or min(counts) < 0.9 * calls:
        log(f"[device-ms] kernels recorded {counts} over {calls} calls: "
            "not measured")
        return None
    return sum(ev.self_device_time_total / ev.count for ev in evs) / 1e3


def host_us(fn, calls: int = HOST_CALLS) -> float:
    """Host microseconds per call of ``fn`` (time.perf_counter_ns over
    ``calls`` calls, the card synchronised before and after; where a piece
    launches work and the card is slower, the queue's back-pressure counts
    too)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter_ns()
    torch.cuda.synchronize()
    return (t1 - t0) / calls / 1e3


def host_breakdown(name, total, direct, checks, alloc, call, stream):
    """Print where the host time of a call goes: the ops dispatch (the
    ops.py call less the wrapper's), the checks, the allocations, the
    ctypes call (with the CUDA launch API inside it) and the stream lookup
    it makes."""
    t = {k: host_us(fn) for k, fn in (("total", total), ("direct", direct),
                                      ("checks", checks), ("alloc", alloc),
                                      ("call", call), ("stream", stream))}
    rest = t["direct"] - t["checks"] - t["alloc"] - t["call"]
    log(f"[host] {name}, per call over {HOST_CALLS} calls: total "
        f"{t['total']:.2f} us = ops dispatch {t['total'] - t['direct']:.2f} "
        f"+ checks {t['checks']:.2f} + allocations {t['alloc']:.2f} + ctypes"
        f" call {t['call']:.2f} (of which the stream lookup "
        f"{t['stream']:.2f}) + the rest {rest:.2f}")
    return t


def _median(values):
    """The median of the measured values (None: not measured)."""
    got = sorted(v for v in values if v is not None)
    return got[len(got) // 2] if got else None


def _ms(v) -> str:
    return "not measured" if v is None else f"{v:.4f}"


def old_new(name, ms: float, dev, library_ms: float,
            library: str = "torch.sparse CSR") -> str:
    """This run's numbers of a redesigned kernel beside the earlier
    design's (``name`` a key of :data:`EARLIER_MS`)."""
    old = EARLIER_MS[name]
    return (f"ms with host {_ms(ms)} (earlier: {_ms(old[0])}), device ms "
            f"{_ms(dev)} (earlier: {_ms(old[1])}), {library} "
            f"{_ms(library_ms)} (earlier: {_ms(old[2])})")


def bound(n_bytes: float, n_ops: float):
    """(ms, "bytes"|"operations"): the least time for this work on the
    card, from its memory rate and its f32 rate."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = n_ops / PEAK_F32_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def side_csr(idx, val, widx, wval, wids, n_cols):
    """The block-diagonal CSR matrix ([k*S, k*n_cols]) of one ELL side of a
    stacked operator, from its stored nonzeros, and their count."""
    k, w, s_len = idx.shape
    dev = idx.device
    lane = torch.arange(k, device=dev)
    rows = (lane[:, None, None] * s_len
            + torch.arange(s_len, device=dev)[None, None, :]).expand(k, w,
                                                                     s_len)
    cols = idx.long() + lane[:, None, None] * n_cols
    wrows = (wids.long() + lane[:, None] * s_len)[:, None, :].expand(
        widx.shape)
    wcols = widx.long() + lane[:, None, None] * n_cols
    r = torch.cat([rows.reshape(-1), wrows.reshape(-1)])
    c = torch.cat([cols.reshape(-1), wcols.reshape(-1)])
    v = torch.cat([val.reshape(-1), wval.reshape(-1)])
    keep = v != 0
    coo = torch.sparse_coo_tensor(torch.stack([r[keep], c[keep]]), v[keep],
                                  (k * s_len, k * n_cols)).coalesce()
    return coo.to_sparse_csr(), int(keep.sum())


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_card():
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[card] {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    return card


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    paths = build.build()
    secs = time.perf_counter() - t0
    for name, path in paths.items():
        info = build.build_info.get(name)
        how = (f"compiled by nvcc in {info['seconds']:.2f} s" if info
               else "loaded from an earlier build")
        log(f"[build] {path.name}: {how}")
        for ln in (info or {}).get("log", "").splitlines():
            if "registers" in ln or "spill" in ln:
                log(f"[build]   {ln.strip()}")
    log(f"[build] {len(paths)} libraries in {secs:.2f} s (one nvcc per "
        "source, all started together)")


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0].strip()


# --------------------------------------------------------------------------
# the language-model serving path
# --------------------------------------------------------------------------

def _tree_diff(a, b) -> float:
    """The largest absolute difference between two trees' leaves (each
    moved to the host)."""
    from repro_torch.models.transformer import leaves
    return max(float((x.detach().cpu().float() - y.detach().cpu().float())
                     .abs().max()) for x, y in zip(leaves(a), leaves(b)))


def _one_step(cfg, params, batch, tcfg):
    """One train step of ``params`` (updated in place) from a fresh
    optimizer state: ``(params, opt_state, metrics as floats)``."""
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.train_step import make_train_step
    opt = opt_mod.init_state(params)
    params, opt, m = make_train_step(cfg, tcfg)(params, opt, batch)
    return params, opt, {k: float(v) for k, v in m.items()}


def _step_diffs(got: dict, want: dict) -> dict:
    """The loss's difference and grad_norm's relative to its value (a
    norm of every gradient: its size follows the model, 37 on zamba2
    reduced against 2-13 on the others)."""
    return {"loss": abs(got["loss"] - want["loss"]),
            "grad_norm (relative)": abs(got["grad_norm"] - want["grad_norm"])
            / want["grad_norm"]}


def _lm_train_step(cfg, params, device):
    """One train step (LM_BATCH rows in 2 microbatches, f32) of the same
    parameters on the card and on the CPU, every routing checked for a
    tie at the top-k cut: the largest difference of loss, grad_norm,
    parameters, m and v."""
    from repro_torch import testing
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.train_step import TrainConfig
    tcfg = TrainConfig(n_microbatches=2, compute_dtype="float32",
                       adamw=opt_mod.AdamWConfig(**testing.PARITY_ADAMW))
    batch = testing.train_batch(cfg, LM_BATCH, LM_SEQ, seed=1)
    card = testing.to_device(params, device)
    with testing.router_tie_guard():
        got = _one_step(cfg, card, testing.to_device(batch, device), tcfg)
        want = _one_step(cfg, params, batch, tcfg)
    diffs = _step_diffs(got[2], want[2])
    diffs["params"] = _tree_diff(got[0], want[0])
    diffs["m"] = _tree_diff(got[1].m, want[1].m)
    diffs["v"] = _tree_diff(got[1].v, want[1].v)
    return diffs


def phase_lm_reduced(device):
    """Each of the 10 reduced architectures: one parameter set made on the
    host and carried to the card; forward_train and LM_SEQ decode steps on
    the card (f32, TF32 off, f32 cache) within LM_TOL of the same port on
    the CPU, with equal greedy tokens; then one train step (2
    microbatches, f32) on the card within LM_TOL of the CPU's: loss,
    grad_norm, every parameter, m and v."""
    from repro_torch import configs, models, testing
    for arch in configs.ARCH_IDS:
        cfg = configs.get_reduced(arch)
        params = models.init_params(torch.Generator().manual_seed(LM_SEED),
                                    cfg)
        rng = np.random.default_rng(0)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab,
                                            (LM_BATCH, LM_SEQ)))
        enc = (torch.as_tensor(rng.normal(0, 1, (LM_BATCH, 6, cfg.d_model)),
                               dtype=torch.float32)
               if cfg.enc_segments else None)
        want = testing.teacher_forcing(params, cfg, toks, torch.float32, enc)
        got = testing.teacher_forcing(testing.to_device(params, device), cfg,
                                      toks.to(device), torch.float32,
                                      None if enc is None else enc.to(device))
        diffs = [float((g - w).abs().max()) for g, w in zip(got, want)]
        same = all(torch.equal(g.argmax(-1), w.argmax(-1))
                   for g, w in zip(got, want))
        log(f"[lm-reduced] {cfg.name}: card against CPU, forward_train "
            f"{diffs[0]:.3g}, {LM_SEQ} decode steps {diffs[1]:.3g} (bound "
            f"{LM_TOL}); greedy tokens equal {same}")
        check(max(diffs) <= LM_TOL, f"{arch}: card off the CPU by {diffs}")
        check(same, f"{arch}: greedy tokens differ between card and CPU")
        step = _lm_train_step(cfg, params, device)
        log(f"[lm-reduced] {cfg.name}: one train step (2 microbatches, f32)"
            " card against CPU, " + ", ".join(f"{k} {v:.3g}"
                                               for k, v in step.items())
            + f" (bound {LM_TOL})")
        check(max(step.values()) <= LM_TOL,
              f"{arch}: train step off the CPU by {step}")


def phase_serve(device):
    """llama3-8b at full width through ``repro_torch.launch.serve``: random
    f32 parameters from SERVE_SEED on the card; teacher forcing on a
    SERVE_PREFIX-token prefix in f32 (TF32 off) within SERVE_F32_TOL; the
    serving cast to bf16 (norm scales kept f32); teacher forcing again in
    bf16 within ``testing.bf16_logit_tol`` of the two forward_train runs;
    then SERVE_PROMPT prompt tokens prefilled through the decode path and
    SERVE_TOKENS greedy tokens, twice from the same seed (bit-equal
    tokens), finite logits."""
    from repro_torch import models, testing
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    cfg = get_config(SERVE_ARCH)
    bf16 = torch.bfloat16
    gen = torch.Generator(device).manual_seed(SERVE_SEED)
    t0 = time.perf_counter()
    params = models.init_params(gen, cfg)
    torch.cuda.synchronize()
    log(f"[serve] {cfg.name}: {cfg.param_count():,} f32 parameters drawn "
        f"on the card in {time.perf_counter() - t0:.2f} s "
        f"({torch.cuda.memory_allocated() / 1e9:.2f} GB allocated)")
    prefix = serve.random_prompt(cfg, SERVE_BATCH, SERVE_PREFIX, SERVE_SEED,
                                 device)
    f32_train = None
    for dtype in (torch.float32, bf16):
        if dtype == bf16:
            params = models.serving_params(params, bf16)
        train, dec = testing.teacher_forcing(params, cfg, prefix, dtype)
        if dtype == bf16:
            tol = testing.bf16_logit_tol(f32_train, train)
        else:
            f32_train, tol = train, SERVE_F32_TOL
        diff = float((dec - train).abs().max())
        agree = float((dec.argmax(-1) == train.argmax(-1)).float().mean())
        log(f"[serve] teacher forcing {dtype}: decode path against "
            f"forward_train on {SERVE_BATCH} x {SERVE_PREFIX} tokens, "
            f"largest difference {diff:.4g} (bound {tol:.4g}; max |logit| "
            f"{float(train.abs().max()):.4g}); greedy agreement {agree:.4f}")
        check(bool(torch.isfinite(train).all() and torch.isfinite(dec).all()),
              f"non-finite logits in {dtype} teacher forcing")
        check(diff <= tol, f"{dtype} decode off teacher forcing by {diff}")
    prompt = serve.random_prompt(cfg, SERVE_BATCH, SERVE_PROMPT, SERVE_SEED,
                                 device)
    runs = []
    for i in range(2):
        if i:
            del params
            torch.cuda.empty_cache()
            params = serve.build_params(cfg, SERVE_SEED, device)
        run = serve.serve(cfg, params, prompt, SERVE_TOKENS, SERVE_MAX_SEQ)
        runs.append(run)
        bound_ms = ((run.weight_bytes + run.cache_bytes) / PEAK_BYTES_PER_S
                    * 1e3)
        log(f"[serve] run {i + 1}: prefill {SERVE_PROMPT - 1} positions in "
            f"{run.prefill_s:.3f} s ({run.prefill_s / (SERVE_PROMPT - 1) * 1e3:.3f} "
            f"ms a position); {SERVE_TOKENS} decode steps x batch "
            f"{SERVE_BATCH}: {run.step_ms:.4f} ms a step (CUDA events), "
            f"{run.tokens_per_s:.1f} tok/s, host wall {run.decode_s:.3f} s; "
            f"bound {bound_ms:.4f} ms a step ({run.weight_bytes / 1e9:.3f} GB "
            f"of bf16 weights read once + {run.cache_bytes / 1e9:.3f} GB of "
            f"KV cache over {PEAK_BYTES_PER_S / 1e12:.2f} TB/s; "
            f"{bound_ms / run.step_ms:.3f} of it); max_memory_allocated "
            f"{run.peak_bytes / 1e9:.3f} GB")
        check(bool(torch.isfinite(run.final_logits).all()),
              "non-finite logits after the served tokens")
        check(bool(((run.tokens >= 0) & (run.tokens < cfg.vocab)).all()),
              "a token outside the vocabulary")
    check(torch.equal(runs[0].tokens, runs[1].tokens),
          "two runs from the same seed gave different tokens")
    log(f"[serve] the two runs' {SERVE_BATCH} x {SERVE_TOKENS} tokens are "
        f"bit-equal; first tokens {runs[0].tokens[0, :8].tolist()}; "
        f"card {card_line()}")
    del params
    torch.cuda.empty_cache()


def phase_serve_balanced(device):
    """``examples_torch/serve_balanced.py --fast`` on the card: the
    balancer session's placements are valid (every group on one of the
    replicas; a miss, a warm hit, a repair after churn) and each replica's
    decoded tokens lie in the vocabulary."""
    import importlib.util
    from repro_torch.configs import get_reduced
    path = ROOT / "examples_torch" / "serve_balanced.py"
    spec = importlib.util.spec_from_file_location("serve_balanced", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(["--fast"])
    placement, n = out["placement"], out["n_replicas"]
    verdicts = [s.plan_cache for s in out["steps"]]
    log(f"[serve-balanced] {placement.size} groups on {n} replicas, plan "
        f"cache {verdicts}, groups per replica "
        f"{np.bincount(placement, minlength=n).tolist()}")
    check(((placement >= 0) & (placement < n)).all(), "invalid placement")
    check(verdicts == ["miss", "hit", "repair"], f"verdicts {verdicts}")
    vocab = get_reduced("xlstm_350m").vocab
    for r, toks in out["tokens"].items():
        check(toks.shape[0] == int((placement == r).sum()),
              f"replica {r} decoded {toks.shape[0]} sequences")
        check(bool(((toks >= 0) & (toks < vocab)).all()),
              f"replica {r}: a token outside the vocabulary")


# --------------------------------------------------------------------------
# the training path
# --------------------------------------------------------------------------

def cut_depth(cfg, n_layers: int):
    """``cfg`` (one segment of one-block periods) with ``n_layers`` layers
    and its widths unchanged."""
    (seg,) = cfg.segments
    check(len(seg.period) == 1, f"{cfg.name}: a period of several blocks")
    return dataclasses.replace(
        cfg, segments=(dataclasses.replace(seg, n_periods=n_layers),))


def train_flops(cfg, tokens: int, seq: int, remat: bool) -> float:
    """Model FLOPs of one train step of a dense GQA decoder (``cfg``'s
    attention and gated-MLP blocks): the forward's matrix products
    (projections, the MLP, scores and values over the whole ``seq`` x
    ``seq`` square as the port computes them, the unembedding), the
    backward at twice the forward, and with ``remat`` every layer's
    forward once more."""
    d, q, kv = cfg.d_model, cfg.n_heads * cfg.head_dim, cfg.n_kv * cfg.head_dim
    layer = (2 * d * (2 * q + 2 * kv) + 2 * 3 * d * cfg.d_ff
             + 2 * 2 * seq * q)
    forward = tokens * (cfg.n_layers * layer + 2 * d * cfg.vocab)
    return 3 * forward + (tokens * cfg.n_layers * layer if remat else 0)


def _fingerprint(t):
    """A leaf's sum and norm in f64 (on its device)."""
    return torch.stack([t.sum(dtype=torch.float64),
                        torch.linalg.vector_norm(t, dtype=torch.float64)])


def _grads_of(cfg, params, batch, remat: bool):
    """``(loss, [gradient of each leaf])`` of one f32 forward and backward
    with ``remat`` on or off."""
    from repro_torch.models.transformer import leaves
    from repro_torch.train.train_step import TrainConfig, make_loss_fn
    loss_fn = make_loss_fn(cfg, TrainConfig(compute_dtype="float32",
                                            remat=remat))
    flat = list(leaves(params))
    for p in flat:
        p.requires_grad_(True)
    loss = loss_fn(params, batch)
    loss.backward()
    grads = [p.grad for p in flat]
    for p in flat:
        p.grad = None
        p.requires_grad_(False)
    return loss.detach(), grads


def phase_train(device, card: str):
    """llama3-8b at full width, TRAIN_LAYERS deep, through the port's train
    step (2 microbatches, bf16 compute over f32 parameters, remat on),
    batches from ``TokenPipeline`` through ``DevicePrefetcher``: ms a step
    from CUDA events, tokens/s, the model FLOPs' share of the bf16 peak,
    ``max_memory_allocated`` against the reckoned state; loss and
    grad_norm finite, the last loss below the first, every leaf changed.
    Then remat on against off (2 layers, f32) and the card against the CPU
    (1 layer, f32, 2 x 64 tokens)."""
    from repro_torch import models, testing
    from repro_torch.configs import get_config
    from repro_torch.data import DevicePrefetcher, TokenPipeline
    from repro_torch.models.transformer import leaves
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.train_step import TrainConfig, make_train_step
    full = get_config(TRAIN_ARCH)
    cfg = cut_depth(full, TRAIN_LAYERS)
    n = cfg.param_count()
    state_bytes = 16 * n
    log(f"[train] {cfg.name} at full width (d_model {cfg.d_model}, GQA "
        f"{cfg.n_heads}/{cfg.n_kv}, head_dim {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}, untied), depth cut from "
        f"{full.n_layers} to {cfg.n_layers} layers by memory: f32 "
        f"parameters, gradients, m and v are 16 B a parameter, "
        f"{16 * full.param_count() / 1e9:.1f} GB for all "
        f"{full.param_count():,}, {state_bytes / 1e9:.1f} GB for {n:,}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    params = models.init_params(
        torch.Generator(device).manual_seed(TRAIN_SEED), cfg)
    opt = opt_mod.init_state(params)
    before = [_fingerprint(t) for t in leaves(params)]
    # the reference's AdamW defaults: lr 3e-6 a step of warmup (a peak of
    # 3e-4 from the first step raised the loss from 12.16 to 19.87)
    tcfg = TrainConfig(n_microbatches=2, compute_dtype="bfloat16",
                       remat=True, adamw=opt_mod.AdamWConfig())
    step = make_train_step(cfg, tcfg)
    batches = DevicePrefetcher(
        TokenPipeline(vocab=cfg.vocab, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                      seed=TRAIN_SEED), device)
    ms, losses, gnorms = [], [], []
    try:
        for s in range(TRAIN_STEPS):
            batch = next(batches)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            params, opt, m = step(params, opt, batch)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
            log(f"[train] step {s}: loss {losses[-1]:.4f} grad_norm "
                f"{gnorms[-1]:.4f} lr {float(m['lr']):.3g}, {ms[-1]:.2f} ms")
    finally:
        batches.close()
    peak = torch.cuda.max_memory_allocated(device)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    steady = sum(ms[1:]) / len(ms[1:])
    flops = train_flops(cfg, tokens, TRAIN_SEQ, remat=True)
    log(f"[train] {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} "
        f"tokens: first {ms[0]:.2f} ms, then {steady:.2f} ms a step (CUDA "
        f"events, mean of {len(ms) - 1}; least {min(ms[1:]):.2f}), "
        f"{tokens / steady * 1e3:.1f} tokens/s; {flops:.4g} model FLOPs a "
        f"step (remat included) = {flops / (steady / 1e3) / PEAK_BF16_PER_S:.3f}"
        f" of the dense bf16 peak (989 TFLOP/s) on {card}; "
        f"max_memory_allocated {peak / 1e9:.3f} GB against "
        f"{state_bytes / 1e9:.3f} GB of f32 state")
    check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
          f"non-finite loss or grad_norm: {losses}, {gnorms}")
    check(losses[-1] < losses[0],
          f"the loss did not fall: {losses[0]} -> {losses[-1]}")
    after = [_fingerprint(t) for t in leaves(params)]
    same = sum(bool(torch.equal(a, b)) for a, b in zip(before, after))
    check(same == 0, f"{same} of {len(after)} parameter leaves unchanged")
    log(f"[train] all {len(after)} parameter leaves changed")
    del params, opt, batch, m
    torch.cuda.empty_cache()
    remat_check(device, full)
    card_cpu_check(device, full)


def remat_check(device, full):
    """One f32 forward and backward of ``full`` cut to REMAT_LAYERS with
    remat on and off: the loss and every gradient within REMAT_RTOL."""
    from repro_torch import models, testing
    cfg2 = cut_depth(full, REMAT_LAYERS)
    params = models.init_params(
        torch.Generator(device).manual_seed(TRAIN_SEED), cfg2)
    batch = testing.train_batch(cfg2, REMAT_BATCH, REMAT_SEQ, seed=2,
                                device=device)
    on, off = (_grads_of(cfg2, params, batch, remat) for remat in (True,
                                                                   False))
    rel = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
              for a, b in zip(on[1], off[1]))
    bits = torch.equal(on[0], off[0]) and all(
        torch.equal(a, b) for a, b in zip(on[1], off[1]))
    loss_rel = abs(float(on[0]) - float(off[0])) / abs(float(off[0]))
    log(f"[train] remat on against off ({cfg2.n_layers} layers, f32, "
        f"{REMAT_BATCH} x {REMAT_SEQ} tokens): loss {float(on[0]):.6f} / "
        f"{float(off[0]):.6f}, relative {loss_rel:.3g}; largest gradient "
        f"difference {rel:.3g} of its leaf's largest (bound {REMAT_RTOL}); "
        f"bit-equal {bits}")
    check(loss_rel <= REMAT_RTOL and rel <= REMAT_RTOL,
          f"remat changed the step: loss {loss_rel}, gradients {rel}")
    del params, batch, on, off
    torch.cuda.empty_cache()


def card_cpu_check(device, full):
    """One f32 train step of ``full`` cut to TRAIN_CPU_LAYERS on the card
    and on the CPU from the same parameters: loss and grad_norm within
    LM_TOL, parameters within TRAIN_PARAM_TOL."""
    from repro_torch import models, testing
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.train_step import TrainConfig
    cfg1 = cut_depth(full, TRAIN_CPU_LAYERS)
    host = models.init_params(torch.Generator().manual_seed(TRAIN_SEED),
                              cfg1)
    card_params = testing.to_device(host, device)
    batch = testing.train_batch(cfg1, TRAIN_CPU_BATCH, TRAIN_CPU_SEQ,
                                seed=3)
    tcfg = TrainConfig(n_microbatches=2, compute_dtype="float32",
                       adamw=opt_mod.AdamWConfig(**testing.PARITY_ADAMW))
    t0 = time.perf_counter()
    got = _one_step(cfg1, card_params, testing.to_device(batch, device),
                    tcfg)
    t1 = time.perf_counter()
    want = _one_step(cfg1, host, batch, tcfg)
    t2 = time.perf_counter()
    diffs = _step_diffs(got[2], want[2])
    p_diff = _tree_diff(got[0], want[0])
    log(f"[train] card against CPU ({cfg1.n_layers} layer, f32, "
        f"{TRAIN_CPU_BATCH} x {TRAIN_CPU_SEQ} tokens, one step): loss "
        f"{got[2]['loss']:.6f} / {want[2]['loss']:.6f}, grad_norm "
        f"{got[2]['grad_norm']:.6f} / {want[2]['grad_norm']:.6f}; "
        + ", ".join(f"{k} {v:.3g}" for k, v in diffs.items())
        + f" (bound {LM_TOL}), parameters {p_diff:.3g} (bound "
        f"{TRAIN_PARAM_TOL}); card {t1 - t0:.2f} s, CPU {t2 - t1:.2f} s")
    check(max(diffs.values()) <= LM_TOL and p_diff <= TRAIN_PARAM_TOL,
          f"the card's step off the CPU's: {diffs}, parameters {p_diff}")
    del host, card_params, got, want
    torch.cuda.empty_cache()


def _child(args, tag: str):
    """Run ``python args...`` from the repository root with ``src`` on the
    path; its output lines are logged with ``tag``.  Returns ``(stdout,
    wall seconds)``; a nonzero exit fails the phase."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True,
                          timeout=CHILD_TIMEOUT_S)
    wall = time.perf_counter() - t0
    for ln in proc.stdout.splitlines():
        log(f"[{tag}]   {ln}")
    check(proc.returncode == 0, f"{tag}: exit {proc.returncode}\\n"
          f"{proc.stderr[-3000:]}")
    return proc.stdout, wall


def _final_loss(out: str) -> float:
    line = [ln for ln in out.splitlines() if ln.startswith("done:")]
    check(len(line) == 1, "no 'done:' line")
    return float(line[0].split()[-1])


def phase_train_driver(device):
    """xlstm-350m whole (24 layers) through ``python -m
    repro_torch.launch.train`` in a child process on the card: 8 steps
    with a checkpoint at step 4, then 12 steps into the same directory,
    which must resume from step 4 and end with a finite loss."""
    from repro_torch.configs import get_config
    cfg = get_config(DRIVER_ARCH)
    ckpt = ROOT / "build" / "train_driver_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    log(f"[train-driver] {cfg.name}: {cfg.n_layers} layers, "
        f"{cfg.param_count():,} parameters "
        f"({16 * cfg.param_count() / 1e9:.2f} GB of f32 state)")
    for i, run in enumerate(DRIVER_RUNS):
        out, wall = _child(["-m", "repro_torch.launch.train", "--arch",
                            DRIVER_ARCH, *run, "--ckpt-dir", str(ckpt)],
                           "train-driver")
        loss = _final_loss(out)
        check(np.isfinite(loss), f"run {i + 1}: final loss {loss}")
        if i:
            check("resumed from step 4" in out, "the second run did not "
                  "resume from step 4")
        log(f"[train-driver] run {i + 1} ({' '.join(run)}): wall "
            f"{wall:.2f} s (process start, parameters, steps, checkpoint "
            f"writes), final loss {loss:.4f}")
    shutil.rmtree(ckpt, ignore_errors=True)


def phase_train_e2e(device):
    """``examples_torch/train_e2e.py`` at ``--model-scale full`` on the card
    in a child process (the simulated failure and restart, the marker
    ``across restart``); then the reference's restart check
    (``tests/test_system.py``'s ``test_train_checkpoint_restart_bitexact``)
    at that scale: a checkpoint after step 1, restored, and the next step's
    loss and every parameter bit-equal to the step that was not
    interrupted."""
    path = ROOT / "examples_torch" / "train_e2e.py"
    out, wall = _child([str(path), *E2E_ARGS], "train-e2e")
    check("across restart" in out, "train_e2e printed no 'across restart'")
    log(f"[train-e2e] {' '.join(E2E_ARGS)}: wall {wall:.2f} s")
    restart_bitexact(device)


def restart_bitexact(device):
    """The reference's restart check at ``train_e2e``'s full scale: a
    checkpoint after step 1, restored, the next step bit-equal."""
    import importlib.util
    from repro_torch import models
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.data import TokenPipeline
    from repro_torch.models.transformer import leaves
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.train_step import TrainConfig, make_train_step
    path = ROOT / "examples_torch" / "train_e2e.py"
    spec = importlib.util.spec_from_file_location("train_e2e_twin", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cfg = mod.model_cfg("full")
    B, S = 8, 512
    params = models.init_params(torch.Generator(device).manual_seed(0), cfg)
    opt = opt_mod.init_state(params)
    step = make_train_step(cfg, TrainConfig(
        n_microbatches=1, adamw=opt_mod.AdamWConfig(
            peak_lr=1e-3, warmup_steps=2, total_steps=10)))

    def on_card(b):
        return {k: torch.as_tensor(v).to(device) for k, v in b.items()}

    pipe = TokenPipeline(vocab=cfg.vocab, batch=B, seq=S, seed=3)
    it = iter(pipe)
    ckpt = ROOT / "build" / "e2e_restart_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    ck = Checkpointer(str(ckpt))
    params, opt, _ = step(params, opt, on_card(next(it)))
    ck.save(1, {"params": params, "opt": opt}, extras={"pipe": pipe.state()})
    b2 = next(it)
    params_a, opt_a, m_a = step(params, opt, on_card(b2))
    restored, extras = ck.restore(1, {"params": params_a, "opt": opt_a})
    pipe2 = TokenPipeline(vocab=cfg.vocab, batch=B, seq=S, seed=3)
    pipe2.restore(extras["pipe"])
    b2r = next(iter(pipe2))
    check(np.array_equal(b2["tokens"], b2r["tokens"]),
          "the restored pipeline drew another batch")
    params_b, opt_b, m_b = step(restored["params"], restored["opt"],
                                on_card(b2r))
    la, lb = float(m_a["loss"]), float(m_b["loss"])
    unequal = sum(not torch.equal(a, b) for a, b in
                  zip(leaves(params_a), leaves(params_b)))
    log(f"[train-e2e] restart at {cfg.name} ({B} x {S} tokens): the "
        f"restored step's loss {lb!r} against {la!r}; {unequal} of "
        f"{len(list(leaves(params_a)))} parameter leaves differ")
    check(la == lb and unequal == 0,
          "the restored step is not bit-equal to the uninterrupted one")
    shutil.rmtree(ckpt, ignore_errors=True)
    del params, opt, params_a, opt_a, params_b, opt_b, restored
    torch.cuda.empty_cache()


def _check_pair(name, got, want):
    """Kernel result against the plain version's: the tail bit-equal, the
    product within the tolerance; returns the max abs error."""
    tail_err = float((got[0] - want[0]).abs().max())
    prod_err = (got[1] - want[1]).abs()
    limit = PRODUCT_ATOL + PRODUCT_RTOL * want[1].abs()
    check(bool(torch.isfinite(got[1]).all()), f"{name}: non-finite")
    check(tail_err == 0.0, f"{name}: tail differs by {tail_err}")
    check(bool((prod_err <= limit).all()),
          f"{name}: product off by {float(prod_err.max())} "
          f"(rtol=atol={PRODUCT_RTOL})")
    return max(tail_err, float(prod_err.max()))


def lane_calls(s, o):
    """{kernel name: fn(backend)} of the two lane half-steps on ``s``."""
    from repro_torch.kernels import ops
    return {
        "structured_forward_step": lambda be: ops.structured_forward_step(
            s, o["x"], o["c"], o["l"], o["u"], o["tau"], o["kty"],
            backend=be),
        "structured_backward_step": lambda be: ops.structured_backward_step(
            s, o["y"], o["q"], o["sigma"], o["mask"], o["kxn"], o["kxp"],
            backend=be)}


def full_calls(s, o):
    """{kernel name: fn(backend)} of the two full-problem half-steps on the
    single-lane ``s`` with its ragged wide-block plans."""
    from repro_torch.core import pdhg
    from repro_torch.kernels import ops
    rplan, cplan = pdhg._wide_block_plans(s)
    return {
        "structured_full_forward_step":
            lambda be: ops.structured_full_forward_step(
                s, o["x"], o["c"], o["l"], o["u"], o["tau"], o["kty"],
                plan=rplan, backend=be),
        "structured_full_backward_step":
            lambda be: ops.structured_full_backward_step(
                s, o["y"], o["q"], o["sigma"], o["mask"], o["kxn"],
                o["kxp"], plan=cplan, backend=be)}


def compare_case(calls):
    """Each kernel against its plain version on one operator: returns the
    max abs error of each kernel and fails the run outside the
    tolerance."""
    errs = {}
    for name, fn in calls.items():
        got = fn("kernel")
        torch.cuda.synchronize()
        errs[name] = _check_pair(name, got, fn("ref"))
    return errs


def phase_kernels(device):
    """Each lane kernel against its plain version; times at the main path's
    shapes.  Returns the per-kernel record (without launches)."""
    from repro_torch import testing
    from repro_torch.core import pdhg, pop
    from repro_torch.problems.cluster_scheduling import (
        GavelProblem, make_cluster_workload)
    prob = GavelProblem(make_cluster_workload(N_JOBS, num_workers=NUM_WORKERS,
                                              seed=0))
    s = pop.build(prob, pop.plan(prob, 8, strategy="stratified"),
                  device).structured
    k, wr, M = s.row_idx.shape
    N = s.col_idx.shape[-1]
    log(f"[kernels] main-path stack: k={k} N={N} M={M} Wr={wr} "
        f"Ww={s.wrow_idx.shape[1]} Dr={s.wrow_idx.shape[2]} "
        f"Wc={s.col_idx.shape[1]} Wv={s.wcol_idx.shape[1]} "
        f"Dc={s.wcol_idx.shape[2]}")
    cases = {"gavel_main_path": s}
    for shape in ((1, 64, 96, 0.3), (3, 45, 67, 0.25), (4, 130, 250, 0.05),
                  (2, 256, 129, 0.1)):
        for sparse in (False, True):
            name = f"skewed{shape[:3]}{'_sparse' if sparse else ''}"
            cases[name] = pdhg.to_device(
                testing.skewed_operator(*shape, sparse), device)
    max_err = {"structured_forward_step": 0.0, "structured_backward_step": 0.0}
    for name, op_s in cases.items():
        errs = compare_case(lane_calls(op_s,
                                       testing.step_tensors(op_s, device)))
        log(f"[kernels] {name}: max abs err " + ", ".join(
            f"{kname} {err:.3g}" for kname, err in errs.items())
            + f" (tails exact, products rtol=atol={PRODUCT_RTOL})")
        for kname, err in errs.items():
            max_err[kname] = max(max_err[kname], err)

    # times at the main path's shapes
    o = testing.step_tensors(s, device)
    csr_k, nnz_k = side_csr(s.row_idx, s.row_val, s.wrow_idx,
                            s.wrow_val, s.wrow_ids, N)
    csr_kt, nnz_kt = side_csr(s.col_idx, s.col_val, s.wcol_idx,
                              s.wcol_val, s.wcol_ids, M)
    x_flat = o["x"].reshape(-1, 1)
    y_flat = o["y"].reshape(-1, 1)
    f32 = 4
    records = {}
    calls = lane_calls(s, o)
    specs = (
        ("structured_forward_step", calls["structured_forward_step"],
         lambda: csr_k @ x_flat,
         # ELL nonzeros (idx + val) + wide ids, x/c/l/u/kty + tau in,
         # x_new + kx out
         nnz_k * 8 + k * s.wrow_ids.shape[1] * 4 + 5 * k * N * f32 + k * f32
         + (k * N + k * M) * f32,
         2 * nnz_k + 4 * k * N),
        ("structured_backward_step", calls["structured_backward_step"],
         lambda: csr_kt @ y_flat,
         # y/q/kx_new/kx_prev (f32) + mask (u8) + sigma in, y_new + kty out
         nnz_kt * 8 + k * s.wcol_ids.shape[1] * 4 + 4 * k * M * f32 + k * M
         + k * f32 + (k * M + k * N) * f32,
         2 * nnz_kt + 6 * k * M),
    )
    for name, step, library, n_bytes, n_ops in specs:
        paired = turns_ms({"kernel": lambda: step("kernel"),
                           "library": library})
        ms, library_ms = paired["kernel"], paired["library"]
        plain_ms = event_ms(lambda: step("ref"))
        bound_ms, bound_by = bound(n_bytes, n_ops)
        records[name] = dict(
            name=name, route="cuda", source=KERNEL_SOURCE[name],
            replaces=REPLACES[name], launches=0,
            max_abs_err=max_err[name], ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
            device_ms=None)
        log(f"[kernels] {name} at the main-path shape, per call: kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"torch.sparse CSR product {library_ms:.4f} ms, bound "
            f"{bound_ms:.5f} ms ({bound_by}: {n_bytes / 1e6:.3f} MB, "
            f"{n_ops / 1e6:.3f} Mflop)")
    lane_host(s, o)
    return records, (s, o)


def phase_redesign(lane_case, full_cases, records):
    """The redesigned kernels' device times under the profiler: each lane
    kernel at each block count at the main-path shape, the cooperative
    forward kernel's two variants at the traffic shape and the cooperative
    backward kernel at the traffic shape (f32, int8) and the Gavel full
    shape.  It runs after the paths: a profiler session slows every later
    host call (PERF.md), and the with-host times and the host breakdown are
    taken before it."""
    from repro_torch.core import pdhg
    s, o = lane_case
    calls = lane_calls(s, o)
    for name in calls:
        lane_sweep(calls, records, name,
                   {f"{c} blocks": {"CLUSTER": c} for c in CLUSTERS})
    s, o = full_cases[f"te{TE_DEMANDS}"]
    variant_sweep(full_calls(s, o), records)
    alone = {}
    for case, (s32, o) in full_cases.items():
        dts = ("float32", "int8") if case.startswith("te") else ("float32",)
        for dt in dts:
            s = pdhg.quantize_structured(s32, dt)
            alone[f"{case} {dt}"] = backward_alone(
                full_calls(s, o), f"{case} {dt}")
    name = "structured_full_backward_step"
    log(f"[redesign] {name}: device ms alone {alone}; the earlier three "
        f"launches: device ms {EARLIER_MS[name][1]:.4f} (te{TE_DEMANDS} "
        f"float32), bound {records[name]['bound_ms']:.5f}")
    records[name]["device_ms_alone"] = alone


def backward_alone(calls, tag):
    """The cooperative backward kernel on one operator: held against the
    plain version, one CUDA launch a call, bit-for-bit the same twice, and
    its time with the host and on the device per call."""
    from repro_torch.kernels import structured_full_pdhg_step as kf
    name = "structured_full_backward_step"
    step = calls[name]
    zero_launches(kf)
    got = step("kernel")
    torch.cuda.synchronize()
    check(per_half_step(kf)[name] == 1,
          f"{name} at {tag}: {per_half_step(kf)[name]} CUDA launches a call")
    err = _check_pair(f"{name} at {tag}", got, step("ref"))
    again = step("kernel")
    check(all(bool(torch.equal(a, b)) for a, b in zip(got, again)),
          f"{name} at {tag} is not deterministic")
    ms = event_ms(lambda: step("kernel"))
    dev = device_ms(lambda: step("kernel"))
    log(f"[redesign] {name} at {tag}: max abs err {err:.3g}, 1 CUDA launch "
        f"a call, ms with host {ms:.4f}, device ms {dev}")
    return dev


def lane_sweep(calls, records, name, settings):
    """The lane kernel ``name`` under each of ``settings`` ({label: {wrapper
    attribute: value}}, in turns: forward and back) at the main-path shape:
    held against the plain version, one CUDA launch a call, bit-for-bit
    the same twice, its time with the host and its device time per call;
    the wrapper's own attributes are restored after."""
    from repro_torch.kernels import structured_pdhg_step as km
    step = calls[name]
    want = step("ref")
    default = {a: getattr(km, a) for kv in settings.values() for a in kv}
    runs = {label: [] for label in settings}
    try:
        for label in list(settings) + list(settings)[::-1]:
            for a, v in {**default, **settings[label]}.items():
                setattr(km, a, v)
            zero_launches(km)
            got = step("kernel")
            torch.cuda.synchronize()
            check(per_half_step(km)[name] == 1,
                  f"{name} ({label}): {per_half_step(km)[name]} CUDA "
                  "launches a call")
            err = _check_pair(f"{name} ({label})", got, want)
            again = step("kernel")
            check(all(bool(torch.equal(a, b)) for a, b in zip(got, again)),
                  f"{name} ({label}) is not deterministic")
            runs[label].append((event_ms(lambda: step("kernel")),
                                device_ms(lambda: step("kernel"))))
            log(f"[redesign] {name} {label}: max abs err {err:.3g}, ms with "
                f"host {runs[label][-1][0]:.4f}, device ms "
                f"{runs[label][-1][1]}")
    finally:
        for a, v in default.items():
            setattr(km, a, v)
    best = {label: min((d for _, d in r if d is not None), default=None)
            for label, r in runs.items()}
    fastest = min(best, key=lambda label: best[label] or float("inf"))
    log(f"[redesign] {name}: least device ms per setting {best}, fastest "
        f"{fastest}; the wrapper's {default}; the earlier two launches: "
        f"device ms {EARLIER_MS[name][1]:.4f}, bound "
        f"{records[name]['bound_ms']:.5f}")
    records[name]["device_ms_sweep"] = best


def lane_host(s, o):
    """The host breakdown of the two lane wrappers at the main-path
    shape."""
    from repro_torch.kernels import ops, structured_pdhg_step as km
    fw = (s, o["x"], o["c"], o["l"], o["u"], o["tau"], o["kty"])
    bw = (s, o["y"], o["q"], o["sigma"], o["mask"], o["kxn"], o["kxp"])
    p, ptrs = km.forward_checks(*fw)
    c = km.CLUSTER
    outs = km.forward_alloc(p, o["x"])
    host_breakdown("structured_forward_step",
                   lambda: ops.structured_forward_step(*fw),
                   lambda: km.structured_forward_step(*fw),
                   lambda: km.forward_checks(*fw),
                   lambda: km.forward_alloc(p, o["x"]),
                   lambda: km.forward_call(p, ptrs, *outs, c),
                   lambda: km._stream(p))
    p, ptrs = km.backward_checks(*bw)
    c = km.CLUSTER
    outs = km.backward_alloc(p, o["y"])
    host_breakdown("structured_backward_step",
                   lambda: ops.structured_backward_step(*bw),
                   lambda: km.structured_backward_step(*bw),
                   lambda: km.backward_checks(*bw),
                   lambda: km.backward_alloc(p, o["y"]),
                   lambda: km.backward_call(p, ptrs, *outs, c),
                   lambda: km._stream(p))


def _nnz(*vals) -> int:
    return sum(int((v != 0).sum()) for v in vals)


def full_bytes_ops(s, n_var: int, n_con: int):
    """{kernel: (bytes, flops)} of one full half-step pair on the
    single-lane ``s``, counting what this operator's data needs: each
    stored nonzero once (index + coefficient in its storage type), the fold
    map, the input vectors and the two outputs; 2 flops per nonzero and
    the tail's element-wise operations."""
    f32, cb = 4, s.row_val.element_size()
    nnz_r = _nnz(s.row_val, s.wrow_val)
    nnz_c = _nnz(s.col_val, s.wcol_val)
    scales = 8 if s.row_scale is not None else 0
    return {
        # x/c/l/u/kty + tau in, fold, x_new + kx out
        "structured_full_forward_step": (
            nnz_r * (4 + cb) + scales + n_con * 4 + 5 * n_var * f32 + f32
            + (n_var + n_con) * f32, 2 * nnz_r + 4 * n_var),
        # y/q/kx_new/kx_prev + mask (u8) + sigma in, fold, y_new + kty out
        "structured_full_backward_step": (
            nnz_c * (4 + cb) + scales + n_var * 4 + 4 * n_con * f32 + n_con
            + f32 + (n_con + n_var) * f32, 2 * nnz_c + 6 * n_con)}


def full_operators(device, te_prob):
    """{case: single-lane f32 StructuredOperator on the card}: traffic
    engineering at 20,000 demands, the Gavel full LP of the main path's
    fleet, and two small ragged cases."""
    from repro_torch import testing
    from repro_torch.core import pdhg
    from repro_torch.problems.cluster_scheduling import (
        GavelProblem, make_cluster_workload)
    gavel = GavelProblem(make_cluster_workload(N_JOBS, num_workers=NUM_WORKERS,
                                               seed=0))
    one = lambda st: pdhg.to_device(pdhg.map_arrays(lambda a: a[None], st),
                                    device)
    return {
        f"te{TE_DEMANDS}": one(te_prob.build_full().structured),
        f"gavel{N_JOBS}_full": one(gavel.build_full().structured),
        # the conformance matrix's small traffic case (empty wide buckets)
        "traffic_small": one(testing.traffic_problem(
            14, n_nodes=24, target_edges=48, n_paths=3, max_len=12,
            topo_seed=1, demand_seed=1, path_seed=1).build_full().structured),
        # wide buckets over several ragged plan blocks on both sides
        "ragged": pdhg.to_device(testing.ragged_operator(), device),
    }


def phase_kernels_full(device, te_prob):
    """Each full-problem kernel against its plain version in f32, bf16 and
    int8 storage on every case of :func:`full_operators`; times at the
    traffic shape (each storage type) and the Gavel full shape (f32).
    Returns the per-kernel records (without launches) and the traffic and
    Gavel full cases' f32 operators with their step tensors."""
    from repro_torch import testing
    from repro_torch.core import pdhg
    ops_f32 = full_operators(device, te_prob)
    names = ("structured_full_forward_step", "structured_full_backward_step")
    max_err = dict.fromkeys(names, 0.0)
    times = {}
    te_case = f"te{TE_DEMANDS}"
    for case, s32 in ops_f32.items():
        rplan, cplan = pdhg._wide_block_plans(s32)
        log(f"[kernels] {case}: N={s32.col_idx.shape[-1]} "
            f"M={s32.row_idx.shape[-1]} narrow rows "
            f"{tuple(s32.row_idx.shape[1:])} wide rows "
            f"{tuple(s32.wrow_idx.shape[1:])} narrow cols "
            f"{tuple(s32.col_idx.shape[1:])} wide cols "
            f"{tuple(s32.wcol_idx.shape[1:])}; row plan {len(rplan)} "
            f"blocks covering {sum((c1 - c0) * wb for c0, c1, wb in rplan)}"
            f" elements, col plan {len(cplan)} blocks covering "
            f"{sum((c1 - c0) * wb for c0, c1, wb in cplan)}")
        ell_fill(case, s32)
        o = testing.step_tensors(s32, device)
        for dt in COEF_DTYPES:
            s = pdhg.quantize_structured(s32, dt)
            calls = full_calls(s, o)
            errs = compare_case(calls)
            log(f"[kernels] {case} {dt}: max abs err " + ", ".join(
                f"{k} {e:.3g}" for k, e in errs.items())
                + f" (tails exact, products rtol=atol={PRODUCT_RTOL})")
            for k, e in errs.items():
                max_err[k] = max(max_err[k], e)
            if case == te_case or (case.startswith("gavel")
                                   and dt == "float32"):
                n_var, n_con = s.col_idx.shape[-1], s.row_idx.shape[-1]
                work = full_bytes_ops(s, n_var, n_con)
                for k, fn in calls.items():
                    ms = event_ms(lambda: fn("kernel"))
                    plain_ms = event_ms(lambda: fn("ref"), reps=50)
                    bound_ms, bound_by = bound(*work[k])
                    times[(case, dt, k)] = (ms, plain_ms, bound_ms,
                                            bound_by)
                    log(f"[kernels] {k} at {case} {dt}, per call: kernel "
                        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                        f"{bound_ms:.5f} ms ({bound_by}: "
                        f"{work[k][0] / 1e6:.3f} MB, "
                        f"{work[k][1] / 1e6:.3f} Mflop)")
    # the library yardstick at the traffic shape: one CSR product of K
    s = ops_f32[te_case]
    n_var, n_con = s.col_idx.shape[-1], s.row_idx.shape[-1]
    o = testing.step_tensors(s, device)
    csr_k, _ = side_csr(s.row_idx, s.row_val, s.wrow_idx, s.wrow_val,
                        s.wrow_ids, n_var)
    csr_kt, _ = side_csr(s.col_idx, s.col_val, s.wcol_idx, s.wcol_val,
                         s.wcol_ids, n_con)
    library = {names[0]: lambda: csr_k @ o["x"].reshape(-1, 1),
               names[1]: lambda: csr_kt @ o["y"].reshape(-1, 1)}
    records = {}
    for k in names:
        _, plain_ms, bound_ms, bound_by = times[(te_case, "float32", k)]
        fn = full_calls(s, o)[k]
        paired = turns_ms({"kernel": lambda: fn("kernel"),
                           "library": library[k]})
        ms, library_ms = paired["kernel"], paired["library"]
        log(f"[kernels] {k} at {te_case} float32, in turns with its "
            f"torch.sparse CSR product: kernel {ms:.4f} ms, CSR "
            f"{library_ms:.4f} ms")
        records[k] = dict(
            name=k, route="cuda", source=KERNEL_SOURCE[k],
            replaces=REPLACES[k], launches=0, max_abs_err=max_err[k], ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=library_ms, device_ms=None)
    full_host(s, o)
    gavel = f"gavel{N_JOBS}_full"
    return records, {te_case: (s, o), gavel: (
        ops_f32[gavel], testing.step_tensors(ops_f32[gavel], device))}


def ell_fill(case, s):
    """Print how full each narrow ELL side of the single-lane ``s`` is:
    stored entries (nonzero coefficients) against its [W, S] slots, and the
    slots the 4-segment group widths cover (what the full backward kernel
    reads of the column side)."""
    from repro_torch.kernels import structured_full_pdhg_step as kf
    for side, val in (("rows", s.row_val), ("cols", s.col_val)):
        w, n = val.shape[1:]
        stored = int((val != 0).sum())
        gw = kf.group_widths(val)
        covered = int(gw.repeat_interleave(kf.ROWS_PER_LANE)[:n].sum())
        log(f"[kernels] {case} narrow {side} [{w}, {n}]: {stored} stored "
            f"entries in {w * n} slots ({100 * stored / (w * n):.1f}%); the "
            f"group widths cover {covered} slots "
            f"({100 * covered / (w * n):.1f}%)")


def variant_sweep(calls, records):
    """The cooperative forward kernel at the traffic shape (f32) in one
    launch and after the tail launch, in turns (1, 2, 2, 1): held against
    the plain version, its time with the host and its device time per
    call; the wrapper's own variant is restored after."""
    from repro_torch.kernels import structured_full_pdhg_step as kf
    name = "structured_full_forward_step"
    step = calls[name]
    want = step("ref")
    default, runs = kf.VARIANT, {v: [] for v in FULL_VARIANTS}
    try:
        for v in FULL_VARIANTS + FULL_VARIANTS[::-1]:
            kf.VARIANT = v
            zero_launches(kf)
            got = step("kernel")
            torch.cuda.synchronize()
            err = _check_pair(f"{name} (variant {v})", got, want)
            per = per_half_step(kf)[name]
            check(per == v, f"{name} variant {v}: {per} CUDA launches")
            runs[v].append((event_ms(lambda: step("kernel")),
                            device_ms(lambda: step("kernel"))))
            log(f"[redesign] {name} variant {v} ({v} CUDA launch(es) per "
                f"call): max abs err {err:.3g}, ms with host "
                f"{runs[v][-1][0]:.4f}, device ms {runs[v][-1][1]}")
    finally:
        kf.VARIANT = default
    best = {v: min(d for _, d in r if d is not None) if any(
        d is not None for _, d in r) else None for v, r in runs.items()}
    log(f"[redesign] {name}: least device ms per variant {best}; the "
        f"wrapper's VARIANT is {default}; the earlier three launches: device "
        f"ms "
        f"{EARLIER_MS[name][1]:.4f}, bound {records[name]['bound_ms']:.5f}")
    records[name]["device_ms_variants"] = {str(v): d for v, d in best.items()}


def full_host(s, o):
    """The host breakdown of the two full wrappers at the traffic shape
    (f32)."""
    from repro_torch.core import pdhg
    from repro_torch.kernels import ops, structured_full_pdhg_step as kf
    rplan, cplan = pdhg._wide_block_plans(s)
    fw = (s, o["x"], o["c"], o["l"], o["u"], o["tau"], o["kty"])
    bw = (s, o["y"], o["q"], o["sigma"], o["mask"], o["kxn"], o["kxp"])
    v = kf.VARIANT
    p, ptrs = kf.forward_checks(*fw, rplan)
    outs = kf.alloc(p, o["x"])
    host_breakdown("structured_full_forward_step",
                   lambda: ops.structured_full_forward_step(*fw, plan=rplan),
                   lambda: kf.structured_full_forward_step(*fw, rplan),
                   lambda: kf.forward_checks(*fw, rplan),
                   lambda: kf.alloc(p, o["x"]),
                   lambda: kf.forward_call(p, ptrs, *outs, v),
                   lambda: kf._stream(p))
    p, ptrs = kf.backward_checks(*bw, cplan)
    outs = kf.alloc(p, o["y"])
    host_breakdown("structured_full_backward_step",
                   lambda: ops.structured_full_backward_step(*bw, plan=cplan),
                   lambda: kf.structured_full_backward_step(*bw, cplan),
                   lambda: kf.backward_checks(*bw, cplan),
                   lambda: kf.alloc(p, o["y"]),
                   lambda: kf.backward_call(p, ptrs, *outs),
                   lambda: kf._stream(p))


def phase_main(device, n_jobs=N_JOBS, num_workers=NUM_WORKERS):
    """The main path, with the kernels' launch counts set to 0 just before
    it and read just after it."""
    from repro_torch import testing
    from repro_torch.kernels import structured_pdhg_step as kernel_mod
    from repro_torch.problems.cluster_scheduling import (GavelProblem,
                                                         gandiva_heuristic)
    from repro_torch.service import PopService
    insts = testing.session_instances(n_jobs, num_workers, CHURN)
    service = PopService(device=device)
    sess = service.session("main", insts[0])
    zero_launches(kernel_mod)
    allocs = []
    t_run = time.perf_counter()
    for inst in insts:
        allocs.append(sess.step(inst))
        if device.type == "cuda":
            torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    launches = dict(kernel_mod.LAUNCHES)
    per_call = per_half_step(kernel_mod)
    for inst, a in zip(insts, allocs):
        its = np.asarray(a.raw.iterations)
        conv = np.asarray(a.raw.converged)
        base = GavelProblem(inst.wl).evaluate(
            gandiva_heuristic(inst.wl, space_sharing=False))
        row = dict(plan_cache=a.plan_cache, warm_fraction=a.warm_fraction,
                   k=a.k, engine=a.engine, backend=a.backend,
                   iterations_sum=int(its.sum()), iterations_max=int(its.max()),
                   converged=f"{int(conv.sum())}/{conv.size}",
                   build_s=a.build_time_s, solve_s=a.solve_time_s,
                   ms_per_iteration=a.solve_time_s * 1e3 / max(int(its.max()),
                                                               1),
                   mean_norm_throughput=a.metrics["mean_norm_throughput"],
                   min_norm_throughput=a.metrics["min_norm_throughput"],
                   gandiva_mean_norm_throughput=base["mean_norm_throughput"],
                   gandiva_min_norm_throughput=base["min_norm_throughput"])
        log("[main] " + json.dumps(row))
        check(a.engine == "fused_structured", f"engine {a.engine}")
        check(a.alloc.shape == (inst.n_jobs,),
              f"allocation shape {a.alloc.shape}")
        check(np.isfinite(a.alloc).all(), "allocation not finite")
        check(conv.all(), f"{int((~conv).sum())} lane(s) did not converge")
        check(a.metrics["min_norm_throughput"]
              > 2.0 * base["min_norm_throughput"],
              "allocation does not beat the Gandiva heuristic's fairness "
              "twice over")
    verdicts = [a.plan_cache for a in allocs]
    log(f"[main] verdicts {verdicts}; wall {wall:.3f} s; launches {launches}")
    log(f"[launches] main path: calls {launches}, CUDA launches "
        f"{dict(kernel_mod.CUDA_LAUNCHES)}, per half-step {per_call}")
    check(verdicts == ["miss", "hit", "repair"], f"verdicts {verdicts}")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")
    for name, per in per_call.items():
        check(per == 1, f"{name}: {per} CUDA launches per call, not one")
    return sess, insts, allocs, launches


# --------------------------------------------------------------------------
# the mesh layer (torch.distributed, an NCCL world of one)
# --------------------------------------------------------------------------

def _mesh(device):
    """The ("data", "model") host mesh: an NCCL world of one on the card,
    started on the first call."""
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(device=device)
    check(tuple(mesh.shape) == (1, 1) and mesh.device_type == "cuda",
          f"host mesh {tuple(mesh.shape)} on {mesh.device_type}")
    return mesh


def _backend_session(device, insts, backend, opts):
    """The main path's three steps through a session whose only change
    from the registry's defaults is the map backend."""
    from repro_torch.domains import registry
    from repro_torch.service import PopService
    spec = registry.get("gavel")
    ex = dataclasses.replace(spec.default_exec, backend=backend,
                             backend_opts=opts)
    sess = PopService(device=device).session(f"mesh-{backend}", insts[0],
                                             exec=ex)
    allocs = []
    for inst in insts:
        allocs.append(sess.step(inst))
        torch.cuda.synchronize()
    return allocs


def phase_mesh_pop(device, insts, main_allocs):
    """The main path's session through ``backend="shard_map"`` on
    ``make_host_mesh()`` (axis "data"), again with ``chunk=1`` (the rank
    walks its lanes one at a time), and ``backend="pmap"`` over its
    default devices (every visible card: ``[cuda:0]`` here): each step's
    allocation and per-lane iterations bit-equal
    to the ``vmap`` session's of the main phase; the lane kernels' launch
    counts over each session, and the kernels held against their plain
    versions at a lane slice the backend launched."""
    from repro_torch.core import backends, pdhg
    from repro_torch.kernels import structured_pdhg_step as kernel_mod
    mesh = _mesh(device)
    launched = []
    inner = backends._solve_batch

    def recording(batch, *a, **kw):
        launched.append(batch[0])
        return inner(batch, *a, **kw)

    runs, first = {}, {}
    backends._solve_batch = recording
    try:
        for name, backend, opts in (
                ("shard_map", "shard_map", {"mesh": mesh, "axis": "data"}),
                ("shard_map chunk=1", "shard_map",
                 {"mesh": mesh, "axis": "data", "chunk": 1}),
                ("pmap", "pmap", {})):
            zero_launches(kernel_mod)
            launched.clear()
            allocs = _backend_session(device, insts, backend, opts)
            first[name] = launched[0]
            runs[name] = (backend, allocs, dict(kernel_mod.LAUNCHES),
                          per_half_step(kernel_mod))
    finally:
        backends._solve_batch = inner
    for name, (backend, allocs, launches, per_call) in runs.items():
        for a, want in zip(allocs, main_allocs):
            its, want_its = (np.asarray(a.raw.iterations),
                             np.asarray(want.raw.iterations))
            log(f"[mesh-pop] {name} {a.plan_cache}: backend {a.backend}, "
                f"engine {a.engine}, build_s {a.build_time_s:.4f} / "
                f"solve_s {a.solve_time_s:.4f} (vmap {want.build_time_s:.4f}"
                f" / {want.solve_time_s:.4f}), iterations "
                f"{its.tolist()}")
            check(a.backend == backend and a.engine == "fused_structured",
                  f"{backend}: ran {a.backend} / {a.engine}")
            check(a.plan_cache == want.plan_cache,
                  f"{name}: verdict {a.plan_cache} against "
                  f"{want.plan_cache}")
            check(np.array_equal(a.alloc, want.alloc),
                  f"{name} {a.plan_cache}: allocation differs from "
                  "vmap's")
            check(np.array_equal(its, want_its),
                  f"{name} {a.plan_cache}: per-lane iterations differ "
                  "from vmap's")
        log(f"[mesh-pop] {name}: allocations and per-lane iterations of "
            f"all three steps bit-equal to vmap's; launches {launches}, "
            f"CUDA launches per call {per_call}")
        for kernel, n in launches.items():
            check(n > 0, f"{kernel} was not launched through {name}")
        for kernel, per in per_call.items():
            check(per == 1, f"{kernel}: {per} CUDA launches per call")
    for name in ("shard_map", "shard_map chunk=1"):
        hold_at_shape(f"the {name} session's lane slice", first[name],
                      pdhg.fused_structured_engine(),
                      pdhg.fused_structured_engine("ref"), lane_calls,
                      device, prefix="mesh-pop")


MESH_TRAIN_STEPS = 2
MESH_CKPT_LEAVES = ("embed", "final_norm")


def _host_tree(tree):
    from repro_torch.core import placement as pl
    return pl.zip_map(lambda t: t.detach().to("cpu", copy=True),
                      pl.full_tree(tree))


def _mesh_train_run(device, cfg, tcfg, batches, mesh):
    """MESH_TRAIN_STEPS steps from TRAIN_SEED, unsharded (``mesh=None``)
    or through ``jit_train_step`` from state built on the mesh as
    ``launch.train --mesh`` builds it (``init_placed_params``, each rank
    keeping its blocks as they are drawn): ``(params, per-step ms,
    metrics)``."""
    from repro_torch import models
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.train_step import (init_placed_params,
                                              init_placed_state,
                                              jit_train_step,
                                              make_train_step)
    gen = torch.Generator(device).manual_seed(TRAIN_SEED)
    if mesh is None:
        params = models.init_params(gen, cfg)
        opt = opt_mod.init_state(params)
        step = make_train_step(cfg, tcfg)
    else:
        params = init_placed_params(gen, cfg, mesh)
        opt = init_placed_state(params)
        step = jit_train_step(cfg, tcfg, mesh, device=device)
    ms, metrics = [], []
    for batch in batches:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, opt, m = step(params, opt, batch)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        metrics.append({k: float(v) for k, v in m.items()})
    del opt
    return params, ms, metrics


def _dryrun_compute(cfg_layers: int) -> dict:
    """``launch.dryrun``'s count of the mesh-train cell (llama3-8b cut to
    ``cfg_layers`` layers, TRAIN_BATCH x TRAIN_SEQ, 2 microbatches, a
    (1, 1) mesh) in a child process (the fake group of the dry run needs
    a process without the smoke's NCCL group)."""
    code = (
        "import dataclasses, json\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.launch import dryrun, specs\n"
        f"cfg = get_config({TRAIN_ARCH!r})\n"
        "(seg,) = cfg.segments\n"
        "cfg = dataclasses.replace(cfg, segments=(dataclasses.replace("
        f"seg, n_periods={cfg_layers}),))\n"
        f"cell = specs.ShapeCell('mesh-train', {TRAIN_SEQ}, {TRAIN_BATCH},"
        " 'train')\n"
        f"r = dryrun.lower_cell({TRAIN_ARCH!r}, 'mesh-train', False, "
        "cfg=cfg, mesh_shape=(1, 1), cell=cell, n_micro=2)\n"
        "print(json.dumps({k: r[k] for k in ('flops', 'bytes_accessed', "
        "'collectives', 'model_flops', 'lower_s')}))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=CHILD_TIMEOUT_S)
    check(proc.returncode == 0, f"the dry run's child failed: "
          f"{proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def phase_mesh_train(device, card: str):
    """llama3-8b at full width cut to TRAIN_LAYERS, MESH_TRAIN_STEPS steps
    of TRAIN_BATCH x TRAIN_SEQ tokens (2 microbatches, bf16, remat) through
    ``make_train_step`` and then through ``jit_train_step`` on the (1, 1)
    mesh, from the same seed and batches: losses, grad norms and every
    parameter bit-equal; ms a step, tokens/s, ``max_memory_allocated``;
    the compute term ``launch.dryrun`` counts for the same cell.  Writes
    a checkpoint of the mesh run's MESH_CKPT_LEAVES from the mesh;
    returns ``(directory, step, host copy of what it wrote)``."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.data import DevicePrefetcher, TokenPipeline
    from repro_torch.models.transformer import leaves
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.train_step import TrainConfig
    mesh = _mesh(device)
    cfg = cut_depth(get_config(TRAIN_ARCH), TRAIN_LAYERS)
    tcfg = TrainConfig(n_microbatches=2, compute_dtype="bfloat16",
                       remat=True, adamw=opt_mod.AdamWConfig())
    pipe = DevicePrefetcher(TokenPipeline(vocab=cfg.vocab, batch=TRAIN_BATCH,
                                          seq=TRAIN_SEQ, seed=TRAIN_SEED),
                            device, mesh=mesh)
    try:
        staged = [next(pipe) for _ in range(MESH_TRAIN_STEPS)]
    finally:
        pipe.close()
    check(all(type(v).__name__ == "DTensor" for b in staged
              for v in b.values()),
          "DevicePrefetcher(mesh=) did not hand out DTensors")
    batches = [{k: v.to_local() for k, v in b.items()} for b in staged]
    torch.cuda.empty_cache()
    plain, plain_ms, plain_m = _mesh_train_run(device, cfg, tcfg, batches,
                                               None)
    want = [t.detach().to("cpu", copy=True) for t in leaves(plain)]
    del plain
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    params, ms, metrics = _mesh_train_run(device, cfg, tcfg, staged, mesh)
    peak = torch.cuda.max_memory_allocated(device)
    got = list(leaves(params))
    places = sorted({tuple(repr(p) for p in t.placements) for t in got})
    equal = sum(bool(torch.equal(g.to_local().cpu(), w))
                for g, w in zip(got, want))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = train_flops(cfg, tokens, TRAIN_SEQ, remat=True)
    for i, (a, b, t, u) in enumerate(zip(metrics, plain_m, ms, plain_ms)):
        log(f"[mesh-train] step {i}: loss {a['loss']:.6f} (unsharded "
            f"{b['loss']:.6f}), grad_norm {a['grad_norm']:.6f} "
            f"({b['grad_norm']:.6f}); {t:.2f} ms (unsharded {u:.2f} ms), "
            f"{tokens / t * 1e3:.1f} tokens/s")
        check(a == b, f"step {i}: mesh metrics {a} against {b}")
    log(f"[mesh-train] {cfg.name} cut to {cfg.n_layers} layers on the "
        f"{tuple(mesh.shape)} mesh, placements {places}: {equal} of "
        f"{len(got)} parameter leaves bit-equal to the unsharded step's; "
        f"max_memory_allocated {peak / 1e9:.3f} GB; {flops:.4g} model FLOPs "
        f"a step = {flops / (ms[-1] / 1e3) / PEAK_BF16_PER_S:.3f} of the "
        f"dense bf16 peak at the last step, on {card}")
    check(equal == len(got), f"{len(got) - equal} parameter leaves differ "
          "from the unsharded step's")
    dry = _dryrun_compute(TRAIN_LAYERS)
    log(f"[mesh-train] launch.dryrun on the same cell (meta tensors, a "
        f"fake (1, 1) group): {dry['flops']:.4g} FLOPs a device = "
        f"{dry['flops'] / PEAK_BF16_PER_S * 1e3:.2f} ms at "
        f"{PEAK_BF16_PER_S / 1e12:.0f} TFLOP/s (against {ms[-1]:.2f} ms "
        f"measured), {dry['bytes_accessed']:.4g} bytes (unfused bound), "
        f"collectives {dry['collectives']}, model FLOPs "
        f"{dry['model_flops']:.4g}, traced in {dry['lower_s']} s")
    ckdir = ROOT / "build" / "mesh_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    tree = {"params": {k: params[k] for k in MESH_CKPT_LEAVES}}
    t0 = time.perf_counter()
    Checkpointer(str(ckdir)).save(MESH_TRAIN_STEPS, tree,
                                  extras={"step": MESH_TRAIN_STEPS})
    log(f"[mesh-train] checkpoint of {MESH_CKPT_LEAVES} from the mesh in "
        f"{time.perf_counter() - t0:.2f} s")
    host = _host_tree(tree)
    del params, got, want, tree, staged, batches
    torch.cuda.empty_cache()
    return str(ckdir), MESH_TRAIN_STEPS, host


MESH_SERVE_PROMPT, MESH_SERVE_TOKENS = 16, 16


def phase_mesh_serve(device):
    """llama3-8b at full width (bf16 serving weights from SERVE_SEED),
    batch SERVE_BATCH, a SERVE_MAX_SEQ cache: a MESH_SERVE_PROMPT-token
    prompt and MESH_SERVE_TOKENS greedy tokens through the unsharded
    step and through ``jit_serve_step`` on the (1, 1) mesh: equal
    tokens, ms a step of each."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    mesh = _mesh(device)
    cfg = get_config(SERVE_ARCH)
    params = serve.build_params(cfg, SERVE_SEED, device)
    prompt = serve.random_prompt(cfg, SERVE_BATCH, MESH_SERVE_PROMPT,
                                 SERVE_SEED, device)
    runs = {}
    for name, m in (("unsharded", None), ("mesh", mesh)):
        runs[name] = run = serve.serve(cfg, params, prompt,
                                       MESH_SERVE_TOKENS, SERVE_MAX_SEQ,
                                       mesh=m)
        log(f"[mesh-serve] {name}: {run.step_ms:.4f} ms a step (CUDA "
            f"events), {run.tokens_per_s:.1f} tok/s, prefill "
            f"{run.prefill_s:.3f} s, max_memory_allocated "
            f"{run.peak_bytes / 1e9:.3f} GB")
        check(bool(torch.isfinite(run.final_logits).all()),
              f"{name}: non-finite logits")
    check(torch.equal(runs["mesh"].tokens, runs["unsharded"].tokens),
          "the mesh step's tokens differ from the unsharded step's")
    check(torch.equal(runs["mesh"].final_logits,
                      runs["unsharded"].final_logits),
          "the mesh step's final logits differ from the unsharded step's")
    log(f"[mesh-serve] {SERVE_BATCH} x {MESH_SERVE_TOKENS} greedy tokens "
        "and the final logits bit-equal to the unsharded step's; first "
        f"tokens {runs['mesh'].tokens[0, :8].tolist()}")
    del params
    torch.cuda.empty_cache()


MESH_TP_RANKS = 2
MESH_TP_TOKENS = 16
MESH_TP_TRAIN_LAYERS, MESH_TP_TRAIN_BATCH, MESH_TP_TRAIN_SEQ = 2, 2, 128
MESH_TP_TRAIN_TOL = 1e-5
MESH_TP_PEAK_SHARE = 0.6
MESH_TP_TIMEOUT_S = 240


def _tp_greedy(step, params, cache, prompt, n_tokens: int, forced=None):
    """``prompt`` prefilled through ``step``, then ``n_tokens - 1`` more
    steps, each fed the step's own greedy token or, teacher-forced, the
    tokens ``forced`` [B, n_tokens] (step ``i`` fed ``forced[:, i - 1]``):
    ``(every step's logits [n_tokens, B, V] f32 on the host, the step's
    greedy tokens [B, n_tokens], their top-two gaps [B, n_tokens], ms a
    step by CUDA events)``.  A step's logits are this rank's vocab block
    where the vocab splits; they are kept on the card and gathered whole
    over the CPU after the timed steps."""
    import torch.distributed as dist

    def local(t):
        return t.to_local() if hasattr(t, "to_local") else t

    def whole(logits, local_logits):
        if not hasattr(logits, "to_local") or not dist.is_initialized() \
                or dist.get_world_size() == 1 or not any(
                    p.is_shard() for p in logits.placements):
            return local_logits.cpu()
        # gathered where they lie: NCCL takes no host tensor
        block = local_logits.contiguous()
        parts = [torch.empty_like(block)
                 for _ in range(dist.get_world_size())]
        dist.all_gather(parts, block)
        return torch.cat(parts, dim=-1).cpu()

    for t in range(prompt.shape[1] - 1):
        _, cache, _ = step(params, cache, prompt[:, t:t + 1])
    tok, cache, logits = step(params, cache, prompt[:, -1:])
    steps = [(logits, local(logits)[:, -1].float())]
    toks = [local(tok)]
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(1, n_tokens):
        feed = tok if forced is None else forced[:, i - 1:i].to(
            local(tok).device)
        tok, cache, logits = step(params, cache, feed)
        steps.append((logits, local(logits)[:, -1].float()))
        toks.append(local(tok))
    end.record()
    end.synchronize()
    every = torch.stack([whole(lg, loc) for lg, loc in steps])
    top = torch.topk(every, 2, dim=-1).values
    return (every, torch.cat(toks, 1).cpu(), (top[..., 0] - top[..., 1]).t(),
            start.elapsed_time(end) / (n_tokens - 1))


def _tp_serve_one(cfg, device, prompt):
    """The world-of-one step on this process's card (``make_serve_step``):
    in bf16 (the serving cast of the draws) its greedy run, with every
    step's logits, tokens, top-two gaps, ms a step and
    ``max_memory_allocated`` with the weights and the cache in place;
    then in f32, from the same draws, every step's logits teacher-forced
    with the bf16 run's tokens (each step's bf16-to-f32 distance)."""
    from repro_torch import models
    from repro_torch.serve.engine import ServeConfig, make_serve_step
    out = {}
    for dtype in ("bfloat16", "float32"):
        gen = torch.Generator(device).manual_seed(SERVE_SEED)
        params = models.init_params(gen, cfg)
        if dtype == "bfloat16":
            params = models.serving_params(params, torch.bfloat16)
        scfg = ServeConfig(batch=SERVE_BATCH, max_seq=SERVE_MAX_SEQ,
                           compute_dtype=dtype)
        cache = models.init_cache(cfg, SERVE_BATCH, SERVE_MAX_SEQ,
                                  kv_dtype=scfg.dtype, device=device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        step = make_serve_step(cfg, scfg, with_logits=True)
        forced = None if dtype == "bfloat16" else out["bfloat16"][1]
        with torch.no_grad():
            out[dtype] = _tp_greedy(step, params, cache, prompt,
                                    MESH_TP_TOKENS, forced)
        out[dtype + "_peak"] = torch.cuda.max_memory_allocated(device)
        del cache, params
        torch.cuda.empty_cache()
    return out


def _tp_train(cfg, device, mesh):
    """One f32 step of ``cfg`` unsharded and through ``jit_train_step`` on
    ``mesh`` from the same draws and batch: ``(loss and grad_norm of
    each, largest difference of this rank's parameter blocks)``."""
    from repro_torch import models, testing
    from repro_torch.core import placement as pl
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.train_step import (TrainConfig, init_placed_state,
                                              jit_train_step,
                                              make_train_step, place_params)
    tcfg = TrainConfig(n_microbatches=1, compute_dtype="float32",
                       adamw=opt_mod.AdamWConfig(**testing.PARITY_ADAMW))
    batch = testing.train_batch(cfg, MESH_TP_TRAIN_BATCH, MESH_TP_TRAIN_SEQ,
                                seed=TRAIN_SEED, device=device)

    def draw():
        return models.init_params(
            torch.Generator(device).manual_seed(TRAIN_SEED), cfg)

    import torch.distributed as dist
    # the unsharded steps one rank at a time (each holds 16 B a parameter)
    for rank in range(dist.get_world_size()):
        if rank == dist.get_rank():
            params = draw()
            params, opt, plain = make_train_step(cfg, tcfg)(
                params, opt_mod.init_state(params), batch)
            plain = {k: float(v) for k, v in plain.items()}
            del opt
            torch.cuda.empty_cache()
        dist.barrier()
    placed = place_params(draw(), mesh)
    placed, opt, got = jit_train_step(cfg, tcfg, mesh, device=device)(
        placed, init_placed_state(placed), batch)
    got = {k: float(v) for k, v in got.items()}
    diff = max(float((b.to_local() - pl.local_slice(
        w, b.placements, mesh)).abs().max())
        for b, w in zip(models.transformer.leaves(placed),
                        models.transformer.leaves(params)))
    return got, plain, diff


def mesh_tp_rank(rank: int, store: str, out_path: str,
                 device=torch.device("cuda", 0)) -> None:
    """One rank of the mesh-tp phase (``python chip_smoke.py --mesh-tp-rank
    RANK STORE OUT``): a gloo group of MESH_TP_RANKS processes on card 0
    and the (1, MESH_TP_RANKS) ("data", "model") mesh over it.  Rank 0
    runs the world-of-one step first while the other ranks wait; then
    every rank serves, teacher-forced with the world of one's tokens,
    and trains through the split steps.  Rank 0
    writes the report to ``out_path``."""
    from datetime import timedelta

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.serve.engine import (ServeConfig, jit_serve_step,
                                          place_cache)
    from repro_torch import models
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("gloo", store=dist.FileStore(store,
                                                         MESH_TP_RANKS),
                            rank=rank, world_size=MESH_TP_RANKS,
                            timeout=timedelta(seconds=MESH_TP_TIMEOUT_S))
    mesh = init_device_mesh(device.type, (1, MESH_TP_RANKS),
                            mesh_dim_names=("data", "model"))
    cfg = get_config(SERVE_ARCH)
    prompt = serve.random_prompt(cfg, SERVE_BATCH, MESH_SERVE_PROMPT,
                                 SERVE_SEED, device)
    report = {}
    if rank == 0:
        report["one"] = _tp_serve_one(cfg, device, prompt)
    # the split run is teacher-forced with the world of one's tokens
    box = [report["one"]["bfloat16"][1] if rank == 0 else None]
    dist.broadcast_object_list(box, src=0)
    params = serve.build_params(cfg, SERVE_SEED, device, mesh=mesh)
    scfg = ServeConfig(batch=SERVE_BATCH, max_seq=SERVE_MAX_SEQ)
    cache = place_cache(models.init_cache(cfg, SERVE_BATCH, SERVE_MAX_SEQ,
                                          kv_dtype=scfg.dtype,
                                          device=device),
                        SERVE_BATCH, mesh, scfg)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    step = jit_serve_step(cfg, scfg, mesh, device=device.type,
                          with_logits=True)
    with torch.no_grad():
        tp = _tp_greedy(step, params, cache, prompt, MESH_TP_TOKENS,
                         forced=box[0])
    peak = torch.cuda.max_memory_allocated(device)
    local_bytes = sum(t.to_local().numel() * t.to_local().element_size()
                      for t in models.transformer.leaves(params))
    del params, cache, step
    torch.cuda.empty_cache()
    peaks = [None] * MESH_TP_RANKS
    dist.all_gather_object(peaks, (peak, local_bytes))
    train = _tp_train(cut_depth(get_config(TRAIN_ARCH), MESH_TP_TRAIN_LAYERS),
                      device, mesh)
    trains = [None] * MESH_TP_RANKS
    dist.all_gather_object(trains, train)
    if rank == 0:
        report.update(tp=tp, peaks=peaks, trains=trains)
        torch.save(report, out_path)
    dist.barrier()
    dist.destroy_process_group()


def phase_mesh_tp(device):
    """Tensor parallelism on the card: MESH_TP_RANKS processes (this file
    with ``--mesh-tp-rank``) on card 0 over gloo; see the module
    docstring's ``mesh-tp``."""
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 1e9
    log(f"[mesh-tp] this process holds {held:.3f} GB "
        f"({torch.cuda.memory_reserved() / 1e9:.3f} GB reserved) of the "
        "card beside the two ranks")
    work = ROOT / "build" / "mesh_tp"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    out = work / "report.pt"
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--mesh-tp-rank",
         str(r), str(work / "store"), str(out)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(MESH_TP_RANKS)]
    try:
        logs = [p.communicate(timeout=MESH_TP_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for r, (p, text) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"mesh-tp rank {r}: exit {p.returncode}\n"
              f"{text[-3000:]}")
    _mesh_tp_verdict(torch.load(out), wall)


def _mesh_tp_verdict(rep: dict, wall: float) -> None:
    """Log and check rank 0's mesh-tp report."""
    log(f"[mesh-tp] {MESH_TP_RANKS} processes on card 0 over gloo, a (1, "
        f"{MESH_TP_RANKS}) mesh; llama3-8b full width bf16, batch "
        f"{SERVE_BATCH}, a {SERVE_MAX_SEQ}-slot cache, "
        f"{MESH_SERVE_PROMPT}-token prompt, {MESH_TP_TOKENS} steps "
        "teacher-forced with the world of one's greedy tokens")
    tp_serve_verdict("mesh-tp", rep["one"], rep["tp"], rep["peaks"],
                     MESH_TP_PEAK_SHARE, "each rank's collectives over gloo "
                     "through the host")
    for r, (got, plain, pdiff) in enumerate(rep["trains"]):
        log(f"[mesh-tp] train rank {r}: loss {got['loss']:.7f} (unsharded "
            f"{plain['loss']:.7f}), grad_norm {got['grad_norm']:.7f} "
            f"({plain['grad_norm']:.7f}), largest parameter difference "
            f"{pdiff:.3g}")
        for k in ("loss", "grad_norm"):
            check(abs(got[k] - plain[k]) <= MESH_TP_TRAIN_TOL * abs(plain[k]),
                  f"mesh-tp train rank {r}: {k} {got[k]} against "
                  f"{plain[k]}")
        check(pdiff <= MESH_TP_TRAIN_TOL,
              f"mesh-tp train rank {r}: parameters off by {pdiff}")
    log(f"[mesh-tp] wall {wall:.1f} s (two processes, world of one and "
        f"split runs); card {card_line()}")


def tp_serve_verdict(tag: str, one: dict, tp, peaks, peak_share: float,
                     how: str) -> None:
    """Log and check a split serving run against the world of one's:
    ``one`` is :func:`_tp_serve_one`'s report, ``tp`` the split run's
    :func:`_tp_greedy` teacher-forced with the world of one's tokens,
    ``peaks`` each rank's ``(max_memory_allocated, weight bytes)``."""
    from repro_torch import testing
    f32, bf16 = one["float32"][0], one["bfloat16"][0]
    # every step of the split run, teacher-forced with the world of one's
    # tokens, against the world of one's bf16 logits at that step, within
    # the step's testing.bf16_logit_tol (its f32 logits from the same
    # tokens)
    tols = [testing.bf16_logit_tol(f, b) for f, b in zip(f32, bf16)]
    diffs = [float((t - b).abs().max()) for t, b in zip(tp[0], bf16)]
    # the split run's own greedy token at a step may differ from the
    # world of one's only where the world of one's top two logits lie
    # closer than that step's tolerance
    want_toks, gaps = one["bfloat16"][1], one["bfloat16"][2]
    differ = want_toks != tp[1]
    at = differ.nonzero().tolist()
    wide = [(b, i) for b, i in at if float(gaps[b, i]) > tols[i]]
    gap = max((round(float(gaps[b, i]), 4) for b, i in at), default=None)
    one_peak = one["bfloat16_peak"]
    log(f"[{tag}] each step's logits against the world of one's: "
        f"largest difference {[round(d, 4) for d in diffs]}; "
        f"testing.bf16_logit_tol {[round(t, 4) for t in tols]}")
    log(f"[{tag}] the split run's own greedy tokens: {int(differ.sum())} "
        f"of {differ.numel()} differ from the world of one's, the largest "
        f"top-two gap there {gap}")
    log(f"[{tag}] ms a decode step: split {tp[3]:.3f} ({how}), world of one "
        f"{one['bfloat16'][3]:.3f}; max_memory_allocated a rank "
        f"{[round(p / 1e9, 3) for p, _ in peaks]} GB (weights "
        f"{[round(b / 1e9, 3) for _, b in peaks]} GB) against the "
        f"world of one's {one_peak / 1e9:.3f} GB")
    for i, (d, t) in enumerate(zip(diffs, tols)):
        check(d <= t, f"{tag} step {i}: logits off the world of one's "
              f"by {d} (tolerance {t})")
    check(not wide, f"{tag}: greedy tokens differ at (row, step) {wide}, "
          "where the top two logits are further apart than the tolerance")
    for r, (peak, _) in enumerate(peaks):
        check(peak <= peak_share * one_peak,
              f"{tag} rank {r}: peak {peak} above {peak_share} of "
              f"{one_peak}")


def phase_mesh_collectives(device, ckpt):
    """``compressed_psum`` over the NCCL world of one against the local
    quantise-dequantise with error feedback (two rounds, bit for bit);
    then the mesh-train checkpoint restored onto the mesh, bit-equal to
    what was written."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.models.transformer import leaves
    from repro_torch.train import compression as comp
    mesh = _mesh(device)
    gen = torch.Generator(device).manual_seed(3)
    grads = {"a": torch.randn((4096, 1024), generator=gen, device=device),
             "b": [torch.randn((1000,), generator=gen, device=device)]}
    res = comp.init_residuals(grads)
    want_res = comp.init_residuals(grads)
    for rnd in range(2):
        mean, res = comp.compressed_psum(grads, res,
                                         group=mesh.get_group("data"))
        for g, r, m, r_new in zip(leaves(grads), leaves(want_res),
                                  leaves(mean), leaves(res)):
            q, sc, r_want = comp.compress_with_feedback(g, r)
            deq = comp.dequantize_int8(q, sc, g.shape)
            check(torch.equal(m, deq) and torch.equal(r_new, r_want),
                  f"round {rnd}: compressed_psum differs from the local "
                  "quantise-dequantise")
            r.copy_(r_want)
        log(f"[mesh-collectives] compressed_psum round {rnd} over NCCL "
            "(world 1): the mean and residuals bit-equal to the local "
            f"int8 round trip with error feedback ({sum(g.numel() for g in leaves(grads)):,} "
            "values)")
    directory, step, host = ckpt
    ck = Checkpointer(directory)
    t0 = time.perf_counter()
    restored, extras = ck.restore(step, host, mesh=mesh)
    secs = time.perf_counter() - t0
    got, want = list(leaves(restored)), list(leaves(host))
    equal = sum(bool(torch.equal(g.to_local().cpu(), w))
                for g, w in zip(got, want))
    log(f"[mesh-collectives] the mesh-train checkpoint restored onto the "
        f"{tuple(mesh.shape)} mesh in {secs:.2f} s: {equal} of {len(got)} "
        f"leaves bit-equal, extras {extras}, placements "
        f"{sorted({tuple(repr(p) for p in t.placements) for t in got})}")
    check(equal == len(got) and extras == {"step": step},
          "the restored checkpoint differs from what was written")
    shutil.rmtree(directory, ignore_errors=True)


# --------------------------------------------------------------------------
# the tuner and MoE expert placement
# --------------------------------------------------------------------------

@contextlib.contextmanager
def _observing(module, name: str, on_result):
    """Within the block, ``module.name`` also hands every result it
    returns to ``on_result``; the original is put back on leaving."""
    inner = getattr(module, name)

    def observed(*args, **kw):
        out = inner(*args, **kw)
        on_result(out)
        return out

    setattr(module, name, observed)
    try:
        yield
    finally:
        setattr(module, name, inner)


def _log_profile(profile, wall: float) -> None:
    from repro_torch import tuning
    log(f"[tune] profile: platform {profile.platform}, device_count "
        f"{profile.device_count}, {profile.jax_version}, built in "
        f"{wall:.2f} s")
    for name, c in profile.domains.items():
        quality = [(int(k), round(q, 6)) for k, q in c.quality_vs_k]
        latency = [(int(k), round(t, 5), int(i))
                   for k, t, i in c.latency_vs_k]
        replication = [(int(k), th, round(q, 6), round(t, 5))
                       for k, th, q, t in c.replication]
        log(f"[tune] {name}: probe_n {c.probe_n}, n_exponent "
            f"{c.n_exponent:.4f}; quality_vs_k (k, rel) {quality}")
        log(f"[tune] {name}: latency_vs_k (k, solve_s, iterations) "
            f"{latency}")
        log(f"[tune] {name}: replication (k, threshold, rel, solve_s) "
            f"{replication}")
    lc = profile.launch_cost
    log(f"[tune] launch line: overhead_s {lc.get('overhead_s')}, per_lane_s "
        f"{lc.get('per_lane_s')}, rows (lanes, s) {lc.get('rows')}; "
        f"launch_defaults {tuning.launch_defaults(profile)}")
    log(f"[tune] backend thresholds {profile.backend_thresholds}")


def phase_tune(device, insts, main_allocs):
    """The tuner on the card: ``build_profile`` over the three generic
    domains at ``fast=False`` (what ``scripts/tune.py`` writes by default)
    with nothing else running, its seal through ``save_profile`` /
    ``load_profile``; a session on the main path's fleet at a 2% quality
    loss (cold, drift, churn) against the untuned k=8 steps and Gandiva's;
    a second session under an impossible deadline until the online tuner
    retunes k; the lane kernels held against their plain versions at both
    sessions' stacks; ``dispatch=True`` sized by the launch line.  The
    planned k follows the profile's timings, so the tuned steps are held
    to an untuned session at the planned configs, not to convergence: at
    some ks PDHG leaves a lane of this fleet at the iteration cap.  The
    installed thresholds are cleared and the launch counts put back
    afterwards."""
    import threading
    from repro_torch import tuning
    from repro_torch.core import backends as backends_mod
    from repro_torch.core import pdhg
    from repro_torch.core import pop as pop_mod
    from repro_torch.kernels import structured_full_pdhg_step as full_mod
    from repro_torch.kernels import structured_pdhg_step as kernel_mod
    from repro_torch.service import DispatchConfig, PopService
    saved = [(m, dict(m.LAUNCHES), dict(m.CUDA_LAUNCHES))
             for m in (kernel_mod, full_mod)]
    others = [t.name for t in threading.enumerate()
              if t is not threading.current_thread()]
    log(f"[tune] other threads before the profile: {others}")
    check(not any(n.startswith("pop-") for n in others),
          f"service threads running beside the profiler: {others}")
    engines: dict = {}

    def count(path):
        def seen(res):
            engines[path, res.engine] = engines.get((path, res.engine), 0) + 1
        return seen

    for mod, _, _ in saved:
        zero_launches(mod)
    with _observing(pop_mod, "solve_full_ex", count("k=1")), \
            _observing(pop_mod, "solve_instance", count("k>1")):
        t0 = time.perf_counter()
        profile = tuning.build_profile(
            domains=TUNE_DOMAINS, fast=False, device=device,
            log=lambda m: log(f"[tune] {m.strip()}"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _log_profile(profile, wall)
    log(f"[tune] the profile's solves by (path, engine): {engines}; lane "
        f"kernels {dict(kernel_mod.LAUNCHES)}, full kernels "
        f"{dict(full_mod.LAUNCHES)}")
    check(set(profile.domains) == set(TUNE_DOMAINS),
          f"profiled domains {sorted(profile.domains)}")
    check(profile.platform == "cuda" and
          profile.jax_version == "torch-" + torch.__version__,
          f"platform {profile.platform}, version {profile.jax_version}")
    check(profile.launch_cost and profile.backend_thresholds.get("cuda"),
          "no launch line or thresholds measured")
    path = ROOT / "build" / "TUNING_profile.smoke.json"
    path.parent.mkdir(exist_ok=True)
    tuning.save_profile(profile, path)
    loaded = tuning.check_profile(tuning.load_profile(path),
                                  platform="cuda")
    check(loaded.digest == profile.digest
          and tuning.profile_digest(loaded) == profile.digest,
          "the seal did not survive save_profile / load_profile")
    log(f"[tune] sealed {profile.digest[:23]}..., read back from "
        f"{path.relative_to(ROOT)} and checked")

    stacks: list = []
    with _observing(pop_mod, "build", stacks.append):
        # 3. a session planned from the profile at a 2% quality loss
        service = PopService(device=device, profile=profile)
        sess = service.session("tuned", insts[0], slo=tuning.SLOTarget(
            max_quality_loss=TUNE_SLO_LOSS))
        plan = sess._tuner.plan
        log(f"[tune] plan for {insts[0].n_jobs} jobs at max_quality_loss "
            f"{TUNE_SLO_LOSS}: k {plan.solve.k}, source {plan.source}, "
            f"predicted_quality_loss {plan.predicted_quality_loss:.6f}, "
            f"predicted_step_s {plan.predicted_step_s}")
        max_iters = int(sess.exec_cfg.solver_dict().get("max_iters",
                                                         20_000))
        zero_launches(kernel_mod)
        del stacks[:]
        allocs = []
        for inst, untuned in zip(insts, main_allocs):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            a = sess.step(inst)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t1
            allocs.append(a)
            its = np.asarray(a.raw.iterations)
            conv = np.asarray(a.raw.converged)
            base = _gandiva(inst)
            m = a.metrics
            log("[tune] tuned " + json.dumps(dict(
                plan_cache=a.plan_cache, k=a.k, engine=a.engine,
                backend=a.backend, warm_fraction=a.warm_fraction,
                iterations_sum=int(its.sum()),
                iterations_max=int(its.max()),
                converged=f"{int(conv.sum())}/{conv.size}",
                build_s=a.build_time_s, solve_s=a.solve_time_s,
                wall_s=wall_s, predicted_step_s=plan.predicted_step_s,
                mean_norm_throughput=m["mean_norm_throughput"],
                min_norm_throughput=m["min_norm_throughput"],
                untuned_k8_mean=untuned.metrics["mean_norm_throughput"],
                loss_against_untuned=1.0 - m["mean_norm_throughput"]
                / untuned.metrics["mean_norm_throughput"],
                predicted_quality_loss=plan.predicted_quality_loss,
                gandiva_mean=base["mean_norm_throughput"],
                gandiva_min=base["min_norm_throughput"])))
            check(a.status == "ok" and a.k == plan.solve.k,
                  f"tuned step: {a.status}, k {a.k}")
            # the plan's k follows the profile's timings, and PDHG leaves
            # a lane at the cap at some ks of this fleet (k = 1, 2, 32, 64;
            # tools/convergence_by_k.py): an unconverged lane must have run
            # the whole budget, and the control below holds the step to the
            # untuned session at the same configs
            check(bool((its[~conv] == max_iters).all()),
                  f"tuned step: unconverged lane(s) stopped at "
                  f"{its[~conv].tolist()}, not the {max_iters} cap")
            check(1.0 - m["mean_norm_throughput"]
                  / untuned.metrics["mean_norm_throughput"]
                  <= TUNE_SLO_LOSS, "tuned step loses more than the SLO "
                  "against the untuned k=8 step")
            check(m["min_norm_throughput"]
                  > 2.0 * base["min_norm_throughput"],
                  "tuned step does not beat Gandiva's fairness twice over")
        verdicts = [a.plan_cache for a in allocs]
        check(verdicts == ["miss", "hit", "repair"], f"verdicts {verdicts}")
        per_call = per_half_step(kernel_mod)
        log(f"[launches] tuned session: calls {dict(kernel_mod.LAUNCHES)}, "
            f"per half-step {per_call}")
        for name, n in kernel_mod.LAUNCHES.items():
            check(n > 0 and per_call[name] == 1,
                  f"tuned session: {name} {n} calls, {per_call[name]} CUDA "
                  "launches a call")
        tuned_stack = stacks[0]
        # the control: an untuned session at the planned configs takes the
        # same steps, lane for lane and bit for bit
        control = PopService(device=device).session(
            "control", insts[0], solve=sess.solve_cfg, exec=sess.exec_cfg)
        for a, inst in zip(allocs, insts):
            c = control.step(inst)
            same = (c.k == a.k and np.array_equal(
                np.asarray(c.raw.iterations), np.asarray(a.raw.iterations))
                and np.array_equal(np.asarray(c.raw.converged),
                                   np.asarray(a.raw.converged))
                and np.array_equal(c.alloc, a.alloc))
            log(f"[tune] control at k {c.k}, {c.plan_cache}: iterations "
                f"{np.asarray(c.raw.iterations).tolist()}, converged "
                f"{int(np.asarray(c.raw.converged).sum())}/{c.k}, equal to "
                f"the tuned step: {same}")
            check(same, f"the tuned {a.plan_cache} step differs from an "
                  "untuned session at the planned configs")
        st = service.stats()
        log(f"[tune] tuned service: slo_violations {st['slo_violations']}, "
            f"retunes {st['retunes']}")

        # 4. an impossible deadline: the online tuner doubles k
        svc2 = PopService(device=device, profile=profile)
        s2 = svc2.session("retune", insts[0], slo=tuning.SLOTarget(
            max_quality_loss=0.5, step_deadline_s=TUNE_DEADLINE_S))
        seq, ks = [], []
        for inst in [insts[0]] + [insts[1]] * TUNE_MAX_STEPS:
            seq.append(s2.step(inst))
            ks.append(seq[-1].k)
            if s2.stats["retunes"]:
                break
        k_before = ks[-1]
        del stacks[:]
        after = s2.step(insts[1])
        retuned_stack = stacks[0]
        churned = s2.step(insts[2])
        for a in seq + [after, churned]:
            log(f"[tune] retune session: k {a.k}, {a.plan_cache}, warm "
                f"fraction {a.warm_fraction}, solve_s {a.solve_time_s:.4f},"
                f" status {a.status}")
        st2 = svc2.stats()
        log(f"[tune] retune session: ks {ks + [after.k, churned.k]}, "
            f"slo_violations {st2['slo_violations']}, retunes "
            f"{st2['retunes']}, solve_cfg {s2.solve_cfg}")
        check(s2.stats["retunes"] > 0, f"no retune in {len(seq)} steps")
        check(after.k == 2 * k_before,
              f"retuned k {after.k}, not twice {k_before}")
        check(after.status == "ok" and after.warm_fraction is not None
              and after.warm_fraction > 0,
              f"the first step at the new k: {after.status}, warm fraction "
              f"{after.warm_fraction}")
        check(churned.plan_cache in ("repair", "hit")
              and churned.warm_fraction is not None
              and churned.warm_fraction > 0,
              f"the churn step at the new k: {churned.plan_cache}, warm "
              f"fraction {churned.warm_fraction}")
        check(st2["slo_violations"] > 0 and st2["retunes"] > 0,
              f"counters {st2['slo_violations']}, {st2['retunes']}")

    # the lane kernels at the two sessions' stacks, against their plain
    # versions
    lanes_eng = pdhg.fused_structured_engine()
    for tag, op in (("the tuned session's cold stack", tuned_stack),
                    ("the retuned session's stack", retuned_stack)):
        hold_at_shape(tag, op, lanes_eng, pdhg.fused_structured_engine("ref"),
                      lane_calls, device, prefix="tune")

    # 5. dispatch=True sized by the launch line
    tuned = tuning.launch_defaults(profile)
    with PopService(device=device, profile=profile, dispatch=True) as svc3:
        cfg = svc3.dispatcher.cfg
    log(f"[tune] PopService(profile=..., dispatch=True): {cfg}")
    check(cfg == (DispatchConfig(**tuned) if tuned else DispatchConfig()),
          f"dispatch config {cfg} against launch_defaults {tuned}")
    backends_mod.install_tuned_thresholds(None)
    for mod, calls, cuda in saved:
        mod.LAUNCHES.update(calls)
        mod.CUDA_LAUNCHES.update(cuda)
    return profile


def _moe_row(name, ev, res=None, wall=None) -> dict:
    row = {"run": name}
    if res is not None:
        raw = res.res if hasattr(res, "res") else res
        its = np.atleast_1d(np.asarray(raw.iterations))
        conv = np.atleast_1d(np.asarray(raw.converged))
        row.update(engine=res.engine, backend=res.backend,
                   solve_s=res.solve_time_s, build_s=res.build_time_s,
                   wall_s=wall, iterations_sum=int(its.sum()),
                   iterations_max=int(its.max()),
                   converged=f"{int(conv.sum())}/{conv.size}")
    row.update({k: ev[k] for k in ("served", "served_fraction", "objective",
                                   "n_moved", "movement", "mem_feasible")})
    return row


def phase_moe(device):
    """MoE expert placement on the card: ``benchmarks/
    bench_moe_placement.py``'s defaults (full, POP-4, POP-8, the greedy)
    held to ``tests/test_domains.py``'s gates; a ``moe_placement``
    session at 4,096 experts on 64 devices (cold, drift, churn) with the
    greedy beside each step; ``expert_gate_load`` at DeepSeek-V3's router
    width over 16,384 tokens, fed to ``plan_expert_placement``.  Returns
    the session and its last instance for the profiled step later."""
    from repro_torch import testing
    from repro_torch.core.config import SolveConfig
    from repro_torch.domains import (greedy_placement,
                                     make_placement_instance, place_experts)
    from repro_torch.domains.moe_placement import (MoEPlacementInstance,
                                                   _evaluate)
    from repro_torch.models.moe import (expert_gate_load,
                                        plan_expert_placement)
    from repro_torch.service import PopService

    # 1. the bench's row
    inst = make_placement_instance(MOE_BENCH_EXPERTS, MOE_BENCH_DEVICES,
                                   seed=0)
    runs = {}
    for name, cfg in [("full", SolveConfig(k=1))] + [
            (f"pop{k}", SolveConfig(k=k, strategy="stratified"))
            for k in MOE_BENCH_KS]:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, res, ev = place_experts(inst, solve_cfg=cfg, device=device)
        torch.cuda.synchronize()
        runs[name] = ev
        log("[moe] bench " + json.dumps(_moe_row(
            name, ev, res, time.perf_counter() - t1)))
        check(res.engine == "matvec", f"{name}: engine {res.engine}")
    ev_g = _evaluate(inst, greedy_placement(inst))
    log("[moe] bench " + json.dumps(_moe_row("greedy", ev_g)))
    full = runs["full"]
    for k in MOE_BENCH_KS:
        ev = runs[f"pop{k}"]
        ratio = ev["objective"] / full["objective"]
        log(f"[moe] POP-{k}: objective {ratio:.6f} of the full one's, "
            f"n_moved {ev['n_moved']} against the greedy's "
            f"{ev_g['n_moved']}")
        check(ev["objective"] >= 0.985 * full["objective"],
              f"POP-{k} objective below 0.985 of the full one's")
        check(ev["mem_feasible"], f"POP-{k} placement over memory")
        check(ev["objective"] > ev_g["objective"],
              f"POP-{k} objective not above the greedy's")
        check(ev["n_moved"] < 0.5 * ev_g["n_moved"],
              f"POP-{k} moved {ev['n_moved']}, not below half the greedy's")

    # 2. a session of 16 DeepSeek-V3 layers' experts on 64 GPUs
    sess = PopService(device=device).session("moe", domain="moe_placement")

    def step(inst):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        a = sess.step(inst)
        torch.cuda.synchronize()
        g = _evaluate(inst, greedy_placement(inst))
        row = _moe_row(f"step {a.step} {a.plan_cache}", a.metrics, a.raw,
                       time.perf_counter() - t1)
        row.update(k=a.k, warm_fraction=a.warm_fraction,
                   greedy_served=g["served"], greedy_objective=g["objective"],
                   greedy_n_moved=g["n_moved"])
        log("[moe] session " + json.dumps(row))
        check(a.status == "ok" and a.engine == "matvec",
              f"session step: {a.status}, engine {a.engine}")
        check(a.alloc.shape == (inst.n_experts,)
              and ((a.alloc >= 0) & (a.alloc < inst.n_devices)).all()
              and a.metrics["mem_feasible"],
              f"session step {a.step}: the placement is not valid")
        return a

    insts, allocs = testing.moe_session(
        step, MOE_SESSION_EXPERTS, MOE_SESSION_DEVICES, MOE_DRIFT,
        MOE_CHURN)
    verdicts = [a.plan_cache for a in allocs]
    check(verdicts == ["miss", "hit", "repair"], f"verdicts {verdicts}")
    check(allocs[1].warm_fraction == 1.0
          and 0 < allocs[2].warm_fraction < 1.0,
          f"warm fractions {[a.warm_fraction for a in allocs]}")

    # 3. the router statistics at DeepSeek-V3's width, fed to the placer
    gen = torch.Generator(device=device).manual_seed(0)
    router = (torch.randn(GATE_D, GATE_E, generator=gen, device=device)
              / GATE_D ** 0.5).to(torch.bfloat16)
    x = torch.randn(1, GATE_TOKENS, GATE_D, generator=gen,
                    device=device).to(torch.bfloat16)
    gate_s = []
    for _ in range(2):          # the first call sets up the bf16 GEMM
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        load = expert_gate_load({"router": router}, x, top_k=GATE_TOP_K)
        gate_s.append(time.perf_counter() - t1)
    rel = abs(load.sum() - GATE_TOKENS) / GATE_TOKENS
    log(f"[moe] expert_gate_load D={GATE_D}, E={GATE_E}, top-{GATE_TOP_K}, "
        f"{GATE_TOKENS} tokens, bf16: first call {gate_s[0] * 1e3:.2f} ms,"
        f" second {gate_s[1] * 1e3:.2f} ms (with the copy to the host), "
        f"load sum "
        f"{load.sum():.6f} (relative error {rel:.3g}), min {load.min():.3f},"
        f" max {load.max():.3f}")
    check(load.shape == (GATE_E,) and (load >= 0).all(),
          f"gate load shape {load.shape}")
    check(rel < GATE_SUM_RTOL, f"gate load sums to {load.sum()}, not "
          f"{GATE_TOKENS} within {GATE_SUM_RTOL}")
    # against the plain version: in f32 on f32 copies of the same inputs,
    # then the bf16 load itself
    load32 = expert_gate_load({"router": router.float()}, x.float(),
                              top_k=GATE_TOP_K)
    plain32, _, _ = _plain_gate_load(router.float(), x.float(), GATE_TOP_K)
    rel32 = np.abs(load32 - plain32) / plain32
    plain, tied_mass, n_tied = _plain_gate_load(router, x, GATE_TOP_K)
    diff = np.abs(load - plain)
    allowed = tied_mass + GATE_BF16_RTOL * plain
    log(f"[moe] expert_gate_load against its plain host version: f32 "
        f"per-expert relative difference max {rel32.max():.3g} (limit "
        f"{GATE_F32_RTOL}); bf16 max {(diff / plain).max():.3g}, median "
        f"{np.median(diff / plain):.3g}, {n_tied} of {GATE_TOKENS} tokens "
        f"with a top-{GATE_TOP_K} cut tied within one bf16 step, tied mass "
        f"per expert up to {(tied_mass / plain).max():.3g} of its load, "
        f"difference at most {(diff / allowed).max():.3g} of the allowed "
        f"(tied mass + {GATE_BF16_RTOL} of the load)")
    check(rel32.max() < GATE_F32_RTOL,
          f"f32 expert_gate_load differs from its plain version by "
          f"{rel32.max():.3g} relative (expert {int(rel32.argmax())})")
    check((diff <= allowed).all(),
          f"bf16 expert_gate_load differs from its plain version beyond "
          f"the tied mass (expert {int((diff / allowed).argmax())}: "
          f"{diff.max():.3g})")
    t1 = time.perf_counter()
    placement = plan_expert_placement(load, GATE_DEVICES, device=device)
    place_s = time.perf_counter() - t1
    # the instance plan_expert_placement builds
    E = load.shape[0]
    pinst = MoEPlacementInstance(
        load=load, mem=np.ones(E), current=np.arange(E) % GATE_DEVICES,
        cap=np.full(GATE_DEVICES, np.ceil(2.0 * E / GATE_DEVICES)),
        compute=np.full(GATE_DEVICES, load.sum() / GATE_DEVICES))
    ev = _evaluate(pinst, placement)
    ev_g = _evaluate(pinst, greedy_placement(pinst))
    ev_c = _evaluate(pinst, pinst.current)
    log(f"[moe] plan_expert_placement onto {GATE_DEVICES} devices in "
        f"{place_s:.3f} s: " + json.dumps(dict(
            served=ev["served"], objective=ev["objective"],
            n_moved=ev["n_moved"], mem_feasible=ev["mem_feasible"],
            greedy_served=ev_g["served"], greedy_objective=ev_g["objective"],
            greedy_n_moved=ev_g["n_moved"], current_served=ev_c["served"],
            served_at_least_greedy=ev["served"] >= ev_g["served"])))
    check(ev["mem_feasible"], "the gate-load placement is over memory")
    check(ev["served"] > ev_c["served"],
          "the gate-load placement serves no more than the current one")
    check(ev["n_moved"] < ev_g["n_moved"],
          "the gate-load placement moves as many experts as the greedy")
    return sess, insts[-1]


def _plain_gate_load(router, x, top_k: int):
    """``expert_gate_load``'s plain version on the host: the logits in f32
    numpy from the same values, rounded to ``x``'s dtype as the port
    computes them, an f32 softmax, the top-k by argsort, the normalised
    gates summed per expert by a weighted bincount.  Also returns each
    expert's gate mass in tokens whose top-k cut it ties within one step
    of ``x``'s dtype (inside the top-k or just outside it): the mass a
    different tie-break or a logit rounded the other way can move."""
    xs = x.reshape(-1, x.shape[-1]).float().cpu().numpy()
    logits = torch.from_numpy(xs @ router.float().cpu().numpy())
    logits = logits.to(x.dtype).float().numpy()
    z = np.exp(logits - logits.max(-1, keepdims=True))
    probs = z / z.sum(-1, keepdims=True)
    top = np.argsort(-logits, axis=-1, kind="stable")[:, :top_k]
    top_sum = np.take_along_axis(probs, top, -1).sum(-1, keepdims=True)
    gates = np.take_along_axis(probs, top, -1) / (top_sum + 1e-9)
    E = router.shape[1]
    load = np.bincount(top.ravel(), weights=gates.ravel(), minlength=E)
    cut = np.take_along_axis(logits, top[:, -1:], -1)
    step = torch.finfo(x.dtype).eps * np.abs(cut)
    tied = np.abs(logits - cut) <= step
    tied_mass = (np.where(tied, probs, 0.0) / (top_sum + 1e-9)).sum(0)
    return load, tied_mass, int((tied.sum(-1) > 1).sum())


def phase_moe_profile(sess, inst):
    """One more step of the MoE session (a hit) under the profiler:
    kernels and device time per PDHG iteration."""
    per_call, a = profiled("moe-profile", lambda: sess.step(inst),
                           lambda a: np.max(a.raw.iterations))
    check(a.plan_cache == "hit" and a.engine == "matvec",
          f"profiled MoE step: {a.plan_cache}, {a.engine}")
    return per_call


def _timed(record: list, fn):
    """``fn`` wrapped to append its wall seconds to ``record``."""
    def run(*args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        record.append(time.perf_counter() - t0)
        return out
    return run


def _lane_max(a) -> int:
    return int(np.max(a.raw.iterations))


def phase_robust(device, insts):
    """The serving ladder on the main path's instances, through its own
    ``PopService`` (``main``'s session is left as it was): the lane
    quarantine (a NaN lane in the warm state, re-solved cold beside seven
    warm lanes through the lane kernels), the deadline ladder's three
    rungs, a checkpoint restored warm into a fresh service, damaged
    checkpoints restored cold, and paging with ``max_resident=1``.  The
    lane kernels' launch counts are put back as they were afterwards."""
    from repro_torch.analysis import faults
    from repro_torch.kernels import structured_pdhg_step as kernel_mod
    from repro_torch.problems.cluster_scheduling import (GavelProblem,
                                                         gandiva_heuristic)
    from repro_torch.service import PopService
    saved = dict(kernel_mod.LAUNCHES), dict(kernel_mod.CUDA_LAUNCHES)
    drift = insts[1]
    base = GavelProblem(drift.wl).evaluate(
        gandiva_heuristic(drift.wl, space_sharing=False))
    service = PopService(device=device)
    sess = service.session("robust", insts[0])
    solves = []
    inner = service._solve_instance

    def recording(*args, **kw):
        calls, cuda = dict(kernel_mod.LAUNCHES), dict(kernel_mod.CUDA_LAUNCHES)
        res = inner(*args, **kw)
        solves.append(dict(
            solve_s=res.solve_time_s, build_s=res.build_time_s,
            iterations=np.asarray(res.iterations).tolist(),
            diverged=int(np.asarray(res.diverged).sum()),
            calls={n: kernel_mod.LAUNCHES[n] - calls[n] for n in calls},
            cuda={n: kernel_mod.CUDA_LAUNCHES[n] - cuda[n] for n in cuda}))
        return res

    service._solve_instance = recording

    def step(s, inst, **kw):
        t0 = time.perf_counter()
        a = s.step(inst, **kw)
        return a, time.perf_counter() - t0

    # 1. rates: a cold step, then a warm hit
    cold, cold_wall = step(sess, insts[0])
    hit, hit_wall = step(sess, drift)
    key = ("pop", sess.spec.name, sess.exec_cfg, hit.k, drift.n_jobs)
    log(f"[robust] cold {cold.plan_cache} {cold_wall:.3f} s (solve "
        f"{cold.solve_time_s:.3f}), hit {hit.plan_cache} {hit_wall:.3f} s "
        f"(build {hit.build_time_s:.3f}, solve {hit.solve_time_s:.3f}, "
        f"lane-max {_lane_max(hit)} iterations); ladder rate "
        f"{service._rates[key] * 1e3:.4f} ms per iteration, overhead "
        f"{service._overheads[key]:.3f} s")
    check(cold.status == hit.status == "ok" and hit.plan_cache == "hit",
          f"clean steps: {cold.status}/{hit.status}, {hit.plan_cache}")

    # 2. the lane quarantine
    faults.poison_warm(sess, lanes=[3])
    del solves[:]
    rec, rec_wall = step(sess, drift)
    ws = rec.raw.warm_stats
    conv = np.asarray(rec.raw.converged)
    log(f"[robust] poisoned lane 3: status {rec.status}, faults "
        f"{rec.faults}, quarantined {ws['quarantined_lanes']}, warm "
        f"fraction {rec.warm_fraction}, converged {int(conv.sum())}/"
        f"{conv.size}, wall {rec_wall:.3f} s against the hit's "
        f"{hit_wall:.3f}; mean_norm_throughput "
        f"{rec.metrics['mean_norm_throughput']:.6f}, Gandiva "
        f"{base['mean_norm_throughput']:.6f}")
    for name, sv in zip(("warm solve", "retry"), solves):
        log(f"[robust]   {name}: solve {sv['solve_s']:.3f} s, build "
            f"{sv['build_s']:.3f} s, iterations per lane "
            f"{sv['iterations']}, {sv['diverged']} lane(s) diverged, calls "
            f"{sv['calls']}, CUDA launches {sv['cuda']}")
    check(rec.status == "recovered", f"status {rec.status}")
    check("divergence:1" in rec.faults, f"faults {rec.faults}")
    check(ws["quarantined_lanes"] == 1, f"warm_stats {ws}")
    check(0.0 < rec.warm_fraction < 1.0,
          f"warm fraction {rec.warm_fraction}")
    check(conv.all(), f"{int((~conv).sum())} lane(s) did not converge")
    check(np.isfinite(rec.alloc).all(), "recovered allocation not finite")
    check(rec.metrics["mean_norm_throughput"]
          > base["mean_norm_throughput"],
          "recovered allocation does not beat Gandiva's throughput")
    check(len(solves) == 2 and solves[0]["diverged"] == 1
          and solves[1]["diverged"] == 0, f"solves {solves}")
    retry = solves[1]
    for name, n in retry["calls"].items():
        check(n > 0, f"{name} was not launched in the quarantine retry")
        check(retry["cuda"][name] == n,
              f"{name}: {retry['cuda'][name]} CUDA launches for {n} calls")
    clean, _ = step(sess, drift)
    check(clean.status == "ok" and clean.faults == (),
          f"step after the quarantine: {clean.status} {clean.faults}")

    # 3. the deadline ladder
    loose, loose_wall = step(sess, drift, deadline_s=100.0)
    check(loose.status == "ok" and loose.faults == (),
          f"deadline 100 s: {loose.status} {loose.faults}")
    tight_s = 2.0
    service._overheads[key] = 0.0
    service._rates[key] = tight_s / 1000      # a budget of ~1,000 iterations
    tight, tight_wall = step(sess, drift, deadline_s=tight_s)
    check(tight.status == "degraded"
          and tight.faults in (("deadline:capped",),
                               ("deadline:best-effort",)),
          f"tight deadline: {tight.status} {tight.faults}")
    check(np.isfinite(tight.alloc).all(), "degraded allocation not finite")
    faults.inflate_rates(service, 1e6)
    fallback_s = 0.5
    fb, fb_wall = step(sess, drift, deadline_s=fallback_s)
    for tag, a, wall, dl in (("loose", loose, loose_wall, 100.0),
                             ("capped", tight, tight_wall, tight_s),
                             ("fallback", fb, fb_wall, fallback_s)):
        its = [] if a.raw is None else np.asarray(a.raw.iterations).tolist()
        log(f"[robust] deadline {dl} s ({tag}): status {a.status}, faults "
            f"{a.faults}, wall {wall:.4f} s, iterations per lane {its}, "
            f"mean_norm_throughput {a.metrics['mean_norm_throughput']:.6f}")
    check(fb.status == "fallback" and "deadline" in fb.faults,
          f"inflated rates: {fb.status} {fb.faults}")
    check(fb.metrics["fallback_source"] == "previous-allocation",
          f"fallback source {fb.metrics['fallback_source']}")
    check(fb_wall < 2 * fallback_s,
          f"fallback wall {fb_wall:.3f} s over twice its deadline")

    # 4. a checkpoint restored warm into a fresh service
    t0 = time.perf_counter()
    blob = service.checkpoint()
    ckpt_s = time.perf_counter() - t0
    fresh = PopService(device=device)
    t0 = time.perf_counter()
    report = fresh.restore(blob)
    restore_s = time.perf_counter() - t0
    check(report["restored"] == ["robust"], f"restore report {report}")
    back = fresh.session("robust")
    check(back._warm.x.is_cuda and back._warm.x.dtype == torch.float32,
          "restored iterates are not float32 on the card")
    a, _ = step(back, drift)
    b, _ = step(sess, drift)
    d_mean = abs(a.metrics["mean_norm_throughput"]
                 - b.metrics["mean_norm_throughput"])
    log(f"[robust] checkpoint {len(blob)} bytes in {ckpt_s:.4f} s, restore "
        f"{restore_s:.4f} s; restored step {a.plan_cache} at warm fraction "
        f"{a.warm_fraction}, lane-max {_lane_max(a)} iterations against "
        f"the uninterrupted session's {_lane_max(b)}, |d mean_norm_"
        f"throughput| {d_mean:.3g}")
    check(a.plan_cache == "hit" and a.warm_fraction == 1.0,
          f"restored step: {a.plan_cache} at {a.warm_fraction}")
    check(abs(_lane_max(a) - _lane_max(b)) <= 40,
          f"restored step's lane-max iterations {_lane_max(a)}, "
          f"uninterrupted {_lane_max(b)}")
    check(d_mean < 1e-4, f"restored quality differs by {d_mean:.3g}")

    # 5. damaged checkpoints restore cold; the service still serves
    for name in ("truncate-checkpoint", "corrupt-checkpoint"):
        damaged = PopService(device=device)
        report = damaged.restore(faults.FAULTS[name](blob))
        served, _ = step(damaged.session("robust", domain="gavel"), drift)
        failures = damaged.stats()["checkpoint_failures"]
        log(f"[robust] {name}: restored {report['restored']}, "
            f"checkpoint_failures {failures}; then {served.status} "
            f"{served.plan_cache}")
        check(report["restored"] == [] and failures == 1,
              f"{name}: {report}")
        check(served.status == "ok" and np.isfinite(served.alloc).all(),
              f"{name}: the service does not serve")

    # 6. paging: two tenants, one resident
    pager = PopService(device=device, max_resident=1)
    outs, ins, mems = [], [], []
    page_out = pager._page_out

    def paging_out(victim):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        done = _timed(outs, page_out)(victim)
        mems.append((before, torch.cuda.memory_allocated()))
        return done

    pager._page_out = paging_out
    pager._page_in = _timed(ins, pager._page_in)
    step(pager.session("A", insts[0]), insts[0])
    step(pager.session("B", insts[0]), insts[0])
    blob_bytes = pager.stats()["paged_bytes"]
    again, _ = step(pager.session("A"), drift)
    st = pager.stats()
    log(f"[robust] paging: paged_out {st['paged_out']}, paged_in "
        f"{st['paged_in']}, A's blob {blob_bytes} bytes; page-out "
        + ", ".join(f"{t:.4f} s" for t in outs) + "; page-in "
        + ", ".join(f"{t:.4f} s" for t in ins) + "; memory_allocated "
        "before/after each page-out "
        + ", ".join(f"{m0}/{m1} B" for m0, m1 in mems)
        + f"; A's step {again.plan_cache} at warm fraction "
        f"{again.warm_fraction}")
    check(st["paged_out"] >= 1 and st["paged_in"] == 1,
          f"paging counters {st['paged_out']}/{st['paged_in']}")
    check(again.plan_cache == "hit" and again.warm_fraction == 1.0,
          f"paged-in step: {again.plan_cache} at {again.warm_fraction}")
    kernel_mod.LAUNCHES.update(saved[0])
    kernel_mod.CUDA_LAUNCHES.update(saved[1])


# --------------------------------------------------------------------------
# the steady state under the runtime sanitizers, and the quickstart twin
# --------------------------------------------------------------------------

def _churned(inst, seed: int, next_id: int):
    """``inst`` with :data:`CHURN` of its jobs replaced by fresh ones under
    new ids from ``next_id`` on (a warm repair)."""
    from repro_torch.domains import GavelInstance
    from repro_torch.problems.cluster_scheduling import make_cluster_workload
    n = len(inst.job_ids)
    n_out = max(1, int(round(CHURN * n)))
    fresh = make_cluster_workload(n_out, num_workers=NUM_WORKERS, seed=seed)
    keep = np.arange(n_out, n)

    def cat(a, b):
        return np.concatenate([np.asarray(a)[keep], b])
    wl = dataclasses.replace(
        inst.wl, T=cat(inst.wl.T, fresh.T), w=cat(inst.wl.w, fresh.w),
        z=cat(inst.wl.z, fresh.z),
        interference=cat(inst.wl.interference, fresh.interference),
        job_type=cat(inst.wl.job_type, fresh.job_type))
    ids = np.concatenate([np.asarray(inst.job_ids)[keep],
                          next_id + np.arange(n_out)])
    return GavelInstance(wl, job_ids=ids)


def _check_steady(tag, stats, verdict, want_verdict, lane_max, calls=1):
    """The guarded step's own checks: no build, no denied sync, the
    debug mode armed, the chunk checks one a chunk plus the loop's exit
    test, ten result fields read back a launch."""
    check(verdict == want_verdict, f"{tag}: verdict {verdict}, not "
          f"{want_verdict}")
    check(stats.builds == 0, f"{tag}: builds {stats.built_names}")
    check(stats.syncs_denied == 0, f"{tag}: denied {stats.denied_sites}")
    check(stats.modes == {"cuda"}, f"{tag}: tripwire modes {stats.modes}")
    check(stats.hot_backend_calls == calls,
          f"{tag}: {stats.hot_backend_calls} map-backend calls")
    check(stats.chunk_checks == lane_max // STEADY_CHECK_EVERY + 1,
          f"{tag}: {stats.chunk_checks} chunk checks for lane-max "
          f"{lane_max} iterations")
    check(stats.readbacks == 10 * calls, f"{tag}: {stats.readbacks} "
          "readbacks")


def _runtime_syncs(prof) -> dict:
    """The CUDA runtime's synchronizing calls a profiler session recorded
    (a PyTorch device-to-host copy is a ``cudaMemcpyAsync`` and the
    ``cudaStreamSynchronize`` that waits for it, counted once, at the
    synchronize; a plain ``cudaMemcpy*`` blocks by itself), with the async
    copies and kernel launches beside them."""
    out = {"syncs": 0, "memcpy_async": 0, "launches": 0, "by_name": {}}
    for e in prof.key_averages():
        name, n = e.key, e.count
        if not name.startswith("cu"):
            continue
        out["by_name"][name] = n
        if name in SYNC_CALLS or (name.startswith("cudaMemcpy")
                                  and "Async" not in name):
            out["syncs"] += n
        elif name.startswith("cudaMemcpy"):
            out["memcpy_async"] += n
        elif "Launch" in name:
            out["launches"] += n
    return out


def phase_steady(device, insts):
    """The main path's steady state under ``repro_torch.analysis.runtime``:
    the tripwire's own check on the card (a ``.item()`` on the armed
    thread raises, twice), then a fresh 16,384-job session warmed through
    its three step types (miss, hit, repair) and four warm steps (three
    hits and a churn repair), each under ``steady_state_guard(
    max_retraces=0)``: no build, no denied sync, the allowed syncs split
    into chunk checks (the lane-max iterations over 40, plus the loop's
    exit test) and readbacks, and the session's peak device memory.  Then
    four tenants of the same size in one held round of the dispatcher
    (rows 1-2 in one 32-lane launch), guarded the same way.  Returns the
    session and its next warm instance, for ``steady-profile``."""
    from repro_torch import testing
    from repro_torch.analysis.runtime import (HostSyncError,
                                              host_sync_tripwire,
                                              steady_state_guard)
    from repro_torch.kernels import structured_pdhg_step as kernel_mod
    from repro_torch.service import DispatchConfig, PopService
    saved = (dict(kernel_mod.LAUNCHES), dict(kernel_mod.CUDA_LAUNCHES))

    # a sanitizer that cannot fire proves nothing
    one = torch.ones(4, device=device)
    raised = 0
    with host_sync_tripwire() as st:
        check(torch.cuda.get_sync_debug_mode() == 1,
              "the tripwire did not arm the sync debug mode")
        for _ in range(2):
            try:
                one.sum().item()
            except HostSyncError:
                raised += 1
    check(raised == 2 and st.syncs_denied == 2 and st.modes == {"cuda"},
          f"the tripwire denied {raised} of 2 .item() calls ({st})")
    check(torch.cuda.get_sync_debug_mode() == 0,
          "the sync debug mode was not restored")
    log("[steady] tripwire self-check: two .item() on the armed thread "
        "denied under set_sync_debug_mode('warn'); mode restored")

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    service = PopService(device=device)
    sess = service.session("steady", insts[0])
    for inst, want in zip(insts, ("miss", "hit", "repair")):
        a = sess.step(inst)
        check(a.plan_cache == want, f"warm-up: {a.plan_cache}, not {want}")
    churned = _churned(insts[2], STEADY_CHURN_SEED, 2 * N_JOBS)
    steps = [("hit", _drifted(insts[2], STEADY_CHURN_SEED + 1)),
             ("hit", _drifted(insts[2], STEADY_CHURN_SEED + 2)),
             ("repair", churned),
             ("hit", _drifted(churned, STEADY_CHURN_SEED + 3))]
    for i, (want, inst) in enumerate(steps):
        zero_launches(kernel_mod)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with steady_state_guard(max_retraces=0) as st:
            a = sess.step(inst)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        its = np.asarray(a.raw.iterations)
        lane_max = int(its.max())
        row = dict(step=i + 1, verdict=a.plan_cache, builds=st.builds,
                   syncs_denied=st.syncs_denied,
                   syncs_allowed=st.syncs_allowed,
                   chunk_checks=st.chunk_checks, readbacks=st.readbacks,
                   lane_max_iterations=lane_max,
                   lane_max_over_40=lane_max / STEADY_CHECK_EVERY,
                   converged=f"{int(np.asarray(a.raw.converged).sum())}"
                             f"/{its.size}",
                   launches=dict(kernel_mod.LAUNCHES), wall_s=wall,
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   before_session_gb=base / 1e9)
        log("[steady] " + json.dumps(row))
        _check_steady(f"step {i + 1}", st, a.plan_cache, want, lane_max)
        check(np.asarray(a.raw.converged).all(), f"step {i + 1}: a lane "
              "did not converge")
        for name, n in kernel_mod.LAUNCHES.items():
            check(n > 0, f"step {i + 1}: {name} was not launched")

    session_peak = torch.cuda.max_memory_allocated()
    log(f"[steady] session peak device memory {session_peak / 1e9:.3f} GB "
        f"(max_memory_allocated since the session began; "
        f"{base / 1e9:.3f} GB allocated before it)")

    # the dispatcher: four tenants coalesced into one 32-lane launch
    tenants = {f"A{s}": testing.session_instances(N_JOBS, NUM_WORKERS, CHURN,
                                                  seed=s)[:2]
               for s in range(4)}
    disp_service = PopService(device=device, dispatch=DispatchConfig(
        max_lanes=ASYNC_LANES, max_wait_ms=ASYNC_WAIT_MS))
    try:
        sessions = {n: disp_service.session(n, pair[0])
                    for n, pair in tenants.items()}
        for rnd in range(2):
            allocs, _, _ = held_round(disp_service, sessions,
                                      {n: p[rnd] for n, p in tenants.items()})
            check(all(a.plan_cache == ("miss", "hit")[rnd]
                      for a in allocs.values()),
                  f"dispatcher warm-up round {rnd}: "
                  f"{[a.plan_cache for a in allocs.values()]}")
        disp = disp_service.dispatcher
        zero_launches(kernel_mod)
        before = disp.stats()
        with steady_state_guard(max_retraces=0) as st:
            allocs, wall, _ = held_round(
                disp_service, sessions,
                {n: _drifted(p[1], STEADY_CHURN_SEED + 10 + i)
                 for i, (n, p) in enumerate(tenants.items())})
        d = {k: v - before[k] for k, v in disp.stats().items()
             if k in ("launches", "coalesced_requests", "lanes",
                      "group_fallbacks")}
        lane_max = max(_lane_max(a) for a in allocs.values())
        conv = np.concatenate([np.asarray(a.raw.converged)
                               for a in allocs.values()])
        row = dict(round="coalesced", tenants=len(allocs),
                   verdicts=[a.plan_cache for a in allocs.values()],
                   converged=f"{int(conv.sum())}/{conv.size}",
                   builds=st.builds, syncs_denied=st.syncs_denied,
                   syncs_allowed=st.syncs_allowed,
                   chunk_checks=st.chunk_checks, readbacks=st.readbacks,
                   lane_max_iterations=lane_max,
                   lane_max_over_40=lane_max / STEADY_CHECK_EVERY,
                   dispatcher=d, launches=dict(kernel_mod.LAUNCHES),
                   per_half_step=per_half_step(kernel_mod), wall_s=wall)
        log("[steady] " + json.dumps(row))
        _check_steady("coalesced round", st, "hit", "hit", lane_max)
        check(all(a.plan_cache == "hit" and a.status == "ok"
                  for a in allocs.values()), "coalesced round: not all hits")
        check((d["launches"], d["coalesced_requests"], d["lanes"],
               d["group_fallbacks"]) == (1, 4, ASYNC_LANES, 0),
              f"coalesced round: dispatcher {d}")
        for name, n in kernel_mod.LAUNCHES.items():
            check(n > 0, f"coalesced round: {name} was not launched")
            check(per_half_step(kernel_mod)[name] == 1,
                  f"coalesced round: {name} CUDA launches a call")
    finally:
        disp_service.close()
    kernel_mod.LAUNCHES.update(saved[0])
    kernel_mod.CUDA_LAUNCHES.update(saved[1])
    return sess, _drifted(churned, STEADY_CHURN_SEED + 4)


def phase_steady_profile(sess, inst):
    """One more warm step of ``steady``'s session (run with the profiled
    phases: a profiler session slows the host calls of later phases), a
    profiler session around its map step: the CUDA runtime's
    synchronizing calls it records, less those of a session around an
    empty call, equal the tripwire's allowed count."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.analysis.runtime import steady_state_guard
    from repro_torch.core import backends as backends_mod
    # the profiler's count of synchronizing runtime calls in the map step:
    # a profiler session around each map-backend call (outside the
    # tripwire, whose block it encloses), less what a session around an
    # empty call records (the profiler's own synchronize at its end)
    activities = [ProfilerActivity.CUDA]
    with profile(activities=activities) as empty:
        pass
    own = _runtime_syncs(empty)
    traces = []

    def profiled_call(fn):
        @functools.wraps(fn)
        def run(*args, **kw):
            with profile(activities=activities) as prof:
                out = fn(*args, **kw)
            traces.append(prof)
            return out
        return run

    torch.cuda.synchronize()
    with steady_state_guard(max_retraces=0) as st:
        for name, fn in list(backends_mod.MAP_BACKENDS.items()):
            backends_mod.MAP_BACKENDS[name] = profiled_call(fn)
        a = sess.step(inst)
        torch.cuda.synchronize()
    lane_max = _lane_max(a)
    check(len(traces) == 1, f"{len(traces)} profiled map-backend calls")
    got = _runtime_syncs(traces[0])
    in_step = got["syncs"] - own["syncs"]
    log(f"[steady] profiled warm step ({a.plan_cache}, lane-max "
        f"{lane_max} iterations): CUDA runtime synchronizing calls in the "
        f"map step {in_step} ({got['syncs']} recorded less the profiler's "
        f"own {own['syncs']}: {own['by_name']}) against the tripwire's "
        f"allowed {st.syncs_allowed} ({st.chunk_checks} chunk checks + "
        f"{st.readbacks} readbacks); cudaMemcpyAsync {got['memcpy_async']}, "
        f"kernel launches {got['launches']}; by name {got['by_name']}")
    _check_steady("profiled step", st, a.plan_cache, "hit", lane_max)
    check(got["launches"] > 0, "the profiler recorded no CUDA runtime "
          "calls in the map step")
    check(in_step == st.syncs_allowed,
          f"the profiler counted {in_step} synchronizing calls, the "
          f"tripwire {st.syncs_allowed}")


def phase_quickstart(device):
    """``examples_torch/quickstart.py`` at its default size (120 nodes,
    4,000 demands, 8,000 iterations) in a child process on the card, the
    lane and full kernels' launch counts read in the child after it: every
    printed line checked, the full LP on ``fused_structured_full`` (rows
    3-4 launched), the POP sessions on ``fused_structured`` (rows 1-2),
    flows finite and positive, the warm re-tick a hit, the skewed split
    below POP-16's flow; the full LP's peak device memory printed."""
    code = (
        "import json, runpy, sys\n"
        "from repro_torch.kernels import structured_full_pdhg_step as f, "
        "structured_pdhg_step as l\n"
        f"sys.argv = [{str(QUICKSTART)!r}]\n"
        f"runpy.run_path({str(QUICKSTART)!r}, run_name='__main__')\n"
        "print('launches ' + json.dumps({**l.LAUNCHES, **f.LAUNCHES}))\n")
    out, wall = _child(["-c", code], "quickstart")
    flows, peak_gb, launches = check_quickstart(out)
    log(f"[quickstart] wall {wall:.2f} s (process start included); full LP "
        f"peak device memory {peak_gb:.3f} GB (max_memory_allocated); "
        f"flows {flows}; kernel calls {launches}")
    for name, n in launches.items():
        check(n > 0, f"quickstart: {name} was not launched")
    return peak_gb


def check_quickstart(out: str):
    """Every line the quickstart prints, checked: ``(flows, the full LP's
    peak GB, the kernels' calls)``."""
    lines = {}
    for ln in out.splitlines():
        head = ln.split(":", 1)[0].strip()
        lines[head] = ln
    for head in ("full LP", "POP-4", "POP-16", "warm re-tick", "CSPF",
                 "POP-16 skew", "MoE place"):
        check(head in lines, f"quickstart printed no '{head}' line")

    def flow(head):
        v = float(lines[head].split("flow=")[1].split()[0])
        check(np.isfinite(v) and v > 0, f"{head}: flow {v}")
        return v
    full = lines["full LP"]
    check("engine=fused_structured_full" in full,
          f"the full LP did not run fused_structured_full: {full}")
    for head in ("POP-4", "POP-16"):
        check("engine=fused_structured)" in lines[head], lines[head])
    flows = {h: flow(h) for h in ("full LP", "POP-4", "POP-16",
                                  "warm re-tick", "CSPF", "POP-16 skew")}
    check("plan_cache=hit" in lines["warm re-tick"], lines["warm re-tick"])
    check(flows["POP-16 skew"] < flows["POP-16"],
          "the skewed split did not lose flow against POP-16")
    check("served=" in lines["MoE place"], lines["MoE place"])
    check("peak=" in full, f"the full LP line gives no peak memory: {full}")
    peak_gb = float(full.split("peak=")[1].split("GB")[0])
    launches = json.loads(out.split("launches ", 1)[1].splitlines()[0])
    return flows, peak_gb, launches


def _drifted(inst, seed):
    """``inst`` with every throughput scaled by U(0.97, 1.03): a warm hit."""
    from repro_torch.domains import GavelInstance
    rng = np.random.default_rng(seed)
    wl = dataclasses.replace(inst.wl, T=inst.wl.T * rng.uniform(
        0.97, 1.03, inst.wl.T.shape))
    return GavelInstance(wl, job_ids=inst.job_ids)


def async_tenants():
    """{tenant: (session kwargs, {round: instance})}: the four 16,384-job
    tenants step cold ("C"), drifted ("D"), three of them churned ("P",
    24 lanes), then "X" mixes tenant 3's churn and a fifth tenant's cold
    step (one 16-lane launch) with the 8,192-job tenant and the k=1
    tenant."""
    from repro_torch import testing
    from repro_torch.core.config import ExecConfig, SolveConfig
    from repro_torch.domains import GavelInstance, get
    from repro_torch.problems.cluster_scheduling import make_cluster_workload
    gavel = get("gavel")
    out = {}
    for s in ASYNC_SEEDS:
        cold, drift, churn = testing.session_instances(N_JOBS, NUM_WORKERS,
                                                       CHURN, seed=s)
        rounds = {"C": cold, "D": drift}
        if s < 3:
            rounds["P"] = churn
        else:
            rounds["X"] = churn
        out[f"A{s}"] = ({}, rounds)
    fifth = len(ASYNC_SEEDS)
    out[f"A{fifth}"] = ({}, {"X": testing.session_instances(
        N_JOBS, NUM_WORKERS, CHURN, seed=fifth)[0]})
    other = testing.session_instances(ASYNC_OTHER_JOBS, NUM_WORKERS, CHURN,
                                      seed=fifth + 1)[0]
    out["B"] = ({}, {"X": other})
    full = GavelInstance(make_cluster_workload(
        ASYNC_FULL_JOBS, num_workers=ASYNC_FULL_WORKERS, seed=fifth + 2))
    out["S"] = (dict(solve=SolveConfig(k=1), exec=ExecConfig(
        engine="fused_structured_full",
        solver_kw=gavel.default_exec.solver_dict())), {"X": full})
    return out


def _sessions(service, tenants):
    return {name: service.session(name, next(iter(rounds.values())), **kw)
            for name, (kw, rounds) in tenants.items()}


def _wait_requests(disp, before: int, n: int, timeout: float = 120.0):
    """Seconds until ``n`` requests past ``before`` reached the dispatcher
    (each ticket is queued a few statements after it is counted)."""
    t0 = time.perf_counter()
    while disp.stats()["requests"] - before < n:
        check(time.perf_counter() - t0 < timeout,
              "requests did not reach the dispatcher")
        time.sleep(0.001)
    time.sleep(0.002)
    return time.perf_counter() - t0


def held_round(service, sessions, insts):
    """Submit ``{tenant: instance}`` through ``step_async`` under
    ``hold()``, release once every request reached the dispatcher, and
    wait: ({tenant: Allocation}, round wall, seconds until the last request
    reached the dispatcher)."""
    disp = service.dispatcher
    before = disp.stats()["requests"]
    t0 = time.perf_counter()
    with disp.hold():
        futs = {name: sessions[name].step_async(inst)
                for name, inst in insts.items()}
        prep_s = _wait_requests(disp, before, len(futs))
    allocs = {name: f.result(timeout=600) for name, f in futs.items()}
    return allocs, time.perf_counter() - t0, prep_s


def _lane_its(a):
    return np.atleast_1d(np.asarray(a.raw.iterations if a.k > 1
                                    else a.raw.res.iterations))


def _against(tag, name, got, want):
    """A tenant's step against its synchronous step: equal per-lane
    iterations and mean_norm_throughput within ASYNC_MEAN_TOL (checked),
    the largest allocation difference and bit equality (printed)."""
    its_a, its_b = _lane_its(got), _lane_its(want)
    d_mean = abs(got.metrics["mean_norm_throughput"]
                 - want.metrics["mean_norm_throughput"])
    d_alloc = float(np.max(np.abs(got.alloc - want.alloc)))
    bits = bool(np.array_equal(got.alloc, want.alloc))
    log(f"[async] {tag} {name}: {got.plan_cache}, iterations "
        f"{its_a.tolist()} (sync {its_b.tolist()}), |d mean_norm_throughput|"
        f" {d_mean:.3g}, max |d alloc| {d_alloc:.3g}, bit-identical {bits}; "
        f"build_s {got.build_time_s:.4f} (sync {want.build_time_s:.4f}), "
        f"solve_s {got.solve_time_s:.4f} (sync {want.solve_time_s:.4f})")
    check(got.status == "ok" and got.plan_cache == want.plan_cache,
          f"{tag} {name}: {got.status} {got.plan_cache}")
    check(np.array_equal(its_a, its_b),
          f"{tag} {name}: iterations {its_a.tolist()} against the "
          f"synchronous step's {its_b.tolist()}")
    check(d_mean < ASYNC_MEAN_TOL,
          f"{tag} {name}: mean_norm_throughput differs by {d_mean:.3g}")
    return bits


def _fair(tag, name, a, inst, gandiva):
    """Every lane converged and the minimum above twice Gandiva's."""
    conv = np.atleast_1d(np.asarray(a.raw.converged if a.k > 1
                                    else a.raw.res.converged))
    base = gandiva.setdefault(id(inst),
                              _gandiva(inst)["min_norm_throughput"])
    check(conv.all(), f"{tag} {name}: {int((~conv).sum())} lane(s) did "
          "not converge")
    check(np.isfinite(a.alloc).all(), f"{tag} {name}: allocation not finite")
    check(a.metrics["min_norm_throughput"] > 2.0 * base,
          f"{tag} {name}: min_norm_throughput "
          f"{a.metrics['min_norm_throughput']:.5f} not above twice "
          f"Gandiva's {base:.5f}")


def _gandiva(inst) -> dict:
    """Gandiva's allocation of ``inst``, evaluated."""
    from repro_torch.problems.cluster_scheduling import (GavelProblem,
                                                         gandiva_heuristic)
    return GavelProblem(inst.wl).evaluate(gandiva_heuristic(
        inst.wl, space_sharing=False))


def _ms_per_iteration(allocs) -> float:
    """A round's launch wall (the tenants' shares summed) over its lane
    maximum of iterations, in ms."""
    wall = sum(a.solve_time_s for a in allocs.values())
    return wall * 1e3 / max(int(max(_lane_its(a).max()
                                    for a in allocs.values())), 1)


def hold_at_shape(tag, op, kernels, plain, calls_of, device,
                  prefix="async"):
    """The kernels of ``kernels`` on one operator a path launched,
    against their plain versions on the same inputs: each half-step once
    (tails exact, products within PRODUCT_RTOL) and a conformance-budget
    solve through each engine (x and y within ASYNC_KERNEL_TOL, equal
    iterations).  The caller puts the launch counts back."""
    from repro_torch import testing
    from repro_torch.core import pdhg
    s = kernels.prep(op).data
    errs = compare_case(calls_of(s, testing.step_tensors(s, device)))
    got = pdhg.solve_stacked(op, engine=kernels, **CONFORMANCE_KW)
    want = pdhg.solve_stacked(op, engine=plain, **CONFORMANCE_KW)
    dx = float(np.abs(got.x - want.x).max())
    dy = float(np.abs(got.y - want.y).max())
    log(f"[{prefix}] kernels at {tag} ({op.c.shape[0]} lanes, N="
        f"{op.c.shape[-1]}, M={op.q.shape[-1]}, narrow rows "
        f"{tuple(s.row_idx.shape[1:])}, wide rows "
        f"{tuple(s.wrow_idx.shape[1:])}): per call max abs err "
        + ", ".join(f"{n} {e:.3g}" for n, e in errs.items())
        + f" (tails exact, products rtol=atol={PRODUCT_RTOL}); "
        f"{kernels.name} against its plain versions at the conformance "
        f"budget: max |dx| {dx:.3g}, max |dy| {dy:.3g} "
        f"(rtol=atol={ASYNC_KERNEL_TOL})")
    for name, a, b in (("x", got.x, want.x), ("y", got.y, want.y)):
        check(np.allclose(a, b, rtol=ASYNC_KERNEL_TOL, atol=ASYNC_KERNEL_TOL),
              f"{tag}: {name} of the kernels differs from the plain run's")
    check(np.array_equal(got.iterations, want.iterations),
          f"{tag}: iterations differ from the plain run's")


def phase_async(device):
    """Async serving: four 16,384-job Gavel tenants through
    ``step_async`` on a ``PopService`` with a dispatcher, each held round
    one 32-lane launch of the lane kernels, against the same steps run one
    after another without a dispatcher and through ``step_async`` without
    one; a 24-lane round padded to 32, a mixed round (two tenants sharing
    16 lanes, an 8,192-job tenant on its own key, a k=1 tenant inline on
    its own thread with the full kernels), the kernels held against their
    plain versions on the operators these rounds launched, and a profiled
    round.  The kernels' launch counts are put back as they were
    afterwards."""
    import threading
    from repro_torch.core import backends as backends_mod
    from repro_torch.core import pdhg
    from repro_torch.core import pop as pop_mod
    from repro_torch.core.config import ExecConfig
    from repro_torch.domains import get
    from repro_torch.kernels import structured_full_pdhg_step as full_mod
    from repro_torch.kernels import structured_pdhg_step as kernel_mod
    from repro_torch.service import DispatchConfig, PopService
    saved = [(m, dict(m.LAUNCHES), dict(m.CUDA_LAUNCHES))
             for m in (kernel_mod, full_mod)]
    threads_before = threading.active_count()
    t0 = time.perf_counter()
    tenants = async_tenants()
    log(f"[async] tenants: {len(tenants)} ({', '.join(tenants)}), "
        f"instances drawn in {time.perf_counter() - t0:.2f} s")
    order = ("C", "D", "P", "X")
    gandiva: dict = {}

    # 1. control: every step one after another, no dispatcher
    sync = PopService(device=device)
    ssess = _sessions(sync, tenants)
    want, walls = {}, {}
    for rnd in order:
        for name, (_, rounds) in tenants.items():
            if rnd in rounds:
                t1 = time.perf_counter()
                want[rnd, name] = ssess[name].step(rounds[rnd])
                walls[rnd, name] = time.perf_counter() - t1
    for rnd in order:
        row = {n: (round(walls[rnd, n], 4),
                   int(_lane_its(want[rnd, n]).max()))
               for n in tenants if (rnd, n) in want}
        log(f"[async] sync {rnd}: (wall s, lane-max iterations) {row}")

    t_sync = time.perf_counter()

    # 2. coalesced: held rounds through the dispatcher
    service = PopService(device=device, dispatch=DispatchConfig(
        max_lanes=ASYNC_LANES, max_wait_ms=ASYNC_WAIT_MS))
    csess = _sessions(service, tenants)
    disp = service.dispatcher
    padded, stacks, full_preps = [], [], []

    def on_pad(out):
        padded.append(backends_mod.batch_size(out[0]))
        stacks.append(out[0][0])

    packs = []
    inner_pack = kernel_mod.side_pack

    def timed_pack(name, side, v_len):
        t1 = time.perf_counter()
        had = kernel_mod._packs.get(id(side[0]))
        p = inner_pack(name, side, v_len)
        if p is not had:
            packs.append((name, p.k, time.perf_counter() - t1))
        return p

    got, rounds_log, launched = {}, {}, {}
    with _observing(backends_mod, "pad_lanes_pow2", on_pad), \
            _observing(pop_mod, "prepare_full", full_preps.append):
        try:
            for rnd in order:
                insts = {n: r[rnd] for n, (_, r) in tenants.items()
                         if rnd in r}
                kernel_mod.side_pack = timed_pack if rnd in ("P", "X") \
                    else inner_pack
                for mod, _, _ in saved:
                    zero_launches(mod)
                del padded[:], stacks[:]
                before = disp.stats()
                allocs, wall, prep_s = held_round(service, csess, insts)
                d = {k: v - before[k] for k, v in disp.stats().items()
                     if k in before and k not in (
                         "batching_ratio", "lanes_per_launch", "max_group")}
                lanes = dict(kernel_mod.LAUNCHES)
                per_call = per_half_step(kernel_mod)
                full_counts = dict(full_mod.LAUNCHES)
                full_per = per_half_step(full_mod)
                rounds_log[rnd] = (wall, prep_s, allocs)
                launched[rnd] = stacks[0]
                # the mixed round's launches overlap: no one launch wall there
                launch_s = sum(a.solve_time_s for a in allocs.values())
                launch = ("" if rnd == "X" else
                          f", launch {launch_s:.4f} s, "
                          f"{_ms_per_iteration(allocs):.4f} ms per iteration")
                log(f"[async] round {rnd}: {len(insts)} tenants, wall "
                    f"{wall:.4f} s (the last request reached the dispatcher "
                    f"at {prep_s:.4f} s){launch}; "
                    f"dispatcher {d}; padded stacks {padded}; lane kernels "
                    f"{lanes} ({per_call} CUDA launches a call); full kernels "
                    f"{full_counts} ({full_per})")
                for name, a in allocs.items():
                    got[rnd, name] = a
                    _against(rnd, name, a, want[rnd, name])
                    if name.startswith("A"):
                        _fair(rnd, name, a, insts[name], gandiva)
                check(d["group_fallbacks"] == 0,
                      f"round {rnd}: {d['group_fallbacks']} group fallback(s)")
                for n, c in lanes.items():
                    check(c > 0, f"round {rnd}: {n} was not launched")
                    check(per_call[n] == 1, f"round {rnd}: {n} made "
                          f"{per_call[n]} CUDA launches a call")
                if rnd in ("C", "D"):
                    check((d["launches"], d["coalesced_requests"], d["lanes"],
                           padded) == (1, 4, ASYNC_LANES, [ASYNC_LANES]),
                          f"round {rnd}: {d}, padded {padded}")
                elif rnd == "P":
                    check((d["launches"], d["coalesced_requests"], d["lanes"],
                           padded) == (1, 3, 24, [ASYNC_LANES]),
                          f"round P: {d}, padded {padded}")
                else:
                    # one coalesced launch of two tenants and one solo launch
                    # on the worker, and the k=1 tenant's inline launch
                    check((d["requests"], d["launches"],
                           d["coalesced_launches"], d["coalesced_requests"],
                           d["solo_launches"],
                           padded) == (4, 3, 1, 2, 2, [16]),
                          f"round X: {d}, padded {padded}")
                    for n, c in full_counts.items():
                        check(c > 0 and full_per[n] == 1,
                              f"round X: {n} {c} calls, {full_per[n]} CUDA "
                              "launches a call")
        finally:
            kernel_mod.side_pack = inner_pack
    t_coalesced = time.perf_counter()
    for name, k, s in packs:
        log(f"[async] side_pack of a new {k}-lane operator ({name}): "
            f"{s * 1e3:.3f} ms")

    # the kernels at the shapes this path gave them, against their plain
    # versions: round C's concatenated 32 lanes (ELL widths and bucket
    # counts padded to the group maximum), round P's 24 lanes with 8
    # replicas, round X's 16 lanes, and the k=1 tenant's full operator
    lanes_eng = pdhg.fused_structured_engine()
    for rnd in ("C", "P", "X"):
        hold_at_shape(f"round {rnd}'s launch", launched[rnd], lanes_eng,
                      pdhg.fused_structured_engine("ref"), lane_calls,
                      device)
    check(len(full_preps) == 1, f"round X: {len(full_preps)} full builds")
    full = full_preps[0]
    hold_at_shape("round X's k=1 tenant", full.ops, full.engine,
                  pdhg.fused_structured_full_engine(
                      "ref", *pdhg._wide_block_plans(full.ops.structured)),
                  full_calls, device)
    launched.clear()
    t_held = time.perf_counter()

    # 3. step_async without a dispatcher: four threads, four launches of
    # round D, each tenant seeded with its synchronous cold step's result
    four = [f"A{s}" for s in ASYNC_SEEDS]
    plain = PopService(device=device)
    psess = {n: plain.session(n, tenants[n][1]["C"]).seed(want["C", n].raw)
             for n in four}
    t1 = time.perf_counter()
    futs = {n: psess[n].step_async(tenants[n][1]["D"]) for n in four}
    allocs = {n: f.result(timeout=600) for n, f in futs.items()}
    plain_wall = time.perf_counter() - t1
    for name, a in allocs.items():
        _against("plain D", name, a, want["D", name])
    plain.close()

    t_plain = time.perf_counter()

    # 4. one coalesced round under the profiler (last: a finished profiler
    # session slows later host calls): the four cold instances on fresh
    # sessions at a fixed budget
    capped = ExecConfig(solver_kw=dict(
        get("gavel").default_exec.solver_dict(),
        max_iters=ASYNC_PROFILE_ITERS))
    insts = {f"{n}-profiled": tenants[n][1]["C"] for n in four}
    fresh = {name: service.session(name, inst, exec=capped)
             for name, inst in insts.items()}
    before = disp.stats()
    profiled("async-profile", lambda: held_round(service, fresh, insts),
             lambda out: max(_lane_its(a).max() for a in out[0].values()))
    d = {k: disp.stats()[k] - before[k] for k in ("launches", "lanes")}
    check(d == {"launches": 1, "lanes": ASYNC_LANES},
          f"profiled round: {d}")
    t_profile = time.perf_counter()
    service.close()
    sync.close()
    threads_after = threading.active_count()

    members = {r: [n for n in tenants if (r, n) in want] for r in order}
    sps = {("sync", r): len(members[r]) / sum(walls[r, n]
                                              for n in members[r])
           for r in order}
    sps.update({("coalesced", r): len(members[r]) / rounds_log[r][0]
                for r in order})
    sps["plain", "D"] = len(four) / plain_wall
    sync_ms = np.mean([want["D", n].solve_time_s * 1e3
                       / _lane_its(want["D", n]).max() for n in four])
    log("[async] steps per second: " + ", ".join(
        f"{mode} {r} {v:.3f} ({v / sps['sync', r]:.3f}x sync)"
        for (mode, r), v in sps.items())
        + f"; rounds C and D together: sync "
        f"{8 / sum(walls[r, n] for r in 'CD' for n in four):.3f}, coalesced "
        f"{8 / (rounds_log['C'][0] + rounds_log['D'][0]):.3f}")
    for r, (w, p, _) in rounds_log.items():
        sync_sum = sum(walls[r, n] for n in members[r])
        slowest = max(walls[r, n] for n in members[r])
        log(f"[async] round {r} against the {ASYNC_STEP_LIMIT_S} s step "
            f"limit: coalesced {w:.4f} s (prepare share {p / w:.3f}, "
            f"within {w <= ASYNC_STEP_LIMIT_S}); sync {sync_sum:.4f} s one "
            f"after another, slowest step {slowest:.4f} s (within "
            f"{slowest <= ASYNC_STEP_LIMIT_S}); coalesced "
            f"{sps['coalesced', r]:.3f} steps/s against sync "
            f"{sps['sync', r]:.3f} (at least the sync rate "
            f"{sps['coalesced', r] >= sps['sync', r]})")
    log(f"[async] ms per iteration at 32 lanes "
        f"{_ms_per_iteration(rounds_log['D'][2]):.4f} (round D) against "
        f"{sync_ms:.4f} at 8 (the synchronous drift steps' mean)")
    log(f"[async] phase parts: instances and control {t_sync - t0:.2f} s,"
        f" coalesced rounds {t_coalesced - t_sync:.2f} s, the kernels held "
        f"at their shapes {t_held - t_coalesced:.2f} s, step_async without "
        f"a dispatcher {t_plain - t_held:.2f} s, the profiled round "
        f"{t_profile - t_plain:.2f} s")
    log(f"[async] threads: {threads_before} before the phase, "
        f"{threads_after} after close(); dispatcher {disp.stats()}")
    check(threads_after <= threads_before,
          f"{threads_after - threads_before} thread(s) left running")
    for mod, calls, cuda in saved:
        mod.LAUNCHES.update(calls)
        mod.CUDA_LAUNCHES.update(cuda)


# each wrapper's CUDA kernels: the tail type in their names, the kernels,
# and the one it launches once per call
KERNEL_NAMES = {
    "structured_forward_step": (
        "PrimalTail>", ("primal_lane_kernel",), "primal_lane_kernel"),
    "structured_backward_step": (
        "DualTail>", ("dual_lane_kernel",), "dual_lane_kernel"),
    "structured_full_forward_step": (
        "PrimalTail>", ("full_forward_coop_kernel", "full_tail_kernel"),
        "full_forward_coop_kernel"),
    "structured_full_backward_step": (
        "DualTail>", ("full_backward_coop_kernel",),
        "full_backward_coop_kernel"),
    "fused_forward_step": (
        "PrimalTail>", ("dense_tail_kernel", "dense_rows_kernel"),
        "dense_rows_kernel"),
    "fused_backward_step": (
        "DualTail>", ("dense_cols_kernel", "dense_chunk_sum_kernel"),
        "dense_cols_kernel"),
    "bmatvec": ("matvec_rows_kernel", ("matvec_rows_kernel",),
                "matvec_rows_kernel"),
    "bmatvec_t": ("matvec_cols_kernel", ("matvec_cols_kernel",),
                  "matvec_cols_kernel"),
}


def profiled(tag, run, iterations):
    """Run ``run()`` under the profiler: device time by kernel, the
    device's busy share, and each wrapper's device time per call
    ({name: ms}, empty where nothing was recorded).  ``iterations(result)``
    gives the PDHG iterations the run made."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = sorted(((ev.self_device_time_total, ev.count, ev.key)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA), reverse=True)
    busy_us = sum(r[0] for r in rows)
    n_dev = sum(r[1] for r in rows)
    iters = max(int(iterations(result)), 1)
    if busy_us == 0:
        log(f"[{tag}] the profiler recorded no device time: not measured")
        return {}, result
    log(f"[{tag}] wall {wall_us / 1e3:.2f} ms under the profiler, device "
        f"busy {busy_us / 1e3:.2f} ms ({100 * busy_us / wall_us:.1f}%), "
        f"{n_dev} kernels, {n_dev / iters:.1f} per PDHG iteration ({iters} "
        f"iterations, {busy_us / iters:.2f} us of device time and "
        f"{wall_us / iters:.2f} us of wall time per iteration)")
    for dev_us, count, key in rows[:12]:
        log(f"[{tag}]   {dev_us / 1e3:9.3f} ms {100 * dev_us / busy_us:5.1f}% "
            f"x{count:<7d} {key[:90]}")
    per_call = {}
    for name, (tail, kernels, counted) in KERNEL_NAMES.items():
        mine = [r for r in rows
                if tail in r[2] and any(k in r[2] for k in kernels)]
        calls = sum(r[1] for r in mine if counted in r[2])
        if calls:
            per_call[name] = sum(r[0] for r in mine) / calls / 1e3
            log(f"[{tag}] {name}: {per_call[name]:.4f} ms of device time "
                f"per call ({calls} calls, all {len(kernels)} launches)")
    return per_call, result


def phase_profile(sess, inst):
    """One more warm main-path step under the profiler."""
    per_call, _ = profiled("profile", lambda: sess.step(inst),
                           lambda a: a.raw.iterations.max())
    return per_call


def _flow_line(metrics) -> str:
    return ", ".join(f"{k} {metrics[k]:.6g}" for k in
                     ("total_flow", "max_edge_util", "overflow"))


def phase_full(device, te_arrays):
    """The unpartitioned traffic baseline through ``pop.solve_full_ex``:
    the domain's defaults in f32 and in int8 storage (the same trajectory),
    then a fixed budget against the plain engine on the same card inputs.
    The full kernels' launch counts are set to 0 just before each of the
    three runs and read just after it.  Returns ({dtype: (FullResult,
    metrics)}, {run: launches})."""
    from repro_torch import domains
    from repro_torch.core import pdhg, pop
    from repro_torch.kernels import structured_full_pdhg_step as full_mod
    from repro_torch.problems.traffic_engineering import TrafficProblem
    exec_cfg = domains.get("traffic").default_exec
    runs, paths = {}, {}
    for dt in ("float32", "int8"):
        prob = TrafficProblem(*te_arrays, coef_dtype=dt)
        zero_launches(full_mod)
        t0 = time.perf_counter()
        fr = pop.solve_full_ex(prob, exec_cfg=exec_cfg, device=device)
        wall = time.perf_counter() - t0
        launched = paths[f"te_{dt}"] = dict(full_mod.LAUNCHES)
        per_call = per_half_step(full_mod)
        its = int(fr.res.iterations)
        metrics = prob.evaluate(fr.alloc)
        log(f"[full] TE {TE_DEMANDS} demands, {dt} storage: engine "
            f"{fr.engine}, backend {fr.backend}, {its} iterations, converged "
            f"{bool(fr.res.converged)}, build_s {fr.build_time_s:.4f}, "
            f"solve_s {fr.solve_time_s:.4f} ({fr.solve_time_s * 1e3 / max(its, 1):.4f}"
            f" ms per iteration), wall {wall:.3f} s; {_flow_line(metrics)}; "
            f"launches {launched}")
        log(f"[launches] TE {dt} full solve: calls {launched}, CUDA launches"
            f" {dict(full_mod.CUDA_LAUNCHES)}, per half-step {per_call}")
        check(per_call["structured_full_forward_step"] == full_mod.VARIANT
              and per_call["structured_full_backward_step"] == 1,
              f"full half-steps: {per_call} CUDA launches per call")
        check(fr.engine == "fused_structured_full", f"engine {fr.engine}")
        check(its > 0 and all(n == its for n in launched.values()),
              f"launches {launched} against {its} iterations")
        check(np.isfinite(fr.alloc).all() and not bool(fr.res.diverged),
              "full solve not finite or diverged")
        runs[dt] = (fr, metrics)
    (f32, _), (i8, _) = runs["float32"], runs["int8"]
    check(int(i8.res.iterations) == int(f32.res.iterations),
          "int8 storage took another number of iterations")
    check(np.array_equal(i8.res.x, f32.res.x),
          "int8 storage gave another x than f32 storage")
    log("[full] int8 storage: the same iterations and the same x, bit for "
        "bit, as f32 storage")

    prob = TrafficProblem(*te_arrays)
    op = pdhg.to_device(pdhg.map_arrays(lambda a: a[None], prob.build_full()),
                        device)
    eng = pdhg.resolve_engine("fused_structured_full", op)
    plain = pdhg.fused_structured_full_engine(
        "ref", *pdhg._wide_block_plans(op.structured))
    kw = dict(max_iters=FULL_FIXED_ITERS, tol_primal=0.0, tol_gap=0.0)
    zero_launches(full_mod)
    got = pdhg.solve_stacked(op, engine=eng, **kw)
    launched = paths["fixed_budget"] = dict(full_mod.LAUNCHES)
    its = int(np.asarray(got.iterations).max())
    check(all(n == its for n in launched.values()),
          f"fixed budget: launches {launched} against {its} iterations")
    want = pdhg.solve_stacked(op, engine=plain, **kw)
    dx = float(np.abs(got.x - want.x).max())
    dy = float(np.abs(got.y - want.y).max())
    log(f"[full] fixed budget of {FULL_FIXED_ITERS} iterations, kernels "
        f"against the plain engine on the card: max |dx| {dx:.3g}, max |dy| "
        f"{dy:.3g} (rtol=atol={SOLVE_RTOL}); kernel run's launches "
        f"{launched}")
    for name, a, b in (("x", got.x, want.x), ("y", got.y, want.y)):
        check(np.allclose(a, b, rtol=SOLVE_RTOL, atol=SOLVE_ATOL),
              f"fixed-budget {name} differs from the plain engine's")

    # the full-LP quality gate: the domain's 8,000 iterations stop short of
    # convergence (so does the reference, which converges at 27,000); the
    # same solve once more with a larger explicit budget
    long_cfg = dataclasses.replace(exec_cfg, solver_kw={
        **dict(exec_cfg.solver_kw), "max_iters": TE_LONG_ITERS})
    fr = pop.solve_full_ex(prob, exec_cfg=long_cfg, device=device)
    its = int(fr.res.iterations)
    metrics = prob.evaluate(fr.alloc)
    log(f"[full] TE {TE_DEMANDS} demands, f32, max_iters {TE_LONG_ITERS}: "
        f"{its} iterations, converged {bool(fr.res.converged)}, solve_s "
        f"{fr.solve_time_s:.4f} ({fr.solve_time_s * 1e3 / max(its, 1):.4f} "
        f"ms per iteration); {_flow_line(metrics)}")
    check(np.isfinite(fr.alloc).all() and not bool(fr.res.diverged),
          "the long full solve is not finite or diverged")
    runs[f"float32_{TE_LONG_ITERS}"] = (fr, metrics)
    return runs, paths


def gavel_full_problem():
    """The Gavel LP of the main path's first fleet, unpartitioned."""
    from repro_torch import testing
    from repro_torch.problems.cluster_scheduling import GavelProblem
    return GavelProblem(testing.session_workloads(N_JOBS, NUM_WORKERS,
                                                  CHURN)[0][0])


def phase_profile_full(device, te_arrays, gavel_prob):
    """Fixed budgets of the full solve under the profiler: traffic
    engineering in f32 and int8 storage (the domain's exec defaults but the
    budget) and the Gavel full LP (the Gavel defaults, equilibrated, but
    the budget).  Returns {shape: {kernel: device ms per call}}."""
    from repro_torch import domains
    from repro_torch.core import pop
    from repro_torch.core.config import ExecConfig
    from repro_torch.problems.traffic_engineering import TrafficProblem
    fixed = dict(max_iters=PROFILE_FULL_ITERS, tol_primal=0.0, tol_gap=0.0)
    gavel_kw = {**dict(domains.get("gavel").default_exec.solver_kw), **fixed}
    cases = {
        "te_float32": (TrafficProblem(*te_arrays), fixed),
        "te_int8": (TrafficProblem(*te_arrays, coef_dtype="int8"), fixed),
        "gavel_full_float32": (gavel_prob, gavel_kw),
    }
    out = {}
    for case, (prob, kw) in cases.items():
        cfg = ExecConfig(solver_kw=kw)
        per_call, fr = profiled(
            f"profile-full {case}",
            lambda: pop.solve_full_ex(prob, exec_cfg=cfg, device=device),
            lambda r: r.res.iterations)
        check(fr.engine == "fused_structured_full", f"engine {fr.engine}")
        log(f"[profile-full {case}] solve_s {fr.solve_time_s:.4f} for "
            f"{int(fr.res.iterations)} iterations (build_s "
            f"{fr.build_time_s:.4f}, not profiled work: the host packs the "
            "ELL)")
        out[case] = per_call
    return out


def phase_traffic(device, te_arrays, full_runs):
    """A POP session on the traffic instance with the domain's defaults:
    cold, then every demand x 1.05; CSPF beside POP and the full LP runs
    (``{label: (FullResult, metrics)}``, the domain's defaults first),
    each converged one held to at least 99% of CSPF's flow."""
    from repro_torch.kernels import structured_pdhg_step as lane_mod
    from repro_torch.problems.traffic_engineering import (TrafficProblem,
                                                          cspf_heuristic)
    from repro_torch.service import PopService
    topo, pairs, demand, paths = te_arrays
    insts = [TrafficProblem(topo, pairs, demand, paths),
             TrafficProblem(topo, pairs, demand * 1.05, paths)]
    sess = PopService(device=device).session("wan", insts[0])
    zero_launches(lane_mod)
    allocs = []
    for inst in insts:
        t0 = time.perf_counter()
        a = sess.step(inst)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        its = np.asarray(a.raw.iterations)
        conv = np.asarray(a.raw.converged)
        log(f"[traffic] step {a.step} ({a.plan_cache}): k={a.k} engine "
            f"{a.engine}, warm fraction {a.warm_fraction}, iterations sum "
            f"{int(its.sum())} / lane max {int(its.max())}, converged "
            f"{int(conv.sum())}/{conv.size}, build_s {a.build_time_s:.4f}, "
            f"solve_s {a.solve_time_s:.4f}, wall {wall:.3f} s; "
            f"{_flow_line(a.metrics)}")
        check(a.engine == "fused_structured", f"engine {a.engine}")
        check(not np.asarray(a.raw.diverged).any(), "a lane diverged")
        check(np.isfinite(a.alloc).all(), "allocation not finite")
        allocs.append(a)
    check([a.plan_cache for a in allocs] == ["miss", "hit"],
          f"verdicts {[a.plan_cache for a in allocs]}")
    launched = dict(lane_mod.LAUNCHES)
    log(f"[launches] TE POP session: calls {launched}, CUDA launches "
        f"{dict(lane_mod.CUDA_LAUNCHES)}, per half-step "
        f"{per_half_step(lane_mod)}")
    check(all(n > 0 for n in launched.values()),
          f"lane kernels not launched: {launched}")
    t0 = time.perf_counter()
    cspf = insts[0].evaluate(cspf_heuristic(insts[0]))
    log(f"[traffic] CSPF ({time.perf_counter() - t0:.2f} s on the host): "
        f"{_flow_line(cspf)}")
    full_metrics = next(iter(full_runs.values()))[1]
    pop_flow = allocs[0].metrics["total_flow"]
    log(f"[traffic] POP-{allocs[0].k} / full total flow "
        f"{pop_flow / full_metrics['total_flow']:.6f}; POP / CSPF "
        f"{pop_flow / cspf['total_flow']:.6f}; lane kernel launches "
        f"{launched}")
    for label, (fr, metrics) in full_runs.items():
        converged = bool(fr.res.converged)
        log(f"[traffic] full LP {label} ({int(fr.res.iterations)} "
            f"iterations, converged {converged}): {_flow_line(metrics)}; "
            f"full / CSPF {metrics['total_flow'] / cspf['total_flow']:.6f}"
            + ("" if converged else "; not converged, so not held to the "
               "99% gate"))
        if converged:
            check(metrics["total_flow"] >= 0.99 * cspf["total_flow"],
                  f"the converged full LP ({label}) carries less than 99% "
                  "of CSPF's flow")
    return allocs


def phase_gavel_full(device, prob, pop_allocs):
    """The unpartitioned Gavel LP of the main path's fleet (Gavel
    defaults: equilibrate, at most 20,000 iterations), the full kernels'
    launch counts set to 0 just before it and read just after.  Returns
    the launches."""
    from repro_torch import domains
    from repro_torch.core import pop
    from repro_torch.kernels import structured_full_pdhg_step as full_mod
    zero_launches(full_mod)
    fr = pop.solve_full_ex(prob, exec_cfg=domains.get("gavel").default_exec,
                           device=device)
    launched = dict(full_mod.LAUNCHES)
    per_call = per_half_step(full_mod)
    log(f"[launches] Gavel full solve: calls {launched}, CUDA launches "
        f"{dict(full_mod.CUDA_LAUNCHES)}, per half-step {per_call}")
    check(per_call["structured_full_forward_step"] == full_mod.VARIANT
          and per_call["structured_full_backward_step"] == 1,
          f"full half-steps: {per_call} CUDA launches per call")
    its = int(fr.res.iterations)
    m = prob.evaluate(fr.alloc)
    p = pop_allocs[0].metrics
    log(f"[gavel-full] {N_JOBS} jobs: engine {fr.engine}, {its} iterations, "
        f"converged {bool(fr.res.converged)}, build_s {fr.build_time_s:.4f}, "
        f"solve_s {fr.solve_time_s:.4f} ({fr.solve_time_s * 1e3 / max(its, 1):.4f}"
        f" ms per iteration); mean_norm_throughput "
        f"{m['mean_norm_throughput']:.6f} (POP-8 {p['mean_norm_throughput']:.6f}),"
        f" min_norm_throughput {m['min_norm_throughput']:.6f} (POP-8 "
        f"{p['min_norm_throughput']:.6f}); launches {launched}")
    check(fr.engine == "fused_structured_full", f"engine {fr.engine}")
    check(its > 0 and all(n == its for n in launched.values()),
          f"launches {launched} against {its} iterations")
    check(fr.alloc.shape == (N_JOBS,) and np.isfinite(fr.alloc).all(),
          "allocation not finite")
    check(not bool(fr.res.diverged), "the full Gavel solve diverged")
    return launched


# --------------------------------------------------------------------------
# load balancing (paper §3.3)
# --------------------------------------------------------------------------

class StepParts:
    """Where a load-balancing solve's time goes, timed by wrapping from
    here, while the context is open, ``LoadBalanceProblem._relax_op`` (the
    numpy relaxation and its upload), ``_round_repair`` (the numpy
    rounding and repair) and the map step ``backends.solve_map`` (the
    PDHG solve, one host sync per 40 iterations); the last map step's
    per-lane iterations and converged flags are kept.  :meth:`take`
    returns the seconds since the last take."""

    PARTS = ("relax_op", "round_repair", "solve_map")

    def __enter__(self):
        from repro_torch.core import backends
        from repro_torch.problems.load_balancing import LoadBalanceProblem
        self.targets = {"relax_op": (LoadBalanceProblem, "_relax_op"),
                        "round_repair": (LoadBalanceProblem, "_round_repair"),
                        "solve_map": (backends, "solve_map")}
        self.orig = {key: getattr(*where)
                     for key, where in self.targets.items()}
        self.seconds = dict.fromkeys(self.PARTS, 0.0)
        self.last = None

        def timed(key, fn):
            def wrapper(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    out = fn(*args, **kwargs)
                finally:
                    self.seconds[key] += time.perf_counter() - t0
                if key == "solve_map":
                    self.last = out
                return out
            return wrapper

        for key, (obj, name) in self.targets.items():
            setattr(obj, name, timed(key, self.orig[key]))
        return self

    def __exit__(self, *exc):
        for key, (obj, name) in self.targets.items():
            setattr(obj, name, self.orig[key])

    def take(self) -> dict:
        out, self.seconds = self.seconds, dict.fromkeys(self.PARTS, 0.0)
        its = np.asarray(self.last.iterations)
        conv = np.asarray(self.last.converged)
        out.update(lane_max_iterations=int(its.max()),
                   converged=f"{int(conv.sum())}/{conv.size}",
                   ms_per_iteration=out["solve_map"] * 1e3
                   / max(int(its.max()), 1))
        return out


def ell_fills(tag, s):
    """Print the stored share of the narrow and wide ELL slots of each side
    of the (stacked) structured operator ``s``."""
    parts = []
    for side, narrow, wide in (("rows", s.row_val, s.wrow_val),
                               ("cols", s.col_val, s.wcol_val)):
        for kind, val in (("narrow", narrow), ("wide", wide)):
            stored = int((val != 0).sum())
            parts.append(f"{kind} {side} {tuple(val.shape)} {stored} of "
                         f"{val.numel()} slots ({100 * stored / val.numel():.1f}%)")
    log(f"[balance-kernels] {tag} fill: " + "; ".join(parts))


def phase_balance_kernels(device):
    """The lane and full kernels held at load-balancing shapes: the stacked
    POP-4 ``structured=True`` operator at 1,024 shards on 64 servers and
    the single-lane full relaxation, each solved at the conformance budget
    with the kernels, with their plain versions on the card and with the
    ``matvec`` engine; x and y within 1e-5, equal iterations, one CUDA
    launch per structured half-step."""
    from repro_torch import testing
    from repro_torch.core import pdhg
    from repro_torch.kernels import structured_full_pdhg_step as full_mod
    from repro_torch.kernels import structured_pdhg_step as lane_mod
    from repro_torch.problems import load_balancing as lb
    prob = lb.LoadBalanceProblem(lb.make_shard_workload(
        BALANCE_SHARDS, BALANCE_SERVERS, seed=0))
    stacked = testing.balance_ops(prob, 4, device, structured=True)
    full = testing.balance_ops(prob, 1, device, structured=True)
    ell_fills("POP-4 stack", stacked.structured)
    ell_fills("full", full.structured)
    plans = pdhg._wide_block_plans(full.structured)
    cases = (
        ("POP-4 stack", stacked, lane_mod, pdhg.fused_structured_engine(),
         pdhg.fused_structured_engine("ref")),
        ("full", full, full_mod,
         pdhg.resolve_engine("fused_structured_full", full),
         pdhg.fused_structured_full_engine("ref", *plans)))
    for tag, op, mod, kernels, plain in cases:
        zero_launches(mod)
        got = pdhg.solve_stacked(op, engine=kernels, **CONFORMANCE_KW)
        launched = dict(mod.LAUNCHES)
        per_call = per_half_step(mod)
        runs = {"plain": pdhg.solve_stacked(op, engine=plain,
                                            **CONFORMANCE_KW),
                "matvec": pdhg.solve_stacked(op, engine="matvec",
                                             K_mv=lb._k_mv, KT_mv=lb._kt_mv,
                                             **CONFORMANCE_KW)}
        its = int(np.asarray(got.iterations).max())
        errs = []
        for label, want in runs.items():
            dx = float(np.abs(got.x - want.x).max())
            dy = float(np.abs(got.y - want.y).max())
            errs.append(f"{label} max |dx| {dx:.3g}, max |dy| {dy:.3g}")
            for name, a, b in (("x", got.x, want.x), ("y", got.y, want.y)):
                check(np.allclose(a, b, rtol=BALANCE_TOL, atol=BALANCE_TOL),
                      f"{tag}: {name} of the kernels differs from the "
                      f"{label} run's")
            check(np.array_equal(got.iterations, want.iterations),
                  f"{tag}: iterations differ from the {label} run's")
        log(f"[balance-kernels] {tag}: {kernels.name} at the conformance "
            f"budget ({its} iterations): kernels against " + "; ".join(errs)
            + f" (rtol=atol={BALANCE_TOL})")
        log(f"[launches] balance-kernels {tag}: calls {launched}, CUDA "
            f"launches {dict(mod.CUDA_LAUNCHES)}, per half-step {per_call}")
        check(all(n == its for n in launched.values()),
              f"{tag}: launches {launched} against {its} iterations")
        check(all(per == 1 for per in per_call.values()),
              f"{tag}: {per_call} CUDA launches per half-step, not one")
        # the two half-steps at this shape, per call
        s = kernels.prep(op).data
        o = testing.step_tensors(s, device)
        calls = (lane_calls(s, o) if mod is lane_mod else full_calls(s, o))
        log(f"[balance-kernels] {tag} per call: " + "; ".join(
            f"{name} kernel {event_ms(lambda: fn('kernel')):.4f} ms, plain "
            f"{event_ms(lambda: fn('ref'), reps=50):.4f} ms"
            for name, fn in calls.items()))


def per_iteration(run, iters=LAUNCH_ITERS):
    """(CUDA kernels, device us, wall us) per PDHG iteration of ``run(n)``,
    a fixed budget of n iterations, from the difference of two profiled
    budgets (so the setup before the loop cancels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    totals = []
    for n in iters:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(n)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e6
        evs = [ev for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA]
        totals.append((sum(ev.count for ev in evs),
                       sum(ev.self_device_time_total for ev in evs), wall))
    d = iters[1] - iters[0]
    return tuple((b - a) / d for a, b in zip(*totals))


def fixed_solve(ops, engine, K_mv, KT_mv):
    from repro_torch.core import backends
    return lambda n: backends.solve_map(
        ops, K_mv, KT_mv, dict(max_iters=n, tol_primal=0.0, tol_gap=0.0),
        backend="vmap", engine=engine)


def phase_balance(device):
    """The paper's Fig. 5 comparison (``benchmarks/bench_load_balancing.
    py``): the full relax-and-round, POP-k for k = 2, 4, 8, 16 and E-Store's
    greedy at 1,024 shards on 64 servers, at most 12,000 iterations,
    tolerances 1e-4, held to the reference's own gates
    (``tests/test_problems.py``); then the matvec engine's stacked and
    per-lane forms at POP-16 in turns, and each run's CUDA kernels per
    PDHG iteration."""
    from repro_torch import testing
    from repro_torch.core import pdhg
    from repro_torch.problems import load_balancing as lb
    wl = lb.make_shard_workload(BALANCE_SHARDS, BALANCE_SERVERS, seed=0)
    prob = lb.LoadBalanceProblem(wl)
    rows = {}
    t_runs = time.perf_counter()
    with StepParts() as parts:
        full = prob.solve_full(solver_kw=BALANCE_KW, device=device)
        rows[1] = (full, parts.take())
        for k in BALANCE_KS:
            rows[k] = (prob.pop_solve(k, seed=0, solver_kw=BALANCE_KW,
                                      device=device), parts.take())
    t0 = time.perf_counter()
    greedy = prob.evaluate(lb.estore_greedy(wl))
    greedy_s = time.perf_counter() - t0

    # the matvec engine's two forms at POP-16, a fixed budget in turns
    t_forms = time.perf_counter()
    ops16 = testing.balance_ops(prob, 16, device)
    forms = {"stacked": pdhg.matvec_engine(lb._k_mv, lb._kt_mv),
             "per-lane": pdhg._engine_from_matvecs(
                 "matvec", pdhg._lanewise(lb._k_mv),
                 pdhg._lanewise(lb._kt_mv))}
    wall = {}
    for name in list(forms) + list(forms)[::-1]:
        run = fixed_solve(ops16, forms[name], lb._k_mv, lb._kt_mv)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run(FORM_ITERS)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / FORM_ITERS
        wall[name] = min(wall.get(name, ms), ms)
        check(np.isfinite(res.x).all(), f"POP-16 {name} form: not finite")
    log(f"[balance] POP-16 matvec engine, {FORM_ITERS} iterations in turns: "
        + ", ".join(f"{n} form {ms:.4f} ms per iteration"
                    for n, ms in wall.items()))

    # kernels per PDHG iteration (profiled last: a profiler session slows
    # later host calls)
    t_counts = time.perf_counter()
    counts = {}
    for k in (1,) + BALANCE_KS:
        ops = ops16 if k == 16 else testing.balance_ops(prob, k, device)
        counts[k] = per_iteration(fixed_solve(ops, "matvec", lb._k_mv,
                                              lb._kt_mv))
    lanewise = per_iteration(fixed_solve(ops16, forms["per-lane"],
                                         lb._k_mv, lb._kt_mv))
    log(f"[balance] POP-16 per-lane form: {lanewise[0]:.1f} CUDA kernels, "
        f"{lanewise[1]:.2f} us of device time and {lanewise[2]:.2f} us of "
        "wall per PDHG iteration under the profiler")
    t_end = time.perf_counter()
    log(f"[balance] walls: the Fig. 5 runs {t_forms - t_runs:.2f} s, the two "
        f"forms {t_counts - t_forms:.2f} s, the {2 * (len(counts) + 1)} "
        f"profiled budgets {t_end - t_counts:.2f} s")

    for k, (r, secs) in rows.items():
        kernels, dev_us, wall_us = counts[k]
        row = dict(
            method="full" if k == 1 else f"pop{k}", k=k,
            solve_s=r.solve_time_s, relax_op_s=secs["relax_op"],
            solve_map_s=secs["solve_map"],
            round_repair_s=secs["round_repair"],
            iterations=r.extra["iterations"],
            lane_max_iterations=secs["lane_max_iterations"],
            converged=secs["converged"],
            ms_per_iteration=secs["ms_per_iteration"],
            engine=r.extra["engine"],
            backend=r.extra["backend"], kernels_per_iteration=kernels,
            device_us_per_iteration=dev_us, wall_us_per_iteration=wall_us,
            movement=r.movement, max_load_dev=r.max_load_dev,
            feasible=r.feasible,
            speedup=full.solve_time_s / r.solve_time_s,
            movement_over_full=r.movement / max(full.movement, 1e-9))
        log("[balance] " + json.dumps(row))
        check(r.placement.shape == (BALANCE_SHARDS,)
              and ((r.placement >= 0)
                   & (r.placement < BALANCE_SERVERS)).all(),
              f"{row['method']}: a shard off the servers")
        check(r.extra["engine"] == "matvec", f"engine {r.extra['engine']}")
    log("[balance] " + json.dumps(dict(
        method="greedy", solve_s=greedy_s, movement=greedy["movement"],
        max_load_dev=greedy["max_load_dev"],
        feasible=greedy["load_feasible"] and greedy["mem_feasible"])))
    pop4 = rows[4][0]
    check(full.feasible, "the full relax-and-round placement is infeasible")
    check(full.max_load_dev < greedy["max_load_dev"],
          "the full placement balances no better than E-Store's greedy")
    check(pop4.max_load_dev < 2.0 * wl.eps_frac,
          f"POP-4 max_load_dev {pop4.max_load_dev} not below 2 eps_frac")
    check(pop4.movement < 2.0 * full.movement + 1e-9,
          "POP-4 moves more than twice the full placement's data")


def phase_balance_session(device):
    """The ``load_balance`` domain through ``PopService(device="cuda")`` at
    its defaults (k = 4): 8,192 shards on 256 servers, eps_frac 0.15;
    cold, a +-5% load drift (a hit, warm fraction 1), then 5% churn (a
    repair, warm fraction 7,783 / 8,192), E-Store's greedy beside each
    step."""
    from repro_torch import testing
    from repro_torch.problems import load_balancing as lb
    from repro_torch.service import PopService
    sess = PopService(device=device).session("lb", domain="load_balance")
    walls, secs = [], []

    def step(inst):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a = sess.step(inst)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        secs.append(parts.take())
        return a

    with StepParts() as parts:
        insts, allocs = testing.balance_session(
            step, SESSION_SHARDS, SESSION_SERVERS, SESSION_CHURN,
            eps_frac=SESSION_EPS)
    n_out = int(SESSION_CHURN * SESSION_SHARDS)
    want_wf = [None, 1.0, (SESSION_SHARDS - n_out) / SESSION_SHARDS]
    for inst, a, wall, sec, wf in zip(insts, allocs, walls, secs, want_wf):
        n = inst.n_shards
        base = lb.ShardWorkload(
            load=np.asarray(inst.load, np.float64), mem=np.ones(n),
            placement=np.asarray(inst.current, np.int64),
            cap=np.full(inst.n_targets, float(n)), eps_frac=inst.eps_frac)
        greedy = lb.LoadBalanceProblem(base).evaluate(lb.estore_greedy(base))
        m = a.metrics
        row = dict(step=a.step, plan_cache=a.plan_cache,
                   warm_fraction=a.warm_fraction, k=a.k, engine=a.engine,
                   backend=a.backend, build_time_s=a.build_time_s,
                   solve_time_s=a.solve_time_s, relax_op_s=sec["relax_op"],
                   solve_map_s=sec["solve_map"],
                   round_repair_s=sec["round_repair"], wall_s=wall,
                   iterations=a.iterations,
                   lane_max_iterations=sec["lane_max_iterations"],
                   converged=sec["converged"],
                   ms_per_iteration=sec["ms_per_iteration"],
                   movement=m["movement"],
                   n_moved=m["n_moved"], max_load_dev=m["max_load_dev"],
                   load_feasible=m["load_feasible"],
                   mem_feasible=m["mem_feasible"],
                   greedy_max_load_dev=greedy["max_load_dev"],
                   greedy_movement=greedy["movement"])
        log("[balance-session] " + json.dumps(row))
        check(a.warm_fraction == wf,
              f"step {a.step}: warm fraction {a.warm_fraction}, not {wf}")
        check(np.isfinite(a.alloc).all() and a.alloc.shape == (n,)
              and ((a.alloc >= 0) & (a.alloc < inst.n_targets)).all(),
              f"step {a.step}: the placement is not valid")
        check(m["max_load_dev"] < 2.0 * inst.eps_frac,
              f"step {a.step}: max_load_dev {m['max_load_dev']} not below "
              "2 eps_frac")
    verdicts = [a.plan_cache for a in allocs]
    check(verdicts == ["miss", "hit", "repair"], f"verdicts {verdicts}")


# --------------------------------------------------------------------------
# the dense path
# --------------------------------------------------------------------------

DENSE_NAMES = ("fused_forward_step", "fused_backward_step", "bmatvec",
               "bmatvec_t")


def dense_mods():
    from repro_torch.kernels import fused_pdhg_step, pdhg_matvec
    return pdhg_matvec, fused_pdhg_step


def dense_launches() -> dict:
    return {name: n for mod in dense_mods() for name, n in mod.LAUNCHES.items()}


def dense_tensors(k, M, N, device, seed=1):
    """The half-step vectors of testing.step_operands on ``device``."""
    from repro_torch import testing
    return {name: torch.as_tensor(v, device=device) for name, v in
            testing.step_operands(k, M, N, seed).items()}


def dense_calls(A, o):
    """{kernel name: fn(backend)} of the four dense kernels on ``A``."""
    from repro_torch.kernels import ops
    return {
        "fused_forward_step": lambda be: ops.fused_forward_step(
            A, o["x"], o["c"], o["l"], o["u"], o["tau"], o["kty"],
            backend=be),
        "fused_backward_step": lambda be: ops.fused_backward_step(
            A, o["y"], o["q"], o["sigma"], o["mask"], o["kxn"], o["kxp"],
            backend=be),
        "bmatvec": lambda be: ops.bmatvec(A, o["x"], backend=be),
        "bmatvec_t": lambda be: ops.bmatvec_t(A, o["y"], backend=be)}


def compare_dense(A, o, names):
    """Each named dense kernel against its plain version: the half-steps'
    tails bit-equal, products within the f32 (or, for bf16 A, the bf16)
    tolerance; returns the max abs error of each."""
    bf16 = A.dtype == torch.bfloat16
    rtol, atol = (BF16_RTOL, BF16_ATOL) if bf16 else (PRODUCT_RTOL,
                                                       PRODUCT_ATOL)
    calls = dense_calls(A, o)
    errs = {}
    for name in names:
        got = calls[name]("kernel")
        torch.cuda.synchronize()
        want = calls[name]("ref")
        tail_err = 0.0
        if isinstance(got, tuple):
            tail_err = float((got[0] - want[0]).abs().max())
            check(tail_err == 0.0, f"{name}: tail differs by {tail_err}")
            got, want = got[1], want[1]
        err = (got - want).abs()
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite")
        check(bool((err <= atol + rtol * want.abs()).all()),
              f"{name} ({A.dtype}, {tuple(A.shape)}): product off by "
              f"{float(err.max())} (rtol={rtol}, atol={atol})")
        errs[name] = max(tail_err, float(err.max()))
    return errs


def dense_bytes_ops(k, M, N, coef_bytes=4):
    """{kernel: (bytes, flops)} at A [k, M, N]: A once, each vector in and
    out once; 2 flops per element of A and the tails' element-wise ops."""
    f32, a = 4, k * M * N * coef_bytes
    return {
        # x/c/l/u/kty + tau in, x_new + kx out
        "fused_forward_step": (a + 5 * k * N * f32 + k * f32
                               + (k * N + k * M) * f32,
                               2 * k * M * N + 4 * k * N),
        # y/q/kx_new/kx_prev + mask (u8) + sigma in, y_new + kty out
        "fused_backward_step": (a + 4 * k * M * f32 + k * M + k * f32
                                + (k * M + k * N) * f32,
                                2 * k * M * N + 6 * k * M),
        "bmatvec": (a + k * N * f32 + k * M * f32, 2 * k * M * N),
        "bmatvec_t": (a + k * M * f32 + k * N * f32, 2 * k * M * N)}


def dense_library(A, o):
    """{kernel: fn()}: one torch.bmm of each kernel's product, the tail in
    torch before it for the half-steps (a yardstick the port never
    calls); with bf16 A the vector is cast to bf16, as bmm needs."""
    from repro_torch.kernels import ref
    tau, sigma = o["tau"][:, None], o["sigma"][:, None]
    dt = A.dtype
    return {
        "fused_forward_step": lambda: torch.bmm(A, ref.primal_tail(
            o["x"], o["c"], o["l"], o["u"], tau, o["kty"]).to(dt)[:, :, None]),
        "fused_backward_step": lambda: torch.bmm(ref.dual_tail(
            o["y"], o["q"], sigma, o["mask"], o["kxn"],
            o["kxp"]).to(dt)[:, None, :], A),
        "bmatvec": lambda: torch.bmm(A, o["x"].to(dt)[:, :, None]),
        "bmatvec_t": lambda: torch.bmm(o["y"].to(dt)[:, None, :], A)}


def time_dense(tag, A, o, names):
    """{kernel: (ms, plain_ms, library_ms, bound_ms, bound_by)} of the named
    dense kernels at A's shape, each printed; the kernel and its library
    call timed in turns."""
    k, M, N = A.shape
    work = dense_bytes_ops(k, M, N, A.element_size())
    calls, library = dense_calls(A, o), dense_library(A, o)
    out = {}
    for name in names:
        paired = turns_ms({"kernel": lambda: calls[name]("kernel"),
                           "library": library[name]})
        ms, library_ms = paired["kernel"], paired["library"]
        plain_ms = event_ms(lambda: calls[name]("ref"), reps=50)
        bound_ms, bound_by = bound(*work[name])
        out[name] = (ms, plain_ms, library_ms, bound_ms, bound_by)
        log(f"[kernels-dense] {name} at {tag}, per call: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, torch.bmm {library_ms:.4f} ms, bound "
            f"{bound_ms:.5f} ms "
            f"({bound_by}: {work[name][0] / 1e6:.3f} MB, "
            f"{work[name][1] / 1e6:.3f} Mflop)")
    return out


def dense_instance(device):
    """(problem, prepared structured solve, its densified stack): the main
    path's fleet through ``pop.prepare_instance`` at the Gavel defaults,
    then ``testing.densify`` (``pdhg.structured_to_dense`` on the host,
    moved to the card)."""
    from repro_torch import domains, testing
    from repro_torch.core import pop
    from repro_torch.problems.cluster_scheduling import (
        GavelProblem, make_cluster_workload)
    spec = domains.get("gavel")
    prob = GavelProblem(make_cluster_workload(N_JOBS, num_workers=NUM_WORKERS,
                                              seed=0))
    prep = pop.prepare_instance(prob, spec.default_solve, spec.default_exec,
                                device=device)
    dense = testing.densify(prep.ops)
    log(f"[dense] densified main-path stack: K {tuple(dense.data[0].shape)} "
        f"{dense.data[0].dtype}, {dense.data[0].numel() * 4 / 1e6:.1f} MB, "
        f"{int((dense.data[0] != 0).sum())} nonzeros")
    return prob, prep, dense


def phase_kernels_dense(device, dense_ops):
    """The four dense kernels against their plain versions at the densified
    stack, the sweep shape and the ragged test shapes (f32; bf16 for the
    matvecs); times at the densified stack (the JSON line's) and the sweep
    shape.  Returns the per-kernel records (without launches)."""
    A = dense_ops.data[0]
    k, M, N = A.shape
    max_err = dict.fromkeys(DENSE_NAMES, 0.0)
    rng = np.random.default_rng(0)
    cases = {"densified": (A, dense_tensors(k, M, N, device))}
    for shape in ((32, 256, 256),) + DENSE_TEST_SHAPES:
        a = torch.as_tensor(rng.normal(size=shape), dtype=torch.float32,
                            device=device)
        cases[str(shape)] = (a, dense_tensors(*shape, device))
    for case, (a, o) in cases.items():
        for dt in (torch.float32, torch.bfloat16):
            names = DENSE_NAMES if dt == torch.float32 else DENSE_NAMES[2:]
            errs = compare_dense(a.to(dt), o, names)
            log(f"[kernels-dense] {case} {str(dt)[6:]}: max abs err " + ", ".join(
                f"{n} {e:.3g}" for n, e in errs.items()))
            for n, e in errs.items():
                if dt == torch.float32:
                    max_err[n] = max(max_err[n], e)
    o = cases["densified"][1]
    times = time_dense(f"the densified stack {tuple(A.shape)} f32", A, o,
                       DENSE_NAMES)
    times_bf16 = time_dense(f"the densified stack {tuple(A.shape)} bf16",
                            A.to(torch.bfloat16), o, MATVEC_NAMES)
    a, o_s = cases["(32, 256, 256)"]
    time_dense("the sweep shape (32, 256, 256) f32", a, o_s, DENSE_NAMES)
    records = {}
    for name in DENSE_NAMES:
        ms, plain_ms, library_ms, bound_ms, bound_by = times[name]
        records[name] = dict(
            name=name, route="cuda", source=KERNEL_SOURCE[name],
            replaces=REPLACES[name], launches=0, max_abs_err=max_err[name],
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=library_ms, device_ms=None)
    for name in MATVEC_NAMES:
        ms, plain_ms, library_ms, bound_ms, _ = times_bf16[name]
        records[name]["bfloat16"] = dict(ms=ms, plain_ms=plain_ms,
                                         library_ms=library_ms,
                                         bound_ms=bound_ms)
    return records


def phase_redesign_dense(dense_ops, records):
    """The redesigned matvecs' device times under the profiler at the
    densified stack, f32 and bf16 A, each in turns with torch.bmm of the
    same product (kernel, bmm, bmm, kernel, kernel, bmm; the median of
    each three, all three printed): one CUDA launch a call and bit-for-bit
    the same twice; this run's numbers beside the earlier design's."""
    from repro_torch.kernels import pdhg_matvec as mv
    A32 = dense_ops.data[0]
    k, M, N = A32.shape
    o = dense_tensors(k, M, N, A32.device)
    for dt in (torch.float32, torch.bfloat16):
        A = A32 if dt == torch.float32 else A32.to(dt)
        vec = {"bmatvec": o["x"], "bmatvec_t": o["y"]}
        cast = {name: v.to(dt) for name, v in vec.items()}
        library = {
            "bmatvec": lambda: torch.bmm(A, cast["bmatvec"][:, :, None]),
            "bmatvec_t": lambda: torch.bmm(cast["bmatvec_t"][:, None, :], A)}
        dt_name = str(dt)[6:]
        for name in MATVEC_NAMES:
            kernel = functools.partial(getattr(mv, name), A, vec[name])
            zero_launches(mv)
            first = kernel()
            again = kernel()
            torch.cuda.synchronize()
            check(per_half_step(mv)[name] == 1,
                  f"{name} {dt_name}: {per_half_step(mv)[name]} CUDA "
                  "launches a call")
            check(bool(torch.equal(first, again)),
                  f"{name} {dt_name} is not deterministic")
            dev = {"kernel": [], "library": []}
            for who in ("kernel", "library", "library", "kernel", "kernel",
                        "library"):
                dev[who].append(device_ms(kernel if who == "kernel"
                                          else library[name], calls=50))
            best = {who: _median(vals) for who, vals in dev.items()}
            log(f"[redesign] {name} {dt_name}: device ms of the three "
                f"turns {dev}")
            r = (records[name] if dt == torch.float32
                 else records[name][dt_name])
            r["device_ms_alone"] = best["kernel"]
            r["library_device_ms"] = best["library"]
            log(f"[redesign] {name} {dt_name} at {tuple(A.shape)}: "
                + old_new((name, dt_name), r["ms"], best["kernel"],
                          r["library_ms"], "torch.bmm")
                + f"; torch.bmm device ms {_ms(best['library'])}, bound "
                f"{r['bound_ms']:.5f}, 1 CUDA launch a call")
        del A


def phase_dense(device, prob, prep, dense_ops):
    """The densified main-path stack through ``backends.solve_map(engine=
    "auto")`` at the Gavel defaults, the dense kernels' launch counts set to
    0 just before it and read just after, against the count the code
    predicts; fairness against the structured path's solve of the same
    prepared instance; a fixed budget against ``fused_structured``; a
    profiled fixed budget.  Returns (launches, device ms per call)."""
    from repro_torch.core import backends, pdhg, pop
    kw = dict(prep.solver_kw)
    backend, eng, _ = backends.resolve_exec(dense_ops, pdhg.dense_K_mv,
                                            pdhg.dense_KT_mv)
    log(f"[dense] engine='auto' resolves to engine {pdhg.engine_name(eng)}, "
        f"backend {backend} (the structured stack: {prep.backend}, "
        f"{pdhg.engine_name(prep.engine)})")
    check(pdhg.engine_name(eng) == "fused", f"engine {eng}")

    def finish(res, secs):
        r = pop.finish_prepared(prep, res, secs)
        its = np.asarray(r.iterations)
        m = prob.evaluate(r.alloc)
        return r, m, its

    t0 = time.perf_counter()
    res_s = pop.solve(prob, prep.plan, prep.ops, backend=prep.backend,
                      engine=prep.engine, solver_kw=kw,
                      backend_opts=prep.opts)
    r_s, m_s, its_s = finish(res_s, time.perf_counter() - t0)
    for mod in dense_mods():
        zero_launches(mod)
    t0 = time.perf_counter()
    res = backends.solve_map(dense_ops, pdhg.dense_K_mv, pdhg.dense_KT_mv,
                             kw, engine="auto")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launched = dense_launches()
    r, m, its = finish(res, secs)
    conv = np.asarray(r.converged)
    # one launch of each half-step per iteration of the loop, which runs
    # until its slowest lane stops; K and K^T: 8 each in the equilibration
    # probes (2 sweeps of 4), 31 in the power iteration, the starting
    # products and the final KKT report
    probes = 8 if kw.get("equilibrate") else 0
    predicted = {"fused_forward_step": int(its.max()),
                 "fused_backward_step": int(its.max()),
                 "bmatvec": probes + 33, "bmatvec_t": probes + 33}
    for tag, rr, mm, ii in (("structured", r_s, m_s, its_s),
                            ("dense", r, m, its)):
        log(f"[dense] {tag}: iterations sum {int(ii.sum())} / lane max "
            f"{int(ii.max())}, converged {int(np.asarray(rr.converged).sum())}"
            f"/{ii.size}, solve_s {rr.solve_time_s:.4f} "
            f"({rr.solve_time_s * 1e3 / max(int(ii.max()), 1):.4f} ms per "
            f"iteration), mean_norm_throughput "
            f"{mm['mean_norm_throughput']:.6f}, min_norm_throughput "
            f"{mm['min_norm_throughput']:.6f}")
    from repro_torch.kernels import pdhg_matvec
    per_call = per_half_step(pdhg_matvec)
    log(f"[dense] launches {launched}, predicted {predicted}; CUDA "
        f"launches per matvec call {per_call}")
    check(launched == predicted, "dense launches differ from the prediction")
    check(all(v == 1 for v in per_call.values()),
          f"matvec CUDA launches per call {per_call}")
    check(r.alloc.shape == (N_JOBS,) and np.isfinite(r.alloc).all(),
          "dense allocation not finite")
    check(conv.all(), f"{int((~conv).sum())} dense lane(s) did not converge")
    d_mean = abs(m["mean_norm_throughput"] - m_s["mean_norm_throughput"])
    check(d_mean <= 1e-3, f"dense mean_norm_throughput differs from the "
          f"structured path's by {d_mean}")
    d_earlier = abs(m["mean_norm_throughput"] - DENSE_MEAN_EARLIER)
    check(d_earlier <= DENSE_MEAN_TOL, f"dense mean_norm_throughput "
          f"differs from the earlier design's {DENSE_MEAN_EARLIER} by "
          f"{d_earlier}")

    fixed = dict(kw, max_iters=DENSE_FIXED_ITERS, tol_primal=0.0, tol_gap=0.0)
    for mod in dense_mods():
        zero_launches(mod)
    got = pdhg.solve_stacked(dense_ops, engine="fused", **fixed)
    launched_fixed = dense_launches()
    want = pdhg.solve_stacked(prep.ops, engine="fused_structured", **fixed)
    dx = float(np.abs(got.x - want.x).max())
    dy = float(np.abs(got.y - want.y).max())
    log(f"[dense] fixed budget of {DENSE_FIXED_ITERS} iterations, fused "
        f"against fused_structured on the same stack: max |dx| {dx:.3g}, max "
        f"|dy| {dy:.3g} (rtol=atol={SOLVE_RTOL}); launches {launched_fixed}")
    check(launched_fixed["fused_forward_step"] == DENSE_FIXED_ITERS,
          f"fixed budget: launches {launched_fixed}")
    for name, a, b in (("x", got.x, want.x), ("y", got.y, want.y)):
        check(np.allclose(a, b, rtol=SOLVE_RTOL, atol=SOLVE_ATOL),
              f"fixed-budget {name} differs from fused_structured's")

    prof = dict(kw, max_iters=PROFILE_DENSE_ITERS, tol_primal=0.0,
                tol_gap=0.0)
    per_call, _ = profiled(
        "profile-dense",
        lambda: backends.solve_map(dense_ops, pdhg.dense_K_mv,
                                   pdhg.dense_KT_mv, prof, engine="auto"),
        lambda res_p: np.asarray(res_p.iterations).max())
    return launched, {n: per_call.get(n) for n in DENSE_NAMES}


def phase_dense_sweep(device):
    """``fused`` against ``matvec`` on the reference engine sweep's random
    dense LP stacks: for each k the next k LPs of one seeded draw (as the
    reference draws them), each engine warmed once, then timed in turns,
    keeping the least of :data:`SWEEP_REPEATS`; iterations must be equal
    and every lane finite."""
    from repro_torch import testing
    from repro_torch.core import backends, pdhg
    parts = testing.random_dense_lps(sum(SWEEP_KS), SWEEP_N, SWEEP_MI, seed=0)
    rows, at = [], 0
    for k in SWEEP_KS:
        ops = testing.dense_stack(parts[at:at + k], device)
        at += k

        def run(engine, ops=ops):
            res = backends.solve_map(ops, pdhg.dense_K_mv, pdhg.dense_KT_mv,
                                     SWEEP_KW, engine=engine)
            torch.cuda.synchronize()
            return res

        best, results = {}, {}
        for engine in ("matvec", "fused"):
            run(engine)
        for _ in range(SWEEP_REPEATS):
            for engine in ("matvec", "fused"):
                t0 = time.perf_counter()
                results[engine] = run(engine)
                best[engine] = min(best.get(engine, float("inf")),
                                   time.perf_counter() - t0)
        its = {e: np.asarray(r.iterations) for e, r in results.items()}
        row = dict(k=k, shape=tuple(ops.data[0].shape),
                   matvec_s=best["matvec"], fused_s=best["fused"],
                   matvec_iters=int(its["matvec"].sum()),
                   fused_iters=int(its["fused"].sum()),
                   speedup=best["matvec"] / best["fused"],
                   max_abs_dx=float(np.abs(results["fused"].x
                                           - results["matvec"].x).max()))
        log("[dense-sweep] " + json.dumps(row))
        check(np.array_equal(its["matvec"], its["fused"]),
              f"k={k}: iterations {its['matvec']} (matvec) against "
              f"{its['fused']} (fused)")
        for engine, r in results.items():
            check(np.isfinite(r.x).all() and not np.asarray(r.diverged).any(),
                  f"k={k}: {engine} diverged or not finite")
        rows.append(row)
    return rows


def phase_solve_dense(device):
    """``pdhg.solve_dense`` at the reference's pdhg_vs_scipy size against
    scipy's HiGHS: objective within 1e-3 (1 + |f|), inequality violation
    below 1e-3, box violation below 1e-5 (``tests/test_pdhg.py``)."""
    from scipy.optimize import linprog
    from repro_torch import testing
    from repro_torch.core import pdhg
    from repro_torch.core.problem import LinearProgram
    ((c, G, h),) = testing.random_dense_lps(1, SCIPY_N, SCIPY_MI, seed=0)
    t0 = time.perf_counter()
    ref = linprog(c, A_ub=G, b_ub=h, bounds=(0, 1), method="highs")
    scipy_s = time.perf_counter() - t0
    lp = LinearProgram.build(c=c, G=G, h=h, l=np.zeros(SCIPY_N),
                             u=np.ones(SCIPY_N), device=device)
    pdhg.solve_dense(lp, max_iters=100)
    t0 = time.perf_counter()
    res = pdhg.solve_dense(lp, max_iters=60_000, tol_primal=1e-6,
                           tol_gap=1e-6)
    secs = time.perf_counter() - t0
    gap = abs(float(res.primal_obj) - ref.fun) / (1 + abs(ref.fun))
    v = {k: float(a) for k, a in lp.violations(
        torch.as_tensor(res.x, device=device)).items()}
    log(f"[solve-dense] n={SCIPY_N} mi={SCIPY_MI}: {int(res.iterations)} "
        f"iterations, converged {bool(res.converged)}, {secs:.3f} s (HiGHS "
        f"{scipy_s:.3f} s on the host); objective {float(res.primal_obj):.6f} "
        f"against HiGHS {ref.fun:.6f} (relative gap {gap:.3g}); "
        f"violations {v}")
    check(gap < 1e-3, f"objective off HiGHS's by {gap}")
    check(v["ineq_max"] < 1e-3, f"inequality violation {v['ineq_max']}")
    check(v["box_max"] < 1e-5, f"box violation {v['box_max']}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    device = torch.device("cuda")
    # the CSR yardstick's beta-state and invariant-check notices
    warnings.filterwarnings("ignore", message=".*[Ss]parse.*")
    walls = {}

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - t0
        log(f"[{name}] phase wall {walls[name]:.2f} s")
        return out

    try:
        from repro_torch import testing
        from repro_torch.problems.traffic_engineering import TrafficProblem
        card = phase("card", phase_card)
        phase("build", phase_build)
        phase("lm-reduced", phase_lm_reduced, device)
        phase("serve", phase_serve, device)
        phase("serve-balanced", phase_serve_balanced, device)
        phase("train", phase_train, device, card)
        phase("train-driver", phase_train_driver, device)
        phase("train-e2e", phase_train_e2e, device)
        ckpt = phase("mesh-train", phase_mesh_train, device, card)
        phase("mesh-serve", phase_mesh_serve, device)
        phase("mesh-tp", phase_mesh_tp, device)
        phase("mesh-collectives", phase_mesh_collectives, device, ckpt)
        records, lane_case = phase("kernels", phase_kernels, device)
        te_arrays = phase("te-instance", testing.traffic_arrays, TE_DEMANDS)
        full_records, full_cases = phase("kernels-full", phase_kernels_full,
                                         device, TrafficProblem(*te_arrays))
        records.update(full_records)
        sess, insts, allocs, launches = phase("main", phase_main, device)
        phase("mesh-pop", phase_mesh_pop, device, insts, allocs)
        phase("tune", phase_tune, device, insts, allocs)
        moe_sess, moe_inst = phase("moe", phase_moe, device)
        phase("robust", phase_robust, device, insts)
        steady = phase("steady", phase_steady, device, insts)
        phase("quickstart", phase_quickstart, device)
        phase("async", phase_async, device)
        profiled_ms = phase("profile", phase_profile, sess, insts[2])
        phase("steady-profile", phase_steady_profile, *steady)
        runs, full_paths = phase("full", phase_full, device, te_arrays)
        gavel_prob = gavel_full_problem()
        full_profiles = phase("profile-full", phase_profile_full, device,
                              te_arrays, gavel_prob)
        phase("traffic", phase_traffic, device, te_arrays,
              {dt: runs[dt] for dt in ("float32",
                                       f"float32_{TE_LONG_ITERS}")})
        full_paths["gavel_full"] = phase("gavel-full", phase_gavel_full,
                                         device, gavel_prob, allocs)
        phase("balance-kernels", phase_balance_kernels, device)
        phase("balance", phase_balance, device)
        phase("balance-session", phase_balance_session, device)
        phase("moe-profile", phase_moe_profile, moe_sess, moe_inst)
        phase("redesign", phase_redesign, lane_case, full_cases, records)
        prob, prep, dense_ops = phase("dense-instance", dense_instance,
                                      device)
        records.update(phase("kernels-dense", phase_kernels_dense, device,
                             dense_ops))
        phase("redesign-dense", phase_redesign_dense, dense_ops, records)
        dense_launched, dense_ms = phase("dense", phase_dense, device, prob,
                                         prep, dense_ops)
        phase("dense-sweep", phase_dense_sweep, device)
        phase("solve-dense", phase_solve_dense, device)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    # the JSON line: the lane kernels' launches over the main path, the
    # full kernels' over the traffic f32 solve, the dense kernels' over the
    # dense path's Gavel-defaults solve; device ms at the same shapes
    profiled_ms.update(full_profiles["te_float32"])
    profiled_ms.update(dense_ms)
    launches.update(full_paths["te_float32"])
    launches.update(dense_launched)
    for name, n in launches.items():
        records[name]["launches"] = n
        records[name]["device_ms"] = profiled_ms.get(name)
    for name in STRUCTURED_NAMES:
        r = records[name]
        log(f"[redesign] {name}: " + old_new(name, r["ms"], r["device_ms"],
                                              r["library_ms"])
            + f", bound {r['bound_ms']:.5f}, launches {r['launches']}")
    log("[launches] full kernels, each run's own count: " + "; ".join(
        f"{run} {counts}" for run, counts in full_paths.items()))
    log("[device-ms] full kernels per call: " + "; ".join(
        f"{case} {per_call}" for case, per_call in full_profiles.items()))
    log("[walls] " + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items())
        + f"; total {sum(walls.values()):.1f} s")
    print(json.dumps({"kernels": list(records.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-tp-rank"]:
        mesh_tp_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4])
        sys.exit(0)
    sys.exit(main())
