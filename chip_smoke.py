#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of POP (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which must pass:

1. card     the card's name and power limit (nvidia-smi); TF32 off;
2. build    compile the hand-written CUDA kernels from the sources in
            ``src/repro_torch/kernels/csrc`` (nvcc, sm_90a);
3. kernels  each kernel against its plain PyTorch version on the card, at
            the main path's stacked Gavel shapes and at skewed test
            shapes, with its time beside the plain version's, a
            ``torch.sparse`` CSR product of the same K and the bound;
4. main     the main path: an online Gavel POP session through
            ``PopService(device="cuda")`` at 16,384 jobs on 12,288
            accelerators, registry defaults (k=8, equilibrate), three steps
            (cold, a +-3% throughput drift, 5% job churn with stable ids);
            the kernels' launch counts are set to 0 before it and read
            after it; every lane converges and the allocation beats the
            Gandiva heuristic's fairness twice over, as the reference's
            own test holds it (``tests/test_problems.py``);
5. profile  one more warm step under ``torch.profiler``: device time by
            kernel and the device's busy share.

Prints one JSON line of kernel results, then the card line, and as the
last line ``{"ok": true, "device": {...}}``.  Exits nonzero, printing no
result, without a CUDA device or outside the repository.
"""

from __future__ import annotations

import json
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
# NVIDIA H100 SXM data sheet: HBM3 rate and f32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# tails: bit-equal (every op rounded to nearest, no FMA, as the plain
# version's separate elementwise ops); products: another summation order,
# held at the reference's product tolerance (tests/test_kernels.py)
PRODUCT_RTOL = PRODUCT_ATOL = 1e-4
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/structured_pdhg_step.cu"
REPLACES = {
    "structured_forward_step": "src/repro/kernels/structured_pdhg_step.py:110",
    "structured_backward_step": "src/repro/kernels/structured_pdhg_step.py:141",
}


class SmokeError(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


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
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr.strip()}")
    card = proc.stdout.strip().splitlines()[0].strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[card] {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    return card


def phase_build():
    from repro_torch.kernels import structured_pdhg_step as kernel_mod
    t0 = time.perf_counter()
    kernel_mod.build()
    secs = time.perf_counter() - t0
    regs = [ln.strip() for ln in kernel_mod.build_info.get("log", "")
            .splitlines() if "registers" in ln or "spill" in ln]
    how = ("compiled by nvcc" if "seconds" in kernel_mod.build_info
           else "loaded from an earlier build")
    log(f"[build] {kernel_mod.library_path().name}: {how}, {secs:.2f} s")
    for ln in regs:
        log(f"[build]   {ln}")


def compare_case(s, o):
    """Kernel vs plain version on one operator: returns the max abs error
    of each kernel and fails the run outside the tolerance."""
    from repro_torch.kernels import ops
    fwd_args = (s, o["x"], o["c"], o["l"], o["u"], o["tau"], o["kty"])
    bwd_args = (s, o["y"], o["q"], o["sigma"], o["mask"], o["kxn"], o["kxp"])
    errs = {}
    for name, fn, args in (("structured_forward_step",
                            ops.structured_forward_step, fwd_args),
                           ("structured_backward_step",
                            ops.structured_backward_step, bwd_args)):
        got = fn(*args, backend="kernel")
        torch.cuda.synchronize()
        want = fn(*args, backend="ref")
        tail_err = float((got[0] - want[0]).abs().max())
        prod_err = (got[1] - want[1]).abs()
        limit = PRODUCT_ATOL + PRODUCT_RTOL * want[1].abs()
        check(bool(torch.isfinite(got[1]).all()), f"{name}: non-finite")
        check(tail_err == 0.0, f"{name}: tail differs by {tail_err}")
        check(bool((prod_err <= limit).all()),
              f"{name}: product off by {float(prod_err.max())} "
              f"(rtol=atol={PRODUCT_RTOL})")
        errs[name] = max(tail_err, float(prod_err.max()))
    return errs


def phase_kernels(device):
    """Each kernel against its plain version; times at the main path's
    shapes.  Returns the per-kernel record (without launches)."""
    from repro_torch import testing
    from repro_torch.core import pdhg, pop
    from repro_torch.kernels import ops
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
        errs = compare_case(op_s, testing.step_tensors(op_s, device))
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
    specs = (
        ("structured_forward_step",
         lambda be: ops.structured_forward_step(
             s, o["x"], o["c"], o["l"], o["u"], o["tau"], o["kty"],
             backend=be),
         lambda: csr_k @ x_flat,
         # ELL nonzeros (idx + val) + wide ids, x/c/l/u/kty + tau in,
         # x_new + kx out
         nnz_k * 8 + k * s.wrow_ids.shape[1] * 4 + 5 * k * N * f32 + k * f32
         + (k * N + k * M) * f32,
         2 * nnz_k + 4 * k * N),
        ("structured_backward_step",
         lambda be: ops.structured_backward_step(
             s, o["y"], o["q"], o["sigma"], o["mask"], o["kxn"], o["kxp"],
             backend=be),
         lambda: csr_kt @ y_flat,
         # y/q/kx_new/kx_prev (f32) + mask (u8) + sigma in, y_new + kty out
         nnz_kt * 8 + k * s.wcol_ids.shape[1] * 4 + 4 * k * M * f32 + k * M
         + k * f32 + (k * M + k * N) * f32,
         2 * nnz_kt + 6 * k * M),
    )
    for name, step, library, n_bytes, n_ops in specs:
        ms = event_ms(lambda: step("kernel"))
        plain_ms = event_ms(lambda: step("ref"))
        library_ms = event_ms(library)
        bound_ms, bound_by = bound(n_bytes, n_ops)
        records[name] = dict(
            name=name, route="cuda", source=KERNEL_SOURCE,
            replaces=REPLACES[name], launches=0,
            max_abs_err=max_err[name], ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
            device_ms=None)
        log(f"[kernels] {name} at the main-path shape, per call: kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"torch.sparse CSR product {library_ms:.4f} ms, bound "
            f"{bound_ms:.5f} ms ({bound_by}: {n_bytes / 1e6:.3f} MB, "
            f"{n_ops / 1e6:.3f} Mflop)")
    return records


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
    for name in kernel_mod.LAUNCHES:
        kernel_mod.LAUNCHES[name] = 0
    allocs = []
    t_run = time.perf_counter()
    for inst in insts:
        allocs.append(sess.step(inst))
        if device.type == "cuda":
            torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    launches = dict(kernel_mod.LAUNCHES)
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
    check(verdicts == ["miss", "hit", "repair"], f"verdicts {verdicts}")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")
    return sess, insts, launches


# the CUDA kernels' names carry the half-step's tail type
HALF_STEP_TAIL = {"structured_forward_step": "PrimalTail>",
                  "structured_backward_step": "DualTail>"}


def phase_profile(sess, inst):
    """One more warm step under the profiler: device time by kernel, the
    device's busy share of the step, and each half-step's device time per
    call on the main path ({name: ms}, empty where nothing was recorded)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        a = sess.step(inst)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = sorted(((ev.self_device_time_total, ev.count, ev.key)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA), reverse=True)
    busy_us = sum(r[0] for r in rows)
    n_dev = sum(r[1] for r in rows)
    iters = int(max(a.raw.iterations.max(), 1))
    if busy_us == 0:
        log("[profile] the profiler recorded no device time: not measured")
        return {}
    log(f"[profile] warm step ({a.plan_cache}): wall {wall_us / 1e3:.2f} ms "
        f"under the profiler, device busy {busy_us / 1e3:.2f} ms "
        f"({100 * busy_us / wall_us:.1f}%), {n_dev} kernels, "
        f"{n_dev / iters:.1f} per PDHG iteration ({iters} iterations, "
        f"{busy_us / iters:.2f} us of device time per iteration)")
    for dev_us, count, key in rows[:12]:
        log(f"[profile]   {dev_us / 1e3:9.3f} ms {100 * dev_us / busy_us:5.1f}% "
            f"x{count:<7d} {key[:90]}")
    per_call = {}
    for name, tail in HALF_STEP_TAIL.items():
        mine = [r for r in rows if tail in r[2]]
        calls = sum(r[1] for r in mine if "narrow_tail_kernel" in r[2])
        if calls:
            per_call[name] = sum(r[0] for r in mine) / calls / 1e3
            log(f"[profile] {name}: {per_call[name]:.4f} ms of device time "
                f"per call ({calls} calls, both launches)")
    return per_call


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
    try:
        card = phase_card()
        phase_build()
        records = phase_kernels(device)
        sess, insts, launches = phase_main(device)
        profiled_ms = phase_profile(sess, insts[2])
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    for name, n in launches.items():
        records[name]["launches"] = n
        records[name]["device_ms"] = profiled_ms.get(name)
    print(json.dumps({"kernels": list(records.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
