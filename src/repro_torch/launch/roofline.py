"""Roofline analysis: aggregate the dry run's JSONs into a dry-run table and
a roofline table — the port of ``repro/launch/roofline.py`` for the card
the port runs on.

Hardware model: the NVIDIA H100 SXM5's datasheet figures, per card:
    dense bf16 tensor cores   989.4 TFLOP/s
    HBM3 bandwidth            3.35 TB/s
    NVLink                    450 GB/s a direction (900 GB/s both ways)
(Check the card: ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader``; a card below its 700 W limit runs slower.)

Per (arch x shape) on the single-pod 256-rank mesh:

    compute term    = FLOPs_per_device / PEAK_FLOPS              [s]
    memory term     = bytes_per_device / HBM_BW                  [s]
    collective term = collective_bytes_per_device / LINK_BW      [s]

The dry run counts per device on rank 0's shapes (``launch/dryrun.py``).
Its bytes are an unfused upper bound (every op's inputs and outputs), so
the bottleneck is judged on the compute term, the collective term and an
analytic memory floor (parameters and cache read once), as the reference
judges it.  The port's steps shard memory over ``model`` and compute the
whole model on each rank's rows (``train/train_step.py``), so a cell's
useful ratio MODEL_FLOPs / (FLOPs x chips) reads the redundancy too.
"""

from __future__ import annotations

import json
import os
from glob import glob

PEAK_FLOPS = 989.4e12      # H100 SXM5 dense bf16, datasheet
HBM_BW = 3.35e12           # H100 SXM5 HBM3, datasheet
LINK_BW = 450e9            # H100 SXM5 NVLink, one direction, datasheet

HERE = os.path.dirname(__file__)
DRYRUN_DIR = os.path.normpath(os.path.join(HERE, "..", "..", "..",
                                           "experiments", "dryrun_torch"))

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load_cells(mesh: str = "single", root: str = DRYRUN_DIR):
    cells = {}
    for path in glob(os.path.join(root, mesh, "*.json")):
        with open(path) as f:
            d = json.load(f)
        cells[(d["arch"], d["shape"])] = d
    return cells


def analytic_bytes_floor(d: dict) -> float:
    """Per-device lower bound on memory traffic for one step: every
    resident param read once per microbatch (+ grads/opt write ~2x for
    train), plus the KV/state cache read+write for decode."""
    chips = d.get("chips", 256)
    params_local = d["params_total"] * 4.0 / chips
    if d["shape"].startswith("train"):
        n_micro = (d.get("probes") or {}).get("n_micro", 1)
        return params_local * (n_micro + 3)
    cache = d.get("mem_argument_size_in_bytes", 0) - params_local
    return params_local + max(cache, 0) * 2.0


def roofline_row(d: dict) -> dict:
    p = d.get("probes") or {}
    fl = p.get("flops_per_device", 0.0)
    by = p.get("bytes_per_device", 0.0)
    co = p.get("collective_bytes_per_device", 0.0)
    t_c = fl / PEAK_FLOPS
    t_m = by / HBM_BW              # unfused upper bound
    t_x = co / LINK_BW
    floor = analytic_bytes_floor(d)
    t_mf = floor / HBM_BW          # analytic floor
    dom = max(("compute", t_c), ("memory", t_mf), ("collective", t_x),
              key=lambda kv: kv[1])[0]
    model = d.get("model_flops", 0.0)
    global_flops = fl * d.get("chips", 256)
    useful = (model / global_flops) if global_flops else 0.0
    if dom == "compute":
        frac = useful
    elif dom == "memory":
        frac = floor / by if by else 0.0
    else:
        frac = min(1.0, t_mf / t_x) if t_x else 0.0
    return {
        "arch": d["arch"], "shape": d["shape"],
        "compute_s": t_c, "memory_s": t_m, "memory_floor_s": t_mf,
        "collective_s": t_x,
        "bottleneck": dom,
        "model_flops": model,
        "flops_global": global_flops,
        "useful_ratio": useful,
        "roofline_frac": frac,
    }


def fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x*1e6:.0f}us"
    if x < 1:
        return f"{x*1e3:.1f}ms"
    return f"{x:.2f}s"


def dryrun_table(cells_single, cells_multi) -> str:
    lines = [
        "| arch | shape | single-pod (16x16) | multi-pod (2x16x16) | "
        "trace s s/m | per-dev args (GB) | collectives (count) |",
        "|---|---|---|---|---|---|---|",
    ]
    archs = sorted({a for a, _ in cells_single} | {a for a, _ in cells_multi})
    for a in archs:
        for s in SHAPE_ORDER:
            d1 = cells_single.get((a, s))
            d2 = cells_multi.get((a, s))
            if d1 is None and d2 is None:
                continue
            st1 = (d1 or {}).get("status", "-")
            st2 = (d2 or {}).get("status", "-")
            if st1 == "skipped":
                lines.append(f"| {a} | {s} | SKIP | SKIP | - | - | "
                             f"{(d1 or {}).get('reason', '')[:60]} |")
                continue
            trace = (f"{(d1 or {}).get('lower_s', '-')}/"
                     f"{(d2 or {}).get('lower_s', '-')}")
            arg = (d1 or {}).get("mem_argument_size_in_bytes", 0) / 2**30
            cnt = ((d1 or {}).get("collectives") or {}).get("count", "-")
            lines.append(f"| {a} | {s} | {st1} | {st2} | {trace} | "
                         f"{arg:.2f} | {cnt} |")
    return "\n".join(lines)


def roofline_table(cells_single):
    lines = [
        "| arch | shape | compute | mem(floor) | mem(ub) | collective | "
        "bottleneck | MODEL TFLOPs | MODEL/FLOPs | roofline frac |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    archs = sorted({a for a, _ in cells_single})
    rows = []
    for a in archs:
        for s in SHAPE_ORDER:
            d = cells_single.get((a, s))
            if d is None or d.get("status") != "ok" or not d.get("probes"):
                continue
            r = roofline_row(d)
            rows.append(r)
            lines.append(
                f"| {r['arch']} | {r['shape']} | {fmt_s(r['compute_s'])} | "
                f"{fmt_s(r['memory_floor_s'])} | {fmt_s(r['memory_s'])} | "
                f"{fmt_s(r['collective_s'])} | "
                f"**{r['bottleneck']}** | {r['model_flops']/1e12:.1f} | "
                f"{r['useful_ratio']:.3f} | {r['roofline_frac']:.3f} |")
    return "\n".join(lines), rows


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=DRYRUN_DIR)
    a = ap.parse_args(argv)
    single = load_cells("single", a.dir)
    multi = load_cells("multi", a.dir)
    n_ok_s = sum(1 for d in single.values() if d["status"] == "ok")
    n_ok_m = sum(1 for d in multi.values() if d["status"] == "ok")
    n_skip = sum(1 for d in single.values() if d["status"] == "skipped")
    n_err = sum(1 for d in list(single.values()) + list(multi.values())
                if d["status"] == "error")
    print(f"hardware: H100 SXM5 datasheet, {PEAK_FLOPS/1e12:.1f} TFLOP/s "
          f"bf16, {HBM_BW/1e12:.2f} TB/s HBM3, {LINK_BW/1e9:.0f} GB/s "
          "NVLink a direction")
    print(f"single-pod: {n_ok_s} ok, multi-pod: {n_ok_m} ok, "
          f"{n_skip} documented skips, {n_err} errors")
    print()
    print(dryrun_table(single, multi))
    print()
    tbl, rows = roofline_table(single)
    print(tbl)
    if rows:
        worst = min(rows, key=lambda r: r["roofline_frac"])
        coll = max(rows, key=lambda r: r["collective_s"])
        print(f"\nworst roofline fraction: {worst['arch']}/{worst['shape']} "
              f"({worst['roofline_frac']:.3f})")
        print(f"most collective-bound: {coll['arch']}/{coll['shape']} "
              f"({fmt_s(coll['collective_s'])})")
    return rows


if __name__ == "__main__":
    main()
