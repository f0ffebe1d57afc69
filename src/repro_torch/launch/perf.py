"""The flags harness: roofline terms of one (arch, shape) cell under named
optimisation flags, as lines comparable before and after — the port of
``repro/launch/perf.py`` over ``dryrun.probe_costs``.

    python -m repro_torch.launch.perf --arch llama3_8b --shape decode_32k \\
        --flags cache_seq_on_model

Flags: ``shard_cache_seq``, ``cache_seq_on_model`` (the serve step's
cache layouts), ``moe_cf=<float>``, and the model options
``sp_residual``, ``gather_once`` and ``bf16_barrier``
(``models.transformer.ModelOpts``; a decode step's one position never
runs sequence-parallel).  Writes
``experiments/perf_torch/<arch>__<shape>__<tag>.json``.
"""

from __future__ import annotations

import argparse
import json
import os

from ..configs import get_config
from . import shardings as sh
from . import specs as sp
from .dryrun import check_flags, fake_mesh, probe_costs
from .mesh import SINGLE_POD
from .roofline import HBM_BW, LINK_BW, PEAK_FLOPS, fmt_s

OUT_DIR = os.path.normpath(os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "experiments", "perf_torch"))


def measure(arch: str, shape: str, flags: dict, mesh_shape=None) -> dict:
    cfg = get_config(arch)
    cell = sp.SHAPES[shape]
    mesh = fake_mesh(tuple(mesh_shape) if mesh_shape else SINGLE_POD[0],
                     ("data", "model"))
    n_dp = sh.dp_size(mesh)
    p = probe_costs(cfg, cell, mesh, n_dp, flags=flags)
    return {
        "arch": arch, "shape": shape, "flags": flags,
        "flops_per_device": p["flops_per_device"],
        "bytes_per_device": p["bytes_per_device"],
        "collective_bytes_per_device": p["collective_bytes_per_device"],
        "compute_s": p["flops_per_device"] / PEAK_FLOPS,
        "memory_s": p["bytes_per_device"] / HBM_BW,
        "collective_s": p["collective_bytes_per_device"] / LINK_BW,
    }


def parse_flags(text: str) -> dict:
    flags = {}
    for f in text.split(","):
        if not f:
            continue
        if "=" in f:
            k, v = f.split("=")
            try:
                flags[k] = float(v)
            except ValueError:
                flags[k] = v in ("1", "true", "True")
        else:
            flags[f] = True
    return check_flags(flags)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--flags", default="")
    ap.add_argument("--tag", default=None)
    ap.add_argument("--mesh-shape", default=None,
                    help="e.g. 32x8 (default: the production 16x16)")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)
    flags = parse_flags(args.flags)
    mesh_shape = (tuple(int(x) for x in args.mesh_shape.split("x"))
                  if args.mesh_shape else None)
    r = measure(args.arch, args.shape, flags, mesh_shape=mesh_shape)
    tag = args.tag or (",".join(sorted(flags)) or "baseline")
    print(f"[perf] {args.arch}/{args.shape} [{tag}] "
          f"compute={fmt_s(r['compute_s'])} memory={fmt_s(r['memory_s'])} "
          f"collective={fmt_s(r['collective_s'])} "
          f"(coll_bytes={r['collective_bytes_per_device']:.3e})")
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out,
                           f"{args.arch}__{args.shape}__{tag}.json"),
              "w") as f:
        json.dump(r, f, indent=1)
    return r


if __name__ == "__main__":
    main()
