#!/usr/bin/env python
"""tune_torch: measure quality/latency curves on a torch device and emit a
TuningProfile artifact (the twin of ``scripts/tune.py`` for the PyTorch
port, ``src/repro_torch``).

    python scripts/tune_torch.py              # full sweep on the card, writes
                                              # TUNING_profile.cuda.json
    python scripts/tune_torch.py --fast       # scaled-down probes
    python scripts/tune_torch.py --domains gavel,traffic
    python scripts/tune_torch.py --device cpu --fast --emit /tmp/prof.json
    python scripts/tune_torch.py --no-launch --no-backends   # curves only

The artifact has the reference's schema and digest seal (either package's
``check_profile`` accepts it); ``platform`` names the torch device type
it was measured on.  ``PopService(profile=...)`` uses it to plan sessions
against an :class:`~repro_torch.tuning.SLOTarget`, install measured
``backend="auto"`` thresholds for that device type, and size dispatcher
defaults.  The default output is not the committed ``TUNING_profile.json``,
which the reference measured on the CPU.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO_ROOT / "src"))

from repro_torch.tuning import (build_profile, check_profile,  # noqa: E402
                                save_profile)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--domains", default="gavel,traffic,moe_placement",
                    help="comma-separated domain names to profile")
    ap.add_argument("--fast", action="store_true",
                    help="scaled-down probes (smaller n, fewer iters)")
    ap.add_argument("--emit",
                    default=str(REPO_ROOT / "TUNING_profile.cuda.json"),
                    help="output path (default: TUNING_profile.cuda.json)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to measure on (default: cuda)")
    ap.add_argument("--no-launch", action="store_true",
                    help="skip the dispatcher launch-cost measurement")
    ap.add_argument("--no-backends", action="store_true",
                    help="skip the vmap-vs-chunked threshold measurement")
    args = ap.parse_args(argv)

    domains = tuple(d.strip() for d in args.domains.split(",") if d.strip())
    profile = build_profile(
        domains=domains, fast=args.fast, seed=args.seed,
        measure_launch=not args.no_launch,
        measure_backends=not args.no_backends, device=args.device,
        log=lambda msg: print(f"[tune] {msg}", flush=True))
    out = Path(args.emit)
    save_profile(profile, out)
    check_profile(profile)   # self-check the seal we just wrote
    print(f"[tune] wrote {out} ({profile.platform}, "
          f"{len(profile.domains)} domain(s), {profile.digest[:18]}...)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
