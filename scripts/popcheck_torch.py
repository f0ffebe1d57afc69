#!/usr/bin/env python
"""popcheck for the port: static analysis tuned to the port's hot-path
failure modes (the twin of ``scripts/popcheck.py``).

    python scripts/popcheck_torch.py                # scan src/repro_torch,
                                                    # examples_torch/ and
                                                    # chip_smoke.py; exit 1
                                                    # on any non-baselined
                                                    # finding
    python scripts/popcheck_torch.py --baseline     # snapshot current
                                                    # findings into
                                                    # popcheck_torch_baseline.json
    python scripts/popcheck_torch.py --no-baseline  # report everything
    python scripts/popcheck_torch.py --rules host-sync-in-hot-path,api-drift
    python scripts/popcheck_torch.py path/to/file.py  # scan given paths

Rule catalog, suppression syntax and the reason for every baselined
finding: docs/LINTS_torch.md.  The committed baseline
(popcheck_torch_baseline.json) holds the known, intentionally tolerated
findings; the scan fails only on NEW ones.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO_ROOT / "src"))

from repro_torch.analysis import (  # noqa: E402
    RULES, load_baseline, run_popcheck, write_baseline)
from repro_torch.analysis.core import DEFAULT_SCAN_DIRS  # noqa: E402

BASELINE = REPO_ROOT / "popcheck_torch_baseline.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("paths", nargs="*",
                    help=f"files/dirs to scan (default: {DEFAULT_SCAN_DIRS})")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule subset (default: all)")
    ap.add_argument("--baseline", action="store_true",
                    help=f"write current findings to {BASELINE.name} "
                         "instead of failing on them")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the committed baseline (report everything)")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        for name in sorted(RULES):
            print(name)
        return 0

    paths = ([Path(p) for p in args.paths] if args.paths
             else [REPO_ROOT / d for d in DEFAULT_SCAN_DIRS])
    rules = args.rules.split(",") if args.rules else None
    baseline = {} if (args.baseline or args.no_baseline) \
        else load_baseline(BASELINE)

    findings = run_popcheck(paths, rules=rules, baseline=baseline,
                            repo_root=REPO_ROOT)

    if args.baseline:
        write_baseline(findings, BASELINE)
        print(f"popcheck: baselined {len(findings)} finding(s) "
              f"-> {BASELINE.name}")
        for f in findings:
            print(f"  {f.render()}")
        return 0

    for f in findings:
        print(f.render())
    n_rules = len(rules) if rules else len(RULES)
    if findings:
        print(f"popcheck: {len(findings)} new finding(s) across {n_rules} "
              "rule(s); fix them, suppress with '# popcheck: "
              "disable=<rule>', or re-baseline (--baseline) with the "
              "reason in docs/LINTS_torch.md")
        return 1
    print(f"popcheck: clean ({n_rules} rule(s))")
    return 0


if __name__ == "__main__":
    sys.exit(main())
