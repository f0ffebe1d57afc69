#!/usr/bin/env python
"""Snapshot the port's public API surface (exported names + signatures).

The twin of ``scripts/api_surface.py``: the reference's public modules
(its ``PUBLIC_MODULES``) with ``repro`` changed to ``repro_torch``,
rendered by the same logic into a deterministic text snapshot.  The
committed copy lives at ``docs/api_surface_torch.txt``;
``tests/test_torch_api_surface.py`` and popcheck's ``api-drift`` rule diff
a fresh render against it.

    PYTHONPATH=src python scripts/api_surface_torch.py          # stdout
    PYTHONPATH=src python scripts/api_surface_torch.py --write  # refresh

Intentional surface changes re-run ``--write`` and commit the diff.
"""

from __future__ import annotations

import argparse
import inspect
import re
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent
SNAPSHOT = REPO_ROOT / "docs" / "api_surface_torch.txt"

# the reference's public modules, in its render order, under the port's name
PUBLIC_MODULES = [
    "repro_torch.service",
    "repro_torch.domains",
    "repro_torch.core",
    "repro_torch.core.config",
    "repro_torch.problems",
    "repro_torch.serve",
    "repro_torch.sched",
    "repro_torch.tuning",
]

_ADDR = re.compile(r" at 0x[0-9a-fA-F]+")


def _sig(obj) -> str:
    try:
        return _ADDR.sub("", str(inspect.signature(obj)))
    except (ValueError, TypeError):
        return "(...)"


def _public_names(mod) -> list:
    if hasattr(mod, "__all__"):
        return list(mod.__all__)
    return sorted(n for n in vars(mod) if not n.startswith("_"))


def _render_class(qual: str, cls) -> list:
    lines = [f"class {qual}{_sig(cls)}"]
    for name, member in sorted(vars(cls).items()):
        if name.startswith("_"):
            continue
        if isinstance(member, (staticmethod, classmethod)):
            member = member.__func__
        if inspect.isfunction(member):
            lines.append(f"  {qual}.{name}{_sig(member)}")
        elif isinstance(member, property):
            lines.append(f"  {qual}.{name} [property]")
    return lines


def render() -> str:
    lines = [
        "# Public API surface snapshot of the port — generated by "
        "scripts/api_surface_torch.py --write.",
        "# tests/test_torch_api_surface.py diffs a fresh render against "
        "this file: intentional",
        "# surface changes regenerate it so the diff shows up in review.",
    ]
    import importlib
    for mod_name in PUBLIC_MODULES:
        mod = importlib.import_module(mod_name)
        lines.append("")
        lines.append(f"== {mod_name} ==")
        for name in _public_names(mod):
            obj = getattr(mod, name)
            qual = f"{mod_name}.{name}"
            if inspect.isclass(obj):
                lines.extend(_render_class(qual, obj))
            elif callable(obj):
                lines.append(f"{qual}{_sig(obj)}")
            elif inspect.ismodule(obj):
                lines.append(f"{qual} [module]")
            else:
                lines.append(f"{qual}: {type(obj).__name__}")
    return "\n".join(lines) + "\n"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--write", action="store_true",
                    help=f"write the snapshot to {SNAPSHOT}")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO_ROOT / "src"))
    text = render()
    if args.write:
        SNAPSHOT.parent.mkdir(parents=True, exist_ok=True)
        SNAPSHOT.write_text(text)
        print(f"wrote {SNAPSHOT} ({len(text.splitlines())} lines)")
    else:
        sys.stdout.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
