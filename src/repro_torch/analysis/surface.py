"""Rule ``api-drift``: the port's live public surface must match its
committed snapshot — the port of ``repro/analysis/surface.py``.

Reuses ``scripts/api_surface_torch.py`` (the renderer
``tests/test_torch_api_surface.py`` uses): a fresh render of the public
modules is diffed against ``docs/api_surface_torch.txt``.  Drift is a
finding — intentional surface changes regenerate the snapshot so the diff
shows up in review, accidental ones fail ``scripts/popcheck_torch.py``.

Unlike the AST rules this one imports the live package; when the renderer
or snapshot are unavailable (fixture-only runs, missing repo root) the
rule degrades to silence rather than inventing findings.
"""

from __future__ import annotations

import difflib
import importlib.util
import sys
from pathlib import Path
from typing import List, Optional

from .core import Finding, Project, rule

SNAPSHOT_REL = Path("docs") / "api_surface_torch.txt"
RENDERER_REL = Path("scripts") / "api_surface_torch.py"


def _load_renderer(repo_root: Path):
    spec = importlib.util.spec_from_file_location(
        "_popcheck_api_surface_torch", repo_root / RENDERER_REL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def render_surface(repo_root: Path) -> Optional[str]:
    renderer = repo_root / RENDERER_REL
    if not renderer.exists():
        return None
    src = str(repo_root / "src")
    added = src not in sys.path
    if added:
        sys.path.insert(0, src)
    try:
        return _load_renderer(repo_root).render()
    finally:
        if added and src in sys.path:
            sys.path.remove(src)


def diff_surface(repo_root: Path,
                 snapshot_path: Optional[Path] = None) -> List[Finding]:
    """The api-drift comparison, parameterised for tests: diff a fresh
    render against ``snapshot_path`` (default: the committed snapshot)."""
    snapshot_path = snapshot_path or repo_root / SNAPSHOT_REL
    if not snapshot_path.exists():
        return []
    fresh = render_surface(repo_root)
    if fresh is None:
        return []
    committed = snapshot_path.read_text()
    if fresh == committed:
        return []
    delta = [l for l in difflib.unified_diff(
        committed.splitlines(), fresh.splitlines(),
        SNAPSHOT_REL.as_posix(), "live surface", lineterm="", n=0)
        if l.startswith(("+", "-")) and not l.startswith(("+++", "---"))]
    head = "; ".join(delta[:6]) + (" ..." if len(delta) > 6 else "")
    return [Finding(
        "api-drift", SNAPSHOT_REL.as_posix(), 1,
        f"public API surface drifted from the committed snapshot "
        f"({len(delta)} line(s)): {head} — intentional changes run "
        "`scripts/api_surface_torch.py --write` and commit the diff")]


@rule("api-drift")
def check_api_drift(project: Project) -> List[Finding]:
    if project.repo_root is None:
        return []
    root = Path(project.repo_root)
    if not (root / RENDERER_REL).exists() or \
            not (root / SNAPSHOT_REL).exists():
        return []
    return diff_surface(root)
