"""popcheck rule framework of the port: findings, suppressions, baselines,
the runner — a copy of ``repro/analysis/core.py`` (the port imports
nothing of the reference), scanning the port's roots and holding CUDA
sources (``.cu``/``.cuh``) as text for the CUDA rule.

A *rule* is a function ``rule(project) -> list[Finding]`` registered under
a kebab-case name via :func:`rule`.  The :class:`Project` hands every rule
the parsed ASTs, per-module import-alias tables and source lines of the
scanned files, so rules stay small and declarative.

Suppression syntax (checked per finding line):

``# popcheck: disable=<rule>[,<rule>...]``
    on (or immediately above) the offending line silences those rules for
    that line.  ``disable=all`` silences everything.
``# popcheck: disable-file=<rule>[,<rule>...]``
    anywhere in a file silences those rules for the whole file.

Baselines: :func:`write_baseline` snapshots the surviving findings as
stable fingerprints (rule + path + message — line numbers excluded so
unrelated edits don't churn the file); :func:`run_popcheck` subtracts a
loaded baseline so only NEW findings fail
(``scripts/popcheck_torch.py --baseline`` / ``scripts/popcheck_torch.py``).
"""

from __future__ import annotations

import ast
import dataclasses
import json
import re
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence

__all__ = [
    "Finding", "FileContext", "Project", "RULES", "rule",
    "run_popcheck", "load_baseline", "write_baseline", "DEFAULT_SCAN_DIRS",
]

# what scripts/popcheck_torch.py scans by default, relative to repo root
DEFAULT_SCAN_DIRS = ("src/repro_torch", "examples_torch", "chip_smoke.py")

# source suffixes a scan collects: Python, and CUDA C++ held as text
PY_SUFFIXES = (".py",)
CUDA_SUFFIXES = (".cu", ".cuh")

_SUPPRESS_RE = re.compile(r"#\s*popcheck:\s*disable=([\w\-,]+)")
_SUPPRESS_FILE_RE = re.compile(r"#\s*popcheck:\s*disable-file=([\w\-,]+)")
_HOT_RE = re.compile(r"#\s*popcheck:\s*hot\b")
_VIA_RE = re.compile(r" \[hot via [^\]]*\]$")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str
    path: str      # repo-relative, '/'-separated
    line: int
    message: str

    def fingerprint(self) -> str:
        """Line-number-free identity used by baseline files, so editing an
        unrelated part of a module does not churn the baseline; a trailing
        ``[hot via ...]`` call chain is left out too, for the same
        reason."""
        return f"{self.rule}::{self.path}::{_VIA_RE.sub('', self.message)}"

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


class FileContext:
    """One source file plus the lookup tables rules need: a Python file
    parsed (``tree``), a CUDA source held as text (``is_cuda``, no
    ``tree``)."""

    def __init__(self, path: Path, rel: str, text: str):
        self.path = path
        self.rel = rel
        self.text = text
        self.lines = text.splitlines()
        self.tree: Optional[ast.AST] = None
        self.parse_error: Optional[str] = None
        self.is_cuda = Path(rel).suffix in CUDA_SUFFIXES
        if not self.is_cuda:
            try:
                self.tree = ast.parse(text)
            except SyntaxError as e:  # surfaced as a finding by the runner
                self.parse_error = (f"syntax error: {e.msg} "
                                    f"(line {e.lineno})")
        # module-alias tables: local name -> dotted module / origin
        self.module_aliases: Dict[str, str] = {}   # np -> numpy, pop -> repro_torch.core.pop
        self.imported_names: Dict[str, str] = {}   # pop_solve -> repro_torch.core.pop.pop_solve
        if self.tree is not None:
            self._index_imports()
        self.file_suppressed = set()
        for m in _SUPPRESS_FILE_RE.finditer(text):
            self.file_suppressed.update(m.group(1).split(","))
        # per-line suppressions: line -> set of rule names (or {"all"})
        self.line_suppressed: Dict[int, set] = {}
        for i, line in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(line)
            if m:
                self.line_suppressed[i] = set(m.group(1).split(","))
        self.hot_marker_lines = {
            i for i, line in enumerate(self.lines, start=1)
            if _HOT_RE.search(line)}

    def _index_imports(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.module_aliases[a.asname or a.name.split(".")[0]] = \
                        a.name
            elif isinstance(node, ast.ImportFrom) and node.module:
                base = node.module
                for a in node.names:
                    local = a.asname or a.name
                    # "from repro_torch.core import pop" imports a MODULE; track
                    # it in both tables (rules resolve either way)
                    self.module_aliases.setdefault(local,
                                                   f"{base}.{a.name}")
                    self.imported_names[local] = f"{base}.{a.name}"

    def resolve(self, node: ast.AST) -> str:
        """The dotted name an ``alias.a.b`` expression stands for, its
        leading name resolved through the file's imports
        (``torch.cuda.synchronize``), or "" when the chain does not start
        at an imported name."""
        attrs = []
        while isinstance(node, ast.Attribute):
            attrs.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return ""
        base = (self.module_aliases.get(node.id)
                or self.imported_names.get(node.id, ""))
        return ".".join([base, *reversed(attrs)]) if base else ""

    def suppressed(self, rule_name: str, line: int) -> bool:
        if rule_name in self.file_suppressed or "all" in self.file_suppressed:
            return True
        for ln in (line, line - 1):   # same line or the line above
            rules = self.line_suppressed.get(ln)
            if rules and (rule_name in rules or "all" in rules):
                return True
        return False


class Project:
    """The scanned file set handed to every rule."""

    def __init__(self, files: Sequence[FileContext],
                 repo_root: Optional[Path] = None):
        self.files = list(files)
        self.repo_root = repo_root

    @classmethod
    def from_paths(cls, paths: Iterable[Path],
                   repo_root: Optional[Path] = None) -> "Project":
        root = Path(repo_root) if repo_root else None
        files = []
        for p in sorted(set(Path(p) for p in paths)):
            if p.is_dir():
                todo = sorted(f for f in p.rglob("*")
                              if f.suffix in PY_SUFFIXES + CUDA_SUFFIXES
                              and f.is_file())
            else:
                todo = [p]
            for f in todo:
                rel = (f.relative_to(root) if root and f.is_relative_to(root)
                       else f)
                files.append(FileContext(f, rel.as_posix(),
                                         f.read_text(encoding="utf-8")))
        return cls(files, repo_root=root)

    def in_dir(self, fragment: str) -> List[FileContext]:
        """Files whose repo-relative path contains ``fragment`` as a
        path component (e.g. ``"kernels"``)."""
        return [f for f in self.files if fragment in Path(f.rel).parts]


Rule = Callable[[Project], List[Finding]]

RULES: Dict[str, Rule] = {}


def rule(name: str) -> Callable[[Rule], Rule]:
    def deco(fn: Rule) -> Rule:
        fn.rule_name = name
        RULES[name] = fn
        return fn
    return deco


# --------------------------------------------------------------------------
# baseline snapshots
# --------------------------------------------------------------------------

def write_baseline(findings: Sequence[Finding], path: Path) -> None:
    counts: Dict[str, int] = {}
    for f in findings:
        counts[f.fingerprint()] = counts.get(f.fingerprint(), 0) + 1
    payload = {
        "comment": "popcheck suppression baseline of the port — "
                   "regenerate with `scripts/popcheck_torch.py --baseline`; "
                   "entries are known findings that do not fail "
                   "`scripts/popcheck_torch.py`, each with its reason in "
                   "docs/LINTS_torch.md",
        "findings": [{"fingerprint": fp, "count": n}
                     for fp, n in sorted(counts.items())],
    }
    path.write_text(json.dumps(payload, indent=2) + "\n")


def load_baseline(path: Path) -> Dict[str, int]:
    if not Path(path).exists():
        return {}
    data = json.loads(Path(path).read_text())
    return {e["fingerprint"]: int(e.get("count", 1))
            for e in data.get("findings", [])}


def apply_baseline(findings: Sequence[Finding],
                   baseline: Dict[str, int]) -> List[Finding]:
    budget = dict(baseline)
    fresh = []
    for f in findings:
        fp = f.fingerprint()
        if budget.get(fp, 0) > 0:
            budget[fp] -= 1
        else:
            fresh.append(f)
    return fresh


# --------------------------------------------------------------------------
# runner
# --------------------------------------------------------------------------

def run_popcheck(paths: Iterable[Path],
                 rules: Optional[Iterable[str]] = None,
                 baseline: Optional[Dict[str, int]] = None,
                 repo_root: Optional[Path] = None) -> List[Finding]:
    """Scan ``paths`` with the named rules (default: all registered),
    drop suppressed findings, subtract ``baseline``, and return the rest
    sorted by location."""
    project = Project.from_paths(paths, repo_root=repo_root)
    findings: List[Finding] = []
    for f in project.files:
        if f.parse_error:
            findings.append(Finding("parse-error", f.rel, 1, f.parse_error))
    selected = list(rules) if rules is not None else sorted(RULES)
    for name in selected:
        if name not in RULES:
            raise ValueError(f"unknown popcheck rule {name!r}; registered: "
                             f"{sorted(RULES)}")
        for found in RULES[name](project):
            ctx = next((f for f in project.files if f.rel == found.path),
                       None)
            if ctx is not None and ctx.suppressed(found.rule, found.line):
                continue
            findings.append(found)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    if baseline:
        findings = apply_baseline(findings, baseline)
    return findings
