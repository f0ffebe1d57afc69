"""The port's popcheck suite (``repro_torch.analysis``), the twin of
``tests/test_popcheck.py``: every rule is pinned by a known-bad fixture
(fires) and a good twin (silent) under ``tests/fixtures/popcheck_torch/``,
where a rule carries over with the reference's count of findings; plus
suppression syntax, baseline round-trips, api-drift diffing, the CUDA
rule's silence on the integer ticket of ``pdhg_matvec.cu``, and the gate
``scripts/popcheck_torch.py`` enforces on the port's tree."""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import RULES as REF_RULES
from repro_torch.analysis import RULES, run_popcheck
from repro_torch.analysis.core import (DEFAULT_SCAN_DIRS, Finding,
                                       apply_baseline, load_baseline,
                                       write_baseline)
from repro_torch.analysis.surface import diff_surface

REPO_ROOT = Path(__file__).resolve().parent.parent
FIXTURES = REPO_ROOT / "tests" / "fixtures" / "popcheck_torch"
BASELINE = REPO_ROOT / "popcheck_torch_baseline.json"
LINTS = REPO_ROOT / "docs" / "LINTS_torch.md"

# (rule, bad fixture, good twin, findings expected on the bad file); a
# rule the reference has keeps its count (tests/test_popcheck.py), the
# counterpart of pallas-no-scatter keeps that rule's on the Python scatters
CASES = [
    ("host-sync-in-hot-path", "host_sync_bad.py", "host_sync_good.py", 6),
    ("retrace-hazard", "retrace_bad.py", "retrace_good.py", 3),
    ("retrace-hazard", "retrace_graph_bad.py", "retrace_graph_good.py", 4),
    ("cuda-no-float-atomics", "kernels/scatter_bad.py",
     "kernels/scatter_good.py", 2),
    ("cuda-no-float-atomics", "kernels/csrc/atomics_bad.cu",
     "kernels/csrc/atomics_good.cu", 3),
    ("deprecated-door", "deprecated_bad.py", "deprecated_good.py", 3),
    ("dtype-promotion", "kernels/dtype_bad.py", "kernels/dtype_good.py", 4),
    ("registry-contract", "registry_bad.py", "registry_good.py", 3),
    ("config-hashability", "confighash_bad.py", "confighash_good.py", 3),
    ("silent-except", "silent_except_bad.py", "silent_except_good.py", 3),
    ("profile-staleness", "profile_bad.py", "profile_good.py", 3),
]
IDS = [f"{c[0]}:{Path(c[1]).stem}" for c in CASES]

# the reference's rules without a counterpart, and why (docs/LINTS_torch.md)
NO_COUNTERPART = {"pallas-vmem-budget", "pallas-block-align"}
RENAMED = {"pallas-no-scatter": "cuda-no-float-atomics"}


def _scan(rel, rule):
    return run_popcheck([FIXTURES / rel], rules=[rule])


class TestRuleFixtures:
    @pytest.mark.parametrize("rule,bad,good,n_bad", CASES, ids=IDS)
    def test_fires_on_bad_silent_on_good(self, rule, bad, good, n_bad):
        bad_findings = _scan(bad, rule)
        assert len(bad_findings) == n_bad, \
            [f.render() for f in bad_findings]
        assert all(f.rule == rule for f in bad_findings)
        assert all(f.line > 0 and f.message for f in bad_findings)
        assert _scan(good, rule) == []

    def test_every_registered_rule_is_pinned(self):
        pinned = {c[0] for c in CASES} | {"api-drift"}
        assert pinned == set(RULES)

    def test_every_reference_rule_has_its_counterpart(self):
        """Each of the reference's rules is registered here under its own
        name or its counterpart's, or is one of the two TPU tiling rules
        the catalog explains."""
        assert len(REF_RULES) == 12
        mapped = {RENAMED.get(r, r) for r in REF_RULES} - NO_COUNTERPART
        assert mapped == set(RULES)
        catalog = LINTS.read_text()
        for name in REF_RULES:
            assert f"`{name}`" in catalog, name

    @pytest.mark.parametrize("rule,bad,good,n_bad", CASES, ids=IDS)
    def test_rules_are_cross_silent(self, rule, bad, good, n_bad):
        # a bad fixture for rule A must not trip unrelated rule B
        others = sorted(set(RULES) - {rule, "api-drift"})
        stray = run_popcheck([FIXTURES / bad], rules=others)
        assert stray == [], [f.render() for f in stray]

    def test_unknown_rule_rejected(self):
        with pytest.raises(ValueError, match="unknown popcheck rule"):
            run_popcheck([FIXTURES], rules=["not-a-rule"])

    def test_integer_ticket_is_an_election_not_a_sum(self, tmp_path):
        """``pdhg_matvec.cu``'s ``last_to_arrive`` takes an ``atomicAdd`` on
        an unsigned ticket: the rule reads its type and stays silent, on
        the very line."""
        src = (REPO_ROOT / "src" / "repro_torch" / "kernels" / "csrc"
               / "pdhg_matvec.cu")
        line = next(i for i, ln in enumerate(src.read_text().splitlines(), 1)
                    if "atomicAdd(ticket" in ln)
        assert run_popcheck([src], rules=["cuda-no-float-atomics"]) == []
        # the same call on a float target fires, on the same line
        text = src.read_text().replace("unsigned* ticket", "float* ticket")
        copy = tmp_path / "float_ticket.cu"
        copy.write_text(text)
        got = run_popcheck([copy], rules=["cuda-no-float-atomics"])
        assert [f.line for f in got] == [line]


class TestSuppression:
    def test_suppressed_file_scans_clean(self):
        # same patterns as host_sync_bad, silenced inline and line-above
        assert run_popcheck([FIXTURES / "suppressed.py"]) == []

    def test_suppression_is_rule_scoped(self, tmp_path):
        """A disable comment naming one rule leaves every other rule
        reporting on that line."""
        src = (FIXTURES / "kernels" / "dtype_bad.py").read_text()
        (tmp_path / "kernels").mkdir()
        silenced = tmp_path / "kernels" / "dtype_bad.py"
        silenced.write_text(src.replace(
            "# BAD: f64 accum",
            "# popcheck: disable=host-sync-in-hot-path"))
        assert len(run_popcheck([silenced], rules=["dtype-promotion"])) == 4
        # the comment covers its own line and the next: three findings go
        silenced.write_text(src.replace(
            "# BAD: f64 accum", "# popcheck: disable=dtype-promotion"))
        assert len(run_popcheck([silenced], rules=["dtype-promotion"])) == 1


class TestBaseline:
    def test_roundtrip_swallows_known_findings(self, tmp_path):
        findings = _scan("host_sync_bad.py", "host-sync-in-hot-path")
        assert findings
        path = tmp_path / "baseline.json"
        write_baseline(findings, path)
        baseline = load_baseline(path)
        assert run_popcheck([FIXTURES / "host_sync_bad.py"],
                            rules=["host-sync-in-hot-path"],
                            baseline=baseline) == []

    def test_baseline_is_count_budgeted(self):
        f = Finding("r", "p.py", 3, "msg")
        twice = [f, Finding("r", "p.py", 9, "msg")]
        assert apply_baseline(twice, {f.fingerprint(): 1}) == [twice[1]]

    def test_fingerprint_leaves_out_the_call_chain(self):
        a = Finding("host-sync-in-hot-path", "p.py", 3,
                    "in f: .item() [hot via root -> f]")
        b = Finding("host-sync-in-hot-path", "p.py", 7,
                    "in f: .item() [hot via other -> g -> f]")
        assert a.fingerprint() == b.fingerprint()

    def test_missing_baseline_loads_empty(self, tmp_path):
        assert load_baseline(tmp_path / "nope.json") == {}


class TestApiDrift:
    def test_clean_against_committed_snapshot(self):
        assert diff_surface(REPO_ROOT) == []

    def test_fires_on_stale_snapshot(self, tmp_path):
        snap = REPO_ROOT / "docs" / "api_surface_torch.txt"
        stale = tmp_path / "api_surface_torch.txt"
        stale.write_text(snap.read_text() +
                         "repro_torch.bogus.vanished_function(x)\n")
        findings = diff_surface(REPO_ROOT, snapshot_path=stale)
        assert len(findings) == 1
        assert findings[0].rule == "api-drift"
        assert "vanished_function" in findings[0].message


def _catalog_rows():
    """The baselined findings' table of docs/LINTS_torch.md: {fingerprint:
    (by design?, reason)}."""
    rows = {}
    for ln in LINTS.read_text().splitlines():
        m = re.match(r"\|\s*`` (.+::.+) ``\s*\|\s*(yes|no)\s*\|(.+)\|\s*$",
                     ln)
        if m:
            rows[m.group(1)] = (m.group(2) == "yes", m.group(3).strip())
    return rows


class TestRepoClean:
    def test_tree_scans_clean_modulo_baseline(self):
        findings = run_popcheck(
            [REPO_ROOT / d for d in DEFAULT_SCAN_DIRS],
            baseline=load_baseline(BASELINE), repo_root=REPO_ROOT)
        assert findings == [], "\n".join(f.render() for f in findings)

    def test_every_baselined_finding_has_its_reason(self):
        """Each entry of popcheck_torch_baseline.json stands in the
        catalog's table with a reason, and the table lists nothing else."""
        data = json.loads(BASELINE.read_text())
        baselined = {e["fingerprint"] for e in data["findings"]}
        rows = _catalog_rows()
        assert set(rows) == baselined
        assert all(len(reason) > 20 for _, reason in rows.values())

    def test_script_flags(self, tmp_path):
        """``--list-rules``, ``--rules``, ``--no-baseline`` (the baselined
        findings and nothing else) and the default gate (exit 0)."""
        script = REPO_ROOT / "scripts" / "popcheck_torch.py"

        def run(*args):
            return subprocess.run([sys.executable, str(script), *args],
                                  capture_output=True, text=True,
                                  timeout=300, cwd=REPO_ROOT)
        listed = run("--list-rules")
        assert listed.returncode == 0
        assert listed.stdout.split() == sorted(RULES)
        gate = run("--rules", "host-sync-in-hot-path,cuda-no-float-atomics")
        assert gate.returncode == 0, gate.stdout + gate.stderr
        everything = run("--no-baseline", "--rules",
                         "host-sync-in-hot-path,cuda-no-float-atomics")
        assert everything.returncode == 1, (everything.stdout
                                            + everything.stderr)
        shown = [ln for ln in everything.stdout.splitlines()
                 if re.match(r"\S+:\d+: \[", ln)]
        n_baselined = sum(e["count"] for e in json.loads(
            BASELINE.read_text())["findings"])
        assert len(shown) == n_baselined
        bad = run(str(FIXTURES / "host_sync_bad.py"), "--rules",
                  "host-sync-in-hot-path")
        assert bad.returncode == 1 and "6 new finding(s)" in bad.stdout
