"""The result line's shape, the benchmark's file against its contract,
and the run's refusal without a card."""

import json
import re
import subprocess
import sys

import pytest

from popbench_tiny import CELL, ROOT, run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_shape(trace):
    out = run(seconds=0.5, trace=trace)["result"]
    keys = list(out)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    want = {m["name"] for m in spec()["end_to_end" if not trace
                                      else "per_layer"]}
    for name, m in out["metrics"].items():
        assert name in want and set(m) == {"value", "unit"}
    if trace:
        assert {"busy_s", "window_s", } <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"host_prep_s", "iters_per_step",
                "ms_per_iter"} <= set(out["metrics"])
    else:
        assert set(out["metrics"]) == want
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out)


def test_benchmark_file_keeps_its_contract():
    s = spec()
    assert list(s) == ["command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"]
    assert s["paths"] == ["popbench"] and s["command"][1] == "popbench/run.py"
    assert 1 <= s["run_seconds"] <= 51
    configs = {c["name"]: c for c in s["configs"]}
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith(
            "popbench/")
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c[
            "name"]
    names = [w["name"] for w in s["workloads"]]
    assert names == [CELL]
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1
        assert len(w["why"]) <= 200
        assert (ROOT / "popbench" / "traffic" /
                f"{w['traffic']}.json").is_file()
        assert (ROOT / "popbench" / "limits" / f"{w['name']}.json").is_file()
    e2e = {m["name"]: m for m in s["end_to_end"]}
    assert set(e2e) == {"step_s", "step_p90_s", "setup_s"}
    for m in s["end_to_end"] + s["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in s["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    for m in s["per_layer"]:
        assert m["moves"] == "step_s" and set(m["workloads"]) <= set(names)
        assert (ROOT / "popbench" / "metrics" / f"{m['name']}.py").is_file()
    assert len(json.dumps(s)) < 64 * 1024


def test_run_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    p = subprocess.run([sys.executable, "popbench/run.py", "--workload",
                        CELL, "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA" in p.stderr


def test_run_refuses_without_the_program(tmp_path):
    import shutil
    shutil.copytree(ROOT / "popbench", tmp_path / "popbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    p = subprocess.run([sys.executable, "popbench/run.py", "--workload",
                        CELL, "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120,
                       env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert p.returncode != 0 and p.stdout == ""
