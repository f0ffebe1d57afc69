"""The harness grows by data: a new configuration, traffic mix, per-layer
metric and cell are new files and new entries of ``BENCHMARK.json``, and
run with no file of the harness edited."""

import hashlib
import json
import shutil
import subprocess
import sys

from popbench_tiny import ROOT

NEW_METRIC = '''"""Steps the window held (a test reader)."""


def read(run):
    return float(len(run.steps)) if run.steps else None
'''


def digests(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(
        p.read_bytes()).hexdigest()
        for p in sorted(root.rglob("*")) if p.is_file()
        and "__pycache__" not in p.parts}


def test_a_cell_is_added_by_new_files_only(tmp_path):
    shutil.copytree(ROOT / "popbench", tmp_path / "popbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "src").symlink_to(ROOT / "src")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = digests(tmp_path / "popbench")

    cfg = json.loads((ROOT / "popbench/configs/gavel-16k.json").read_text())
    cfg.update(name="gavel-tiny", n_jobs=128, num_workers=[32, 32, 32],
               traced_steps=1)
    pb = tmp_path / "popbench"
    (pb / "configs" / "gavel-tiny.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "steady.json").write_text(json.dumps(
        {"name": "steady", "churn": 0.0, "churn_every": 0}))
    (pb / "metrics" / "window_steps.py").write_text(NEW_METRIC)
    (pb / "limits" / "gavel-tiny.steady.json").write_text(json.dumps(
        json.loads((pb / "limits" / "gavel-16k.drift.json").read_text())))
    spec["configs"].append({"name": "gavel-tiny", "source": "a test",
                            "file": "popbench/configs/gavel-tiny.json",
                            "reduced": ["n_jobs", "num_workers"]})
    spec["workloads"].append({"name": "gavel-tiny.steady",
                              "config": "gavel-tiny", "traffic": "steady",
                              "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "window_steps", "unit": "steps",
                              "better": "higher",
                              "source": "program_counter",
                              "layer": "session and preparation",
                              "moves": "step_s",
                              "workloads": ["gavel-tiny.steady"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    code = (
        "import sys, json, time, torch\n"
        "torch.set_num_threads(1)\n"
        f"sys.path[:0] = [{str(tmp_path)!r}, {str(tmp_path / 'src')!r}]\n"
        "from popbench import run\n"
        "assert run.HERE.parent.as_posix() == sys.path[0]\n"
        "out = run.run_cell(run.load_spec(), 'gavel-tiny.steady', 3, 0.3,"
        " True, device='cpu', t0=time.perf_counter())\n"
        "print(json.dumps(out['result']))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["metrics"]["window_steps"]["value"] >= 1
    after = digests(tmp_path / "popbench")
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {
        "configs/gavel-tiny.json", "traffic/steady.json",
        "metrics/window_steps.py", "limits/gavel-tiny.steady.json"}
