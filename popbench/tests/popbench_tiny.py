"""A small configuration of the benchmark's cell for the CPU tests: the
cell's own file with the fleet and the iteration cap cut down, every
width kept.  Runs use one CPU thread (as ``popbench/run.py`` does): the
solve loop's small ops in many threads, beside the other test workers,
stall on the thread pool."""

from __future__ import annotations

import contextlib
import copy
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

CELL = "gavel-16k.drift"


def config() -> dict:
    cfg = json.loads((ROOT / "popbench" / "configs" / "gavel-16k.json")
                     .read_text())
    cfg = copy.deepcopy(cfg)
    cfg.update(n_jobs=256, num_workers=[64, 64, 64], traced_steps=1)
    cfg["solver"] = dict(cfg["solver"], max_iters=5000)
    return cfg


@contextlib.contextmanager
def one_thread():
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def run(seed: int = 2**31 + 5, seconds: float = 0.5, trace: bool = False,
        hooks=None, cfg=None) -> dict:
    import time

    from popbench import run as run_mod
    spec = run_mod.load_spec()
    with one_thread():
        return run_mod.run_cell(spec, CELL, seed, seconds, trace,
                                device="cpu", config=cfg or config(),
                                t0=time.perf_counter(), hooks=hooks)
