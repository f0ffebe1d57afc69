"""A rehearsal of ``tools/across_cards.py`` on the CPU: its four rank
bodies on four gloo processes under a ``torchrun``-style environment, at
reduced sizes, and its checks on what they report.

The sizes: a 512-job Gavel session (128 accelerators of each type)
through ``shard_map`` on the four ranks and through ``vmap`` and ``pmap``
(over four CPU "devices") in this process; reduced llama3-8b served (4
sequences, a 32-slot cache) and trained (4 x 8 tokens, one layer for the
cut comparison, two for the checkpoint).  The CPU has no card, so the
rehearsal stubs what reads one (CUDA events become a host clock, the
memory readings 0) and skips the lane kernels' launch counts and their
comparison with the plain versions, which need the card.  The checks are
the tool's own: the backends bit-equal to ``vmap``, every split serving
step within ``testing.bf16_logit_tol``, finite and equal losses on every
rank, the split train step within ``bf16_logit_tol`` of the unsharded
one, the restored step bit-equal."""

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
TOOL = ROOT / "tools" / "across_cards.py"
RUN_TIMEOUT_S = 600

CHILD = r"""
import sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import test_torch_across_cards as t
ac = t.rehearsal(sys.argv[3])
sys.exit(ac.rank_main("cpu"))
"""


class HostEvent:
    """``torch.cuda.Event`` on the host clock."""

    def __init__(self, enable_timing=True):
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def _stubs():
    """``(object, name, value)`` of everything that reads a card."""
    def nothing(*a, **k):
        return None

    def zero(*a, **k):
        return 0

    return [(torch.cuda, "Event", HostEvent),
            (torch.cuda, "synchronize", nothing),
            (torch.cuda, "empty_cache", nothing),
            (torch.cuda, "reset_peak_memory_stats", nothing),
            (torch.cuda, "max_memory_allocated", zero),
            (torch.cuda, "memory_allocated", zero)]


def _reductions(work):
    """``(object, name, value)`` of the reduced sizes."""
    sys.path[:0] = [str(ROOT / "tools"), str(ROOT), str(ROOT / "src")]
    import across_cards as ac
    import chip_smoke
    from repro_torch import configs
    from repro_torch.launch import serve, train
    return ac, [(configs, "get_config", configs.get_reduced),
                (train, "get_config", configs.get_reduced),
                (serve, "get_config", configs.get_reduced),
                (ac, "N_JOBS", 512), (ac, "NUM_WORKERS", (128, 128, 128)),
                (ac, "TRAIN_BATCH", 4), (ac, "TRAIN_SEQ", 8),
                (ac, "CUT_LAYERS", 1), (ac, "WORK", Path(work)),
                (chip_smoke, "SERVE_BATCH", 4),
                (chip_smoke, "SERVE_MAX_SEQ", 32)]


def rehearsal(work):
    """In a rank's process: the stubs and the reduced sizes; returns the
    tool's module."""
    ac, sizes = _reductions(work)
    for obj, name, value in _stubs() + sizes:
        setattr(obj, name, value)
    torch.set_num_threads(1)
    return ac


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def cards(tmp_path_factory):
    """``(tool module, reports of the four ranks, vmap and pmap in this
    process)``."""
    work = tmp_path_factory.mktemp("across_cards")
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE="4",
               LOCAL_WORLD_SIZE="4", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", CHILD, str(HERE), str(ROOT / "src"),
         str(work)], env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(4)]
    try:
        logs = [p.communicate(timeout=RUN_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, text in zip(procs, logs):
        assert p.returncode == 0, text[-4000:]
    with pytest.MonkeyPatch.context() as mp:
        ac, sizes = _reductions(work)
        for obj, name, value in _stubs() + sizes:
            mp.setattr(obj, name, value)
        reports = [torch.load(work / f"rank{r}.pt", weights_only=False)
                   for r in range(4)]
        one = ac.pop_one_process(torch.device("cpu"),
                                 {"devices": ("cpu",) * 4})
        yield ac, reports, one, mp


def _verdicts(cards):
    ac, reports, one, _ = cards
    return ac.Verdicts(reports, one, "the CPU (a rehearsal)", on_card=False)


def test_cards_pop_backends_bit_equal_to_vmap(cards):
    """``shard_map`` on each rank (2 lanes a rank; and at ``chunk=1``) and
    ``pmap`` over four devices: each step bit-equal to ``vmap``'s."""
    _verdicts(cards).pop()
    _, reports, one, _ = cards
    # each slice led by copies of its first lane up to its place modulo
    # backends.LANE_PHASE (4): rank r's lanes start at 2 r
    for r, rep in enumerate(reports):
        assert rep["cards-pop"]["shard_map"]["lanes"][0] == 2 + 2 * r % 4
        assert rep["cards-pop"]["shard_map chunk=1"]["lanes"][:2] == [
            1 + 2 * r % 4, 1 + (2 * r + 1) % 4]
    assert one["pmap"]["devices"] == ["cpu"]


def test_cards_serve_within_bf16_tolerance(cards):
    _verdicts(cards).serve()


def test_cards_train_split_matches_one_device(cards):
    _verdicts(cards).train()


def test_cards_ckpt_restored_step_bit_equal(cards):
    _verdicts(cards).ckpt()
    _, reports, _, _ = cards
    assert reports[0]["cards-ckpt"]["ckpt_bytes"] > 0


def test_refuses_without_four_cards():
    """No card here: the tool exits 2 and prints no result."""
    proc = subprocess.run([sys.executable, str(TOOL)], capture_output=True,
                          text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 2
    assert proc.stdout == ""
    assert "needs 4 CUDA devices, found 0" in proc.stderr


DRIVER = r"""
import sys
sys.path[:0] = [sys.argv[1]]
import torch
torch.set_num_threads(1)
from repro_torch.launch import train
_, _, m = train.main(["--arch", "llama3_8b", "--reduced", "--steps", "1",
                      "--batch", "2", "--seq", "8", "--device", "cpu",
                      "--mesh", "1x2"])
print("LOSS", float(m["loss"]))
"""


def test_train_driver_starts_its_group_from_a_torchrun_environment():
    """``launch.train --mesh 1x2`` in two processes that have no process
    group, only ``RANK``/``LOCAL_RANK``/``WORLD_SIZE``/``MASTER_ADDR``/
    ``MASTER_PORT``: ``mesh_for`` starts the group itself (gloo on the
    CPU), and both ranks finish with the same finite loss."""
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE="2",
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", DRIVER, str(ROOT / "src")],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        logs = [p.communicate(timeout=RUN_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    losses = []
    for p, text in zip(procs, logs):
        assert p.returncode == 0, text[-4000:]
        assert "on a 1x2 mesh" in text
        losses.append(float(text.split("LOSS ")[1].split()[0]))
    assert losses[0] == losses[1] and np.isfinite(losses[0])
