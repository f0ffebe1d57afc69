"""The port's dry run (``repro_torch.launch.dryrun``), roofline and flags
harness on the CPU: every cell runs one step on meta tensors under a fake
process group.

Reduced configs on a fake 2 x 2 mesh run each of the train, prefill and
decode steps; the per-device FLOPs the dry run counts equal those of the
unsharded step on one rank's rows (the sharded steps gather parameters,
which costs no FLOPs, and compute on local rows), counted by the same
``FlopCounterMode``.  Full-size llama3-8b runs its decode_32k and
prefill_32k cells on the fake 16 x 16 mesh (its train_4k cell takes about
20 s alone here, so it is left to the CLI).  A cell that fails names the
op that raised.  The fake group is torn down after the module, so no
other test of this worker sees it."""

import json

import pytest
import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.launch import dryrun, perf, roofline
from repro_torch.launch import specs as sp
from repro_torch.models import transformer as tf
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.train_step import TrainConfig, make_train_step

CELLS = {"train": sp.ShapeCell("t", 16, 8, "train"),
         "prefill": sp.ShapeCell("p", 32, 4, "prefill"),
         "decode": sp.ShapeCell("d", 64, 4, "decode")}


@pytest.fixture(scope="module", autouse=True)
def no_group_after():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _unsharded_flops(cfg, cell, rows: int, n_micro: int) -> float:
    """FLOPs of the unsharded step on ``rows`` rows (meta tensors)."""
    params = sp.params_shape(cfg)
    batch = {k: v[:rows] for k, v in sp.batch_specs(cfg, cell).items()}
    with FlopCounterMode(display=False) as fc:
        if cell.kind == "train":
            make_train_step(cfg, TrainConfig(n_microbatches=n_micro))(
                params, opt_mod.init_state(params), batch)
        else:
            with torch.no_grad():
                tf.forward_train(params, cfg, batch["tokens"],
                                 enc_embeddings=batch.get("enc_embeddings"),
                                 remat=False)
    return float(fc.get_total_flops())


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_reduced_cells_on_a_fake_2x2_mesh(arch, kind):
    cfg = get_reduced(arch)
    r = dryrun.run_cell(arch, kind, False, cfg=cfg, mesh_shape=(2, 2),
                        cell=CELLS[kind])
    assert r["status"] == "ok", r.get("trace")
    assert r["chips"] == 4 and r["n_dp"] == 2
    assert r["flops"] > 0 and r["bytes_accessed"] > 0
    coll = r["collectives"]
    assert coll["count"] > 0 and coll["all-gather"] > 0
    assert r["probes"]["flops_per_device"] == r["flops"]
    if kind != "decode":
        n_micro = r["probes"]["n_micro"]
        assert r["flops"] == _unsharded_flops(
            cfg, CELLS[kind], CELLS[kind].global_batch // 2, n_micro)


@pytest.mark.parametrize("shape", ["decode_32k", "prefill_32k"])
def test_full_llama_cell_on_the_production_mesh(shape):
    r = dryrun.run_cell("llama3_8b", shape, False)
    assert r["status"] == "ok", r.get("trace")
    assert (r["chips"], r["n_dp"]) == (256, 16)
    assert r["params_total"] == get_config("llama3_8b").param_count()
    # every rank gathers the 32 periods' blocks over "model" at least once
    assert r["collectives"]["all-gather"] > 0
    cell = sp.SHAPES[shape]
    rows = cell.global_batch // 16
    assert r["mem_argument_size_in_bytes"] > 4 * r["params_total"] / 16
    assert r["flops"] > 2 * (r["params_active"] - r["params_embed"]) * rows \
        * (cell.seq_len if cell.kind == "prefill" else 1)


def test_skipped_cell_keeps_the_reference_reason():
    r = dryrun.run_cell("llama3_8b", "long_500k", False)
    assert r["status"] == "skipped" and "DESIGN.md" in r["reason"]


def test_failing_cell_names_the_op(monkeypatch):
    from repro_torch.models import layers

    def broken(p, x, eps=1e-6):
        return x @ torch.empty((3, 5), device=x.device)
    monkeypatch.setattr(layers, "rmsnorm", broken)
    monkeypatch.setattr(tf, "rmsnorm", broken)
    r = dryrun.run_cell("llama3_8b", "decode", False,
                        cfg=get_reduced("llama3_8b"), mesh_shape=(2, 2),
                        cell=CELLS["decode"])
    assert r["status"] == "error"
    assert r["op"] is not None and "aten." in r["op"]
    assert "RuntimeError" in r["error"]


def test_cli_writes_cells_and_roofline_reads_them(tmp_path, capsys):
    """``main`` writes one JSON per cell (a cached cell is not run again);
    the roofline prints its tables with the H100 constants."""
    argv = ["--arch", "xlstm_350m", "--shape", "decode_32k", "--mesh",
            "single", "--out", str(tmp_path)]
    assert dryrun.main(argv) == 0
    path = tmp_path / "single" / "xlstm_350m__decode_32k.json"
    d = json.loads(path.read_text())
    assert d["status"] == "ok" and d["chips"] == 256
    assert dryrun.main(argv) == 0
    assert "[skip-cached]" in capsys.readouterr().out
    rows = roofline.main(["--dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "H100 SXM5" in out and "989.4 TFLOP/s" in out
    assert [r["arch"] for r in rows] == ["xlstm_350m"]
    r = rows[0]
    assert r["compute_s"] == d["flops"] / 989.4e12
    assert r["bottleneck"] in ("compute", "memory", "collective")
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (
        989.4e12, 3.35e12, 450e9)


def test_perf_harness_over_probe_costs(tmp_path):
    r = perf.main(["--arch", "xlstm_350m", "--shape", "decode_32k",
                   "--mesh-shape", "2x2", "--flags", "cache_seq_on_model",
                   "--out", str(tmp_path)])
    assert r["flags"] == {"cache_seq_on_model": True}
    assert r["compute_s"] == r["flops_per_device"] / roofline.PEAK_FLOPS
    assert (tmp_path / "xlstm_350m__decode_32k__cache_seq_on_model.json"
            ).exists()
    assert perf.parse_flags("moe_cf=1.5,shard_cache_seq") == {
        "moe_cf": 1.5, "shard_cache_seq": True}
    for ignored in ("sp_residual", "bf16_barrier", "gather_once"):
        with pytest.raises(ValueError, match="change nothing"):
            perf.parse_flags(f"moe_cf=1.5,{ignored}")
        with pytest.raises(ValueError, match="change nothing"):
            dryrun.probe_costs(get_reduced("llama3_8b"), CELLS["train"],
                               None, 1, flags={ignored: True})
