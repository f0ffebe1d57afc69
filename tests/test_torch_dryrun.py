"""The port's dry run (``repro_torch.launch.dryrun``), roofline and flags
harness on the CPU: every cell runs one step on meta tensors under a fake
process group.

Reduced configs on a fake 2 x 2 mesh run each of the train, prefill and
decode steps; the per-device FLOPs the dry run counts are below those of
the unsharded step on one rank's rows (every reduced matrix splits over a
2-wide ``model`` axis) and at least half of them (the two ranks' shares
cover the whole), counted by the same ``FlopCounterMode``.  Full-size
llama3-8b runs its decode_32k and prefill_32k cells on the fake 16 x 16
mesh (its train_4k cell takes about 20 s alone here, so it is left to
the CLI): within the bounds of tensor parallelism, above a 16th of the
model's matrix FLOPs on a rank's rows, with no parameter block
all-gathered.  A cell that fails names the op that raised.  The fake
group is torn down after the module, so no other test of this worker
sees it."""

import json

import pytest
import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.launch import dryrun, perf, roofline
from repro_torch.launch import specs as sp
from repro_torch.models import transformer as tf
from repro_torch.serve.engine import ServeConfig, make_serve_step
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
    with FlopCounterMode(display=False) as fc:
        if cell.kind == "decode":
            token, cache, memory = sp.decode_specs(cfg, cell)
            cache = _rows_of_cache(cache, rows)
            with torch.no_grad():
                make_serve_step(cfg, ServeConfig(
                    batch=rows, max_seq=cell.seq_len))(
                    params, cache, token[:rows],
                    None if memory is None else memory[:rows])
            return float(fc.get_total_flops())
        batch = {k: v[:rows] for k, v in sp.batch_specs(cfg, cell).items()}
        if cell.kind == "train":
            make_train_step(cfg, TrainConfig(n_microbatches=n_micro))(
                params, opt_mod.init_state(params), batch)
        else:
            with torch.no_grad():
                tf.forward_train(params, cfg, batch["tokens"],
                                 enc_embeddings=batch.get("enc_embeddings"),
                                 remat=False)
    return float(fc.get_total_flops())


def _rows_of_cache(cache, rows: int):
    """A decode cache's first ``rows`` rows (dim 1 of every stacked
    leaf)."""
    def cut(t):
        if isinstance(t, dict):
            return {k: cut(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(*(cut(v) for v in t)) if hasattr(t, "_fields") \
                else type(t)(cut(v) for v in t)
        return t[:, :rows] if t.ndim > 1 else t
    return {"seg_caches": cut(cache["seg_caches"]), "pos": cache["pos"]}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_reduced_cells_on_a_fake_2x2_mesh(arch, kind):
    """Per-device FLOPs below the unsharded step's on one rank's rows:
    every reduced matrix splits over the 2-wide model axis, so each rank
    computes its share; and at least half of them, since the two ranks'
    shares cover the whole step.  A split step need not all-gather, so
    only the count of collectives is asked to be positive."""
    cfg = get_reduced(arch)
    r = dryrun.run_cell(arch, kind, False, cfg=cfg, mesh_shape=(2, 2),
                        cell=CELLS[kind])
    assert r["status"] == "ok", r.get("trace")
    assert r["chips"] == 4 and r["n_dp"] == 2
    assert r["flops"] > 0 and r["bytes_accessed"] > 0
    assert r["collectives"]["count"] > 0
    assert r["probes"]["flops_per_device"] == r["flops"]
    n_micro = r["probes"]["n_micro"] if kind == "train" else 1
    whole = _unsharded_flops(cfg, CELLS[kind],
                             CELLS[kind].global_batch // 2, n_micro)
    assert whole / 2 <= r["flops"] < whole


def _parameter_shapes(cfg) -> set:
    """The shapes of every parameter leaf and of one period of a stacked
    leaf: what a parameter gather would return."""
    out = set()
    for t in tf.leaves(sp.params_shape(cfg)):
        out.add(tuple(t.shape))
        out.add(tuple(t.shape[1:]))
    return out


@pytest.mark.parametrize("shape", ["decode_32k", "prefill_32k"])
def test_full_llama_cell_on_the_production_mesh(shape):
    """Tensor parallelism on the fake 16 x 16 mesh: decode_32k within
    2.5e10 FLOPs and 1.2 GB of collectives a device, and prefill_32k
    within 1/8 of the whole model's count on a rank's rows; each above
    the model's matrix FLOPs on a rank's rows split 16 ways; no
    all-gather returns a parameter leaf or a period of one."""
    from repro_torch.launch.hlo_stats import CollectiveLog
    cfg = get_config("llama3_8b")
    with CollectiveLog() as log:
        r = dryrun.run_cell("llama3_8b", shape, False)
    assert r["status"] == "ok", r.get("trace")
    assert (r["chips"], r["n_dp"]) == (256, 16)
    assert r["params_total"] == cfg.param_count()
    cell = sp.SHAPES[shape]
    rows = cell.global_batch // 16
    assert r["mem_argument_size_in_bytes"] > 4 * r["params_total"] / 16
    gathered = {tuple(t.shape) for op, res in log.pairs
                if "gather" in op for t in res}
    assert not gathered & _parameter_shapes(cfg)
    assert r["flops"] > 2 * (r["params_active"] - r["params_embed"]) \
        * rows * (cell.seq_len if cell.kind == "prefill" else 1) / 16
    if shape == "decode_32k":
        assert r["flops"] <= 2.5e10
        assert r["collectives"]["total"] <= 1.2e9
    else:
        assert r["flops"] <= _unsharded_flops(cfg, cell, rows, 1) / 8


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
    """The harness writes a cell's roofline terms; every flag of
    ``dryrun.FLAGS`` parses, the three model options among them, and is
    counted (the step runs with it); another name is refused."""
    r = perf.main(["--arch", "xlstm_350m", "--shape", "decode_32k",
                   "--mesh-shape", "2x2", "--flags", "cache_seq_on_model",
                   "--out", str(tmp_path)])
    assert r["flags"] == {"cache_seq_on_model": True}
    assert r["compute_s"] == r["flops_per_device"] / roofline.PEAK_FLOPS
    assert (tmp_path / "xlstm_350m__decode_32k__cache_seq_on_model.json"
            ).exists()
    assert perf.parse_flags("moe_cf=1.5,shard_cache_seq") == {
        "moe_cf": 1.5, "shard_cache_seq": True}
    cfg = get_reduced("llama3_8b")
    mesh = dryrun.fake_mesh((2, 2), ("data", "model"))
    base = dryrun.probe_costs(cfg, CELLS["train"], mesh, 2)
    for flag in ("sp_residual", "bf16_barrier", "gather_once"):
        assert perf.parse_flags(f"moe_cf=1.5,{flag}") == {
            "moe_cf": 1.5, flag: True}
        got = dryrun.probe_costs(cfg, CELLS["train"], mesh, 2,
                                 flags={flag: True})
        assert got["flops_per_device"] > 0
        # sp_residual changes the collectives; the other two select what
        # the port's blocks run anyway
        same = got["collective_bytes_per_device"] == \
            base["collective_bytes_per_device"]
        assert same == (flag != "sp_residual")
    with pytest.raises(ValueError, match="not one the port's steps act on"):
        perf.parse_flags("moe_cf=1.5,fuse_everything")


def _logged_train_step(flags: dict):
    """The collectives of one bf16 train step of reduced gemma3-4b on a
    fake 1 x 4 mesh under ``flags``: ``(kind, dtype, shape)`` in order."""
    from repro_torch.launch.hlo_stats import CollectiveLog, collective_kind
    from repro_torch.train.train_step import (jit_train_step, place_batch,
                                              place_opt_state, place_params)
    cfg = get_reduced("gemma3_4b")
    mesh = dryrun.fake_mesh((1, 4), ("data", "model"))
    params = place_params(sp.params_shape(cfg), mesh)
    opt = place_opt_state(sp.opt_shape(sp.params_shape(cfg)), mesh)
    batch = place_batch(sp.batch_specs(cfg, CELLS["train"]), mesh)
    step = jit_train_step(cfg, TrainConfig(**flags), mesh, device="cpu")
    with CollectiveLog() as log:
        step(params, opt, batch)
    return [(collective_kind(op), t.dtype, tuple(t.shape))
            for op, res in log.pairs for t in res]


def test_model_flags_change_what_crosses_the_model_axis():
    """What each of the reference's three flags does to a split step:
    ``sp_residual`` leaves each block by a reduce-scatter of the sequence
    and enters it by one all-gather (no activation all-reduce of
    ``[B, S, D]`` left); ``gather_once`` and ``bf16_barrier`` select what
    the port's blocks run anyway, so the collectives are the same ones,
    each norm output gathered once, in the compute dtype (bf16)."""
    off = _logged_train_step({})
    on = _logged_train_step({"sp_residual": True})
    cfg = get_reduced("gemma3_4b")
    B, S = CELLS["train"].global_batch, CELLS["train"].seq_len
    act = (B, S, cfg.d_model)
    assert any(k == "all-reduce" and s == act for k, _, s in off)
    assert not any(k == "all-reduce" and s == act for k, _, s in on)
    # a gather along the sequence runs with the sequence dim leading
    gathered = [d for k, d, s in on
                if k == "all-gather" and sorted(s) == sorted(act)]
    scattered = [d for k, d, s in on if k == "reduce-scatter"]
    assert scattered and gathered
    assert set(scattered) == set(gathered) == {torch.bfloat16}
    for flag in ("gather_once", "bf16_barrier"):
        assert _logged_train_step({"sp_residual": True, flag: True}) == on
