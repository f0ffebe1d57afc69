"""The port's ``launch/`` rules against the reference's: ``param_specs`` for
all 10 architectures and ``kv_cache_specs`` (the port's ``[B, Kv, L, hd]``
cache mapped onto the reference's ``[B, L, Kv, hd]``) on a (1, 1), a
16 x 16 and a 2 x 16 x 16 mesh, entry for entry; the shape policy, input
specs and parameter accounting (the twins of ``tests/test_launch.py``);
the sharding twins of ``tests/test_substrate.py``; ``placements`` and the
collective parser.

The meshes are the reference tests' stand-in (``FakeMesh``: axis names and
sizes), which both packages' rules accept; the reference's shapes come
from ``jax.eval_shape``, the port's from meta tensors.  Nothing here
starts a process group."""

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_config as rget_config
from repro.launch import shardings as rsh
from repro.launch import specs as rsp
from repro.launch.hlo_stats import active_param_counts as ractive
from repro_torch.configs import get_config
from repro_torch.interop import _paths
from repro_torch.launch import shardings as sh
from repro_torch.launch import specs as sp
from repro_torch.launch.hlo_stats import (COLLECTIVE_OPS,
                                          active_param_counts,
                                          collective_bytes)


class FakeMesh:
    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, shape))


MESHES = {"1x1": FakeMesh((1, 1), ("data", "model")),
          "16x16": FakeMesh((16, 16), ("data", "model")),
          "2x16x16": FakeMesh((2, 16, 16), ("pod", "data", "model"))}


def _norm(entry):
    """One spec entry with single-axis tuples as the name and empty
    tuples as None (the reference's ``PartitionSpec`` keeps either)."""
    if isinstance(entry, tuple):
        if not entry:
            return None
        return entry[0] if len(entry) == 1 else tuple(entry)
    return entry


def _ref_specs(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {".".join(str(getattr(e, "key", getattr(e, "idx", e)))
                     for e in path): tuple(_norm(x) for x in spec)
            for path, spec in flat}


def _port_specs(tree, prefix="") -> dict:
    """``{a.0.b: spec}`` with a named tuple's fields by index, as the
    reference's paths give them."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_specs(v, f"{prefix}.{k}" if prefix else k))
        return out
    if isinstance(tree, (list, tuple)) and not isinstance(tree, sh.P):
        out = {}
        for i, v in enumerate(tree):
            out.update(_port_specs(v, f"{prefix}.{i}"))
        return out
    return {prefix: tuple(_norm(x) for x in tree)}


@pytest.fixture(scope="module")
def ref_params():
    return {a: rsp.params_shape(rget_config(a)) for a in ARCH_IDS}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(ref_params, arch, mesh):
    m = MESHES[mesh]
    want = _ref_specs(rsh.param_specs(ref_params[arch], m))
    got = _port_specs(sh.param_specs(sp.params_shape(get_config(arch)), m))
    assert got == want


CACHE_CELLS = {"decode_32k": dict(shard_seq=False),
               "long_500k": dict(shard_seq=True)}


def _as_tuples(tree):
    """The reference's cache with each ``KVCache`` a plain tuple, so its
    fields flatten as ``SequenceKey`` entries, as its rule expects: under
    the installed JAX a named tuple's fields flatten as ``GetAttrKey``, so
    the rule's KV branch never fires on a ``KVCache`` and its leaves take
    the state rule (``test_reference_kv_rule_needs_sequence_keys``)."""
    if isinstance(tree, dict):
        return {k: _as_tuples(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_tuples(v) for v in tree]
    if isinstance(tree, tuple):
        return tuple(_as_tuples(v) for v in tree)
    return tree


@pytest.mark.parametrize("seq_on_model", [False, True])
@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ["llama3_8b", "h2o_danube3_4b",
                                  "zamba2_2_7b", "xlstm_350m",
                                  "mixtral_8x22b"])
def test_kv_cache_specs_match_reference(arch, mesh, seq_on_model):
    """Each KV leaf's spec, read on the reference's dim order, equals the
    reference's; state leaves entry for entry."""
    m = MESHES[mesh]
    cfg, rcfg = get_config(arch), rget_config(arch)
    for name, kw in CACHE_CELLS.items():
        cell = sp.SHAPES[name]
        if not sp.cell_is_runnable(cfg, cell)[0]:
            continue
        _, rcache, _ = rsp.decode_specs(rcfg, rsp.SHAPES[name])
        _, cache, _ = sp.decode_specs(cfg, cell)
        want = _ref_specs(rsh.kv_cache_specs(_as_tuples(rcache), m,
                                             cell.global_batch,
                                             seq_on_model=seq_on_model, **kw))
        got = _port_specs(sh.kv_cache_specs(cache, m, cell.global_batch,
                                            seq_on_model=seq_on_model, **kw))
        assert set(got) == set(want)
        for key, spec in got.items():
            assert _ref_order(key, spec) == want[key], (name, key)


def test_reference_kv_rule_needs_sequence_keys():
    """A known difference: the reference's ``kv_cache_specs`` finds KV
    leaves by a ``SequenceKey`` last in the path, which the installed JAX
    gives a plain tuple's fields but not a ``KVCache``'s; so on its own
    cache the reference shards the flash-decode layout's sequence nowhere
    (the state rule), while the port and the reference on tuples put it
    on ``model``."""
    m = MESHES["16x16"]
    _, rcache, _ = rsp.decode_specs(rget_config("llama3_8b"),
                                    rsp.SHAPES["decode_32k"])
    as_is = _ref_specs(rsh.kv_cache_specs(rcache, m, 128, seq_on_model=True))
    tuples = _ref_specs(rsh.kv_cache_specs(_as_tuples(rcache), m, 128,
                                           seq_on_model=True))
    assert as_is["seg_caches.0.b0..k"][2] is None
    assert tuples["seg_caches.0.b0.0"][2] == "model"
    _, cache, _ = sp.decode_specs(get_config("llama3_8b"),
                                  sp.SHAPES["decode_32k"])
    port = sh.kv_cache_specs(cache, m, 128, seq_on_model=True)
    assert port["seg_caches"][0]["b0"].k[3] == "model"     # L, port dim 3


def _ref_order(key: str, entries: tuple) -> tuple:
    """A KV leaf's entries (a ``KVCache`` field: its key ends in the
    field's index) in the reference's dim order; others as they are."""
    if key.rsplit(".", 1)[-1] in ("0", "1") and len(entries) == 5:
        return tuple(entries[sh.KV_DIMS.index(i)] for i in range(5))
    return entries


def test_kv_leaves_are_the_ports_layout():
    """The port's KV leaf is [periods, B, Kv, L, hd]: batch on the data
    axes, the KV heads (8 on 16 do not divide; head_dim 128 does) on
    ``model`` in head_dim, the sequence whole."""
    cfg = get_config("llama3_8b")
    _, cache, _ = sp.decode_specs(cfg, sp.SHAPES["decode_32k"])
    specs = sh.kv_cache_specs(cache, MESHES["16x16"], 128)
    k_spec = specs["seg_caches"][0]["b0"].k
    assert tuple(cache["seg_caches"][0]["b0"].k.shape) == (32, 128, 8,
                                                           32_768, 128)
    assert k_spec == sh.P(None, ("data",), None, None, "model")
    assert specs["pos"] == sh.P()


# ---------------------------------------------------------------------------
# twins of tests/test_launch.py
# ---------------------------------------------------------------------------

def test_long_500k_skip_policy_matches_design():
    runnable = {a: sp.cell_is_runnable(get_config(a),
                                       sp.SHAPES["long_500k"])[0]
                for a in ARCH_IDS}
    want = {a: rsp.cell_is_runnable(rget_config(a),
                                    rsp.SHAPES["long_500k"])[0]
            for a in ARCH_IDS}
    assert runnable == want
    assert runnable["llama3_8b"] is False and runnable["xlstm_350m"] is True


def test_shapes_and_policy_equal_reference():
    assert {k: tuple(vars(v).values()) for k, v in sp.SHAPES.items()} == \
        {k: tuple(vars(v).values()) for k, v in rsp.SHAPES.items()}
    assert sp.ENC_MEMORY_LEN == rsp.ENC_MEMORY_LEN
    for cell in sp.SHAPES.values():
        for n_dp in (1, 2, 16, 32, 512):
            assert sp.microbatches_for(cell, n_dp) == rsp.microbatches_for(
                rsp.SHAPES[cell.name], n_dp)


def test_batch_specs_shapes():
    cfg = get_config("llama3_8b")
    cell = sp.SHAPES["train_4k"]
    b = sp.batch_specs(cfg, cell)
    assert b["tokens"].shape == (256, 4096) and b["tokens"].is_meta
    assert b["labels"].shape == (256, 4096)
    assert b["tokens"].dtype == torch.int32
    assert "enc_embeddings" not in b
    b2 = sp.batch_specs(get_config("seamless_m4t_medium"), cell)
    assert b2["enc_embeddings"].shape == (256, sp.ENC_MEMORY_LEN, 1024)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_specs_match_reference_shapes(arch):
    """Token, cache and memory stand-ins of the reference's shapes (KV
    leaves in the port's order)."""
    cfg, rcfg = get_config(arch), rget_config(arch)
    cell = sp.SHAPES["decode_32k"]
    tok, cache, mem = sp.decode_specs(cfg, cell)
    rtok, rcache, rmem = rsp.decode_specs(rcfg, rsp.SHAPES["decode_32k"])
    assert tuple(tok.shape) == rtok.shape
    assert (mem is None) == (rmem is None)
    want = {".".join(str(getattr(e, "key", getattr(e, "idx", e)))
                     for e in p): leaf.shape
            for p, leaf in jax.tree_util.tree_flatten_with_path(rcache)[0]}
    got = {key: _ref_order(key, shape) for key, shape in _port_specs(
        sh.map_with_path(lambda path, t: sh.P(*t.shape), cache)).items()}
    want = {k.replace("..k", ".0").replace("..v", ".1"): tuple(v)
            for k, v in want.items()}
    assert got == want


def test_decode_specs_cache_sized_by_window():
    """SWA archs allocate ring buffers of window size, not seq size."""
    _, cache, _ = sp.decode_specs(get_config("h2o_danube3_4b"),
                                  sp.SHAPES["long_500k"])
    kv = [t for t in _paths(_kv(cache)).values()]
    assert kv and all(t.shape[3] == 4096 for t in kv)
    _, cache2, _ = sp.decode_specs(get_config("llama3_8b"),
                                   sp.SHAPES["decode_32k"])
    kv2 = list(_paths(_kv(cache2)).values())
    assert kv2 and all(t.shape[3] == 32_768 for t in kv2)


def _kv(cache):
    return {f"{i}.{b}.{f}": getattr(c, f)
            for i, seg in enumerate(cache["seg_caches"])
            for b, c in seg.items() if hasattr(c, "_fields")
            for f in c._fields}


def test_microbatching_policy():
    cell = sp.SHAPES["train_4k"]
    assert sp.microbatches_for(cell, n_dp=16) == 8
    assert sp.microbatches_for(cell, n_dp=32) == 8
    assert sp.microbatches_for(sp.SHAPES["decode_32k"], 16) == 1


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_active_param_counts_equal_reference(arch):
    assert active_param_counts(get_config(arch)) == \
        ractive(rget_config(arch))


def test_active_params_moe_vs_dense():
    mix = active_param_counts(get_config("mixtral_8x22b"))
    assert mix["total"] > 120e9
    assert mix["active"] < 0.45 * mix["total"]
    dense = active_param_counts(get_config("llama3_8b"))
    assert dense["active"] == dense["total"]


# ---------------------------------------------------------------------------
# twins of tests/test_substrate.py's sharding tests
# ---------------------------------------------------------------------------

def test_param_specs_structure_matches():
    p_shape = sp.params_shape(get_config("llama3_8b"))
    specs = sh.param_specs(p_shape, MESHES["1x1"])
    assert set(_port_specs(specs)) == set(_paths(p_shape))
    flat_p = _paths(p_shape)
    for key, spec in _port_specs(specs).items():
        assert len(spec) == flat_p[key].ndim


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_sharding_divisibility_all_archs(arch):
    """Every dim marked "model" divides by 16 on the production mesh."""
    p_shape = sp.params_shape(get_config(arch))
    flat = _paths(p_shape)
    for key, spec in _port_specs(sh.param_specs(p_shape,
                                                MESHES["16x16"])).items():
        for dim, ax in enumerate(spec):
            if ax == "model":
                assert flat[key].shape[dim] % 16 == 0, (arch, key)


# ---------------------------------------------------------------------------
# placements and the collective parser
# ---------------------------------------------------------------------------

def test_placements_follow_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    m = MESHES["2x16x16"]
    assert sh.placements(sh.P(("pod", "data"), None, "model"), m) == (
        Shard(0), Shard(0), Shard(2))
    assert sh.placements(sh.P(None, None), m) == (Replicate(),) * 3
    assert sh.placements(sh.batch_spec(MESHES["16x16"]),
                         MESHES["16x16"]) == (Shard(0), Replicate())
    assert sh.batch_spec(m) == sh.P(("pod", "data"), None)
    assert sh.activation_spec(m) == sh.P(("pod", "data"), None, None)
    assert sh.dp_axes(m) == rsh.dp_axes(m)


def test_collective_parser_counts_results_only():
    f32, bf16, u8 = torch.float32, torch.bfloat16, torch.uint8
    pairs = [
        ("c10d.allreduce_", [torch.empty((2, 4096, 4096), dtype=f32,
                                         device="meta")]),
        ("aten.add.Tensor", torch.empty((8, 8), dtype=f32, device="meta")),
        ("_c10d_functional.all_gather_into_tensor",
         torch.empty((16, 128), dtype=bf16, device="meta")),
        ("c10d.allreduce_", [torch.empty((4, 4), dtype=f32, device="meta"),
                             torch.empty((2,), dtype=f32, device="meta")]),
        ("_c10d_functional.wait_tensor", torch.empty(10, device="meta")),
        ("c10d.send", [torch.empty(32, dtype=u8, device="meta")]),
        ("c10d._reduce_scatter_base_", torch.empty(2, device="meta")),
    ]
    out = collective_bytes(pairs)
    assert out["all-reduce"] == 2 * 4096 * 4096 * 4 + (4 * 4 * 4 + 2 * 4)
    assert out["all-gather"] == 16 * 128 * 2
    assert out["collective-permute"] == 32
    assert out["reduce-scatter"] == 2 * 4
    assert out["count"] == 5
    assert out["total"] == sum(out[k] for k in COLLECTIVE_OPS)
    assert COLLECTIVE_OPS == ("all-reduce", "all-gather", "reduce-scatter",
                              "all-to-all", "collective-permute")


def test_plain_comm_debug_mode_is_refused():
    from torch.distributed.tensor.debug import CommDebugMode
    with pytest.raises(TypeError, match="CollectiveLog"):
        collective_bytes(CommDebugMode())


def test_make_host_mesh_refuses_without_a_card(monkeypatch):
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for entry in (make_host_mesh, make_production_mesh):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()
