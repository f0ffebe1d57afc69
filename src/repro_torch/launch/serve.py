"""Serving driver: batched greedy decode with the per-arch cache-layout
policy — the port of ``repro/launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm_350m \\
        --reduced --batch 8 --tokens 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_8b \\
        --batch 8 --max-seq 2048 --prompt 128 --tokens 64

Runs on the CUDA device unless ``--device cpu`` is given (with no card it
refuses).  Parameters are drawn from the seed ``SEED`` (the reference
loads no weights either), cast to bf16 once, and served from a cache of
``--max-seq`` positions: a random prompt of ``--prompt`` tokens is
prefilled through the decode path, then ``--tokens`` greedy tokens are
decoded.  Every clock is read after a device synchronisation; on the card
the decode steps are also timed with CUDA events.

``--mesh DATAxMODEL`` serves through ``jit_serve_step`` on a ("data",
"model") mesh over the process group's ranks (a world of one in this
process, or a launcher's world; see ``launch/train.py``): parameters by
``param_shardings`` (each rank keeps only its blocks from the moment
they are drawn), the cache by ``kv_cache_specs``, the tokens on the data
axes; each rank computes its share of every product the rules split over
``model`` (no weight crosses the mesh), and the prompt is prefilled
through the same step.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_8b \
        --batch 8 --max-seq 2048 --prompt 16 --tokens 16 --mesh 1x1
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Optional

import torch

from ..configs import get_config, get_reduced
from ..core.problem import resolve_device
from ..models import init_cache, init_params, serving_params
from ..models import transformer as tf
from ..serve.engine import ServeConfig, jit_serve_step, make_serve_step
from ..train.train_step import init_placed_params, place_params
from .train import mesh_for, parse_mesh

SEED = 0          # the reference's driver draws from PRNGKey(0)


def cache_policy(cfg, seq: int) -> dict:
    """The flash-decode layout (cache sequence over a mesh's ``model``
    axis) for full-attention archs with large caches; SWA/SSM archs keep
    head/state layouts.  The same decision as the reference's; it acts
    only through a mesh."""
    full_attn = any(b.window is None and b.mixer in ("attn", "shared_attn")
                    for s in cfg.segments for b in s.period)
    return {"cache_seq_on_model": full_attn and seq >= 16_384}


@dataclasses.dataclass
class ServeRun:
    """One serving run: the greedy tokens and where the time went."""
    tokens: torch.Tensor          # [B, n_tokens] greedy tokens (CPU)
    final_logits: torch.Tensor    # [B, V] logits after the last token (CPU)
    prefill_s: float              # host wall of the prefill (synchronised)
    decode_s: float               # host wall of the decode loop
    step_ms: Optional[float]      # CUDA-event ms per decode step (card)
    tokens_per_s: float           # decoded tokens / decode_s
    peak_bytes: Optional[int]     # max_memory_allocated while serving
    weight_bytes: int             # serving weights a step reads
    cache_bytes: int              # the decode cache


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_params(cfg, seed: int, device, mesh=None):
    """Random f32 parameters from ``seed`` on ``device``, cast once to bf16
    for serving (``serving_params``).  On a ``mesh`` each rank keeps only
    its blocks, cast as they are drawn (``init_placed_params``)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if mesh is not None:
        return init_placed_params(
            gen, cfg, mesh, cast=lambda t: serving_params(t, torch.bfloat16))
    return serving_params(init_params(gen, cfg), torch.bfloat16)


def weight_bytes(params) -> int:
    """Bytes of the weights one decode step reads: every leaf once, the
    embedding table excepted (a step gathers B of its rows), unless the
    embeddings are tied and the table is also the unembedding."""
    total = sum(t.numel() * t.element_size() for t in tf.leaves(params))
    if "unembed" in params:
        table = params["embed"]["table"]
        total -= table.numel() * table.element_size()
    return total


def serve(cfg, params, prompt: torch.Tensor, n_tokens: int,
          max_seq: int, mesh=None) -> ServeRun:
    """Prefill ``prompt`` ([B, P] on the params' device) through the decode
    path, then decode ``n_tokens`` greedy tokens in bf16, starting from
    the prompt's last token; the final logits are one more step's.  With
    ``mesh`` every step is the sharded one (``jit_serve_step``; global
    parameters are placed on the way in, without a copy on a world of
    one)."""
    device = prompt.device
    B, P = prompt.shape
    scfg = ServeConfig(batch=B, max_seq=max_seq,
                       **cache_policy(cfg, max_seq))
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    cache = init_cache(cfg, B, max_seq, kv_dtype=scfg.dtype, device=device)
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in tf.leaves(cache["seg_caches"]))
    if mesh is None:
        step = make_serve_step(cfg, scfg, with_logits=True)
    else:
        step = jit_serve_step(cfg, scfg, mesh, device=device.type,
                              with_logits=True)
        params = place_params(params, mesh)

    _sync(device)
    t0 = time.perf_counter()
    for t in range(P - 1):
        _, cache, _ = step(params, cache, prompt[:, t:t + 1])
    _sync(device)
    prefill_s = time.perf_counter() - t0

    tok = prompt[:, -1:]
    out = []
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for _ in range(n_tokens):
        tok, cache, _ = step(params, cache, tok)
        out.append(tok)
    if cuda:
        end.record()
    _sync(device)
    decode_s = time.perf_counter() - t0
    step_ms = start.elapsed_time(end) / n_tokens if cuda else None

    _, _, logits = step(params, cache, tok)
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    return ServeRun(
        tokens=torch.cat([_whole(t) for t in out], dim=1).cpu(),
        final_logits=_whole(logits)[:, 0].float().cpu(),
        prefill_s=prefill_s, decode_s=decode_s, step_ms=step_ms,
        tokens_per_s=B * n_tokens / decode_s, peak_bytes=peak,
        weight_bytes=weight_bytes(params), cache_bytes=cache_bytes)


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A sharded step's output gathered whole (a plain tensor as it is)."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def random_prompt(cfg, batch: int, length: int, seed: int, device):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab, (batch, length),
                         generator=gen).to(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm_350m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--prompt", type=int, default=1,
                    help="prompt length prefilled through the decode path")
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device (refused without one)")
    ap.add_argument("--mesh", default=None,
                    help="DATAxMODEL: the sharded step on a device mesh")
    a = ap.parse_args(argv)

    device = resolve_device(a.device)
    mesh = mesh_for(parse_mesh(a.mesh), device)
    if mesh is not None and device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    cfg = get_reduced(a.arch) if a.reduced else get_config(a.arch)
    params = build_params(cfg, SEED, device, mesh)
    prompt = random_prompt(cfg, a.batch, a.prompt, SEED, device)
    run = serve(cfg, params, prompt, a.tokens, a.max_seq, mesh=mesh)
    step = ("not measured" if run.step_ms is None
            else f"{run.step_ms:.3f} ms/step (CUDA events)")
    print(f"{cfg.name}: prefill {a.prompt - 1} positions in "
          f"{run.prefill_s:.2f}s; {a.tokens} steps x batch {a.batch} = "
          f"{a.tokens * a.batch} tokens in {run.decode_s:.2f}s "
          f"({run.tokens_per_s:.0f} tok/s, {step}) on {device}")
    print(json.dumps({"arch": cfg.name, "device": str(device),
                      "step_ms": run.step_ms,
                      "tokens_per_s": run.tokens_per_s,
                      "peak_bytes": run.peak_bytes,
                      "weight_bytes": run.weight_bytes,
                      "cache_bytes": run.cache_bytes}))
    return run


if __name__ == "__main__":
    main()
