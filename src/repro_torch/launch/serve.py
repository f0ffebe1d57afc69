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
from ..serve.engine import ServeConfig, make_serve_step, prefill

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


def build_params(cfg, seed: int, device):
    """Random f32 parameters from ``seed`` on ``device``, cast once to bf16
    for serving (``serving_params``)."""
    gen = torch.Generator(device=device).manual_seed(seed)
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
          max_seq: int) -> ServeRun:
    """Prefill ``prompt`` ([B, P] on the params' device) through the decode
    path, then decode ``n_tokens`` greedy tokens in bf16, starting from
    the prompt's last token."""
    device = prompt.device
    B, P = prompt.shape
    compute_dtype = torch.bfloat16
    scfg = ServeConfig(batch=B, max_seq=max_seq,
                       **cache_policy(cfg, max_seq))
    step = make_serve_step(cfg, scfg)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    cache = init_cache(cfg, B, max_seq, kv_dtype=compute_dtype,
                       device=device)
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in tf.leaves(cache["seg_caches"]))

    _sync(device)
    t0 = time.perf_counter()
    cache = prefill(params, cfg, prompt[:, :-1], cache,
                    compute_dtype=compute_dtype)
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
        tok, cache = step(params, cache, tok)
        out.append(tok)
    if cuda:
        end.record()
    _sync(device)
    decode_s = time.perf_counter() - t0
    step_ms = start.elapsed_time(end) / n_tokens if cuda else None

    logits, _ = tf.forward_decode(params, cfg, tok, cache,
                                  compute_dtype=compute_dtype)
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    return ServeRun(
        tokens=torch.cat(out, dim=1).cpu(),
        final_logits=logits[:, 0].float().cpu(),
        prefill_s=prefill_s, decode_s=decode_s, step_ms=step_ms,
        tokens_per_s=B * n_tokens / decode_s, peak_bytes=peak,
        weight_bytes=weight_bytes(params), cache_bytes=cache_bytes)


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
    a = ap.parse_args(argv)

    device = resolve_device(a.device)
    cfg = get_reduced(a.arch) if a.reduced else get_config(a.arch)
    params = build_params(cfg, SEED, device)
    prompt = random_prompt(cfg, a.batch, a.prompt, SEED, device)
    run = serve(cfg, params, prompt, a.tokens, a.max_seq)
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
