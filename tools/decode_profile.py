"""Where a decode step of the port's serving path spends its time.

    PYTHONPATH=src python tools/decode_profile.py            # on the card
    PYTHONPATH=src python tools/decode_profile.py --reduced --device cpu

Builds the serving parameters of ``--arch`` (llama3-8b at full width by
default: random weights from ``--seed``, cast to bf16 once) and a decode
cache of ``--max-seq`` slots at ``--batch`` sequences, positioned at
``--pos`` (the slots before it hold zeros: a step reads the whole cache
either way).  Then, on the card, in one process:

1. ``--steps`` eager decode steps (``make_serve_step``), timed with CUDA
   events, and the host's time to issue them (the loop's clock before the
   synchronisation);
2. the same steps under ``torch.profiler``: device time, the device's busy
   share, kernels a step and the kernels taking the most device time;
3. one step captured as a CUDA graph and replayed ``--steps`` times
   (CUDA events): the step without the host's per-operation cost, and its
   greedy tokens against the eager steps' from the same cache.

Prints one line a measurement and a JSON line of them; the card's name
and power limit come first.  On the CPU only step 1 runs (host clock).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch


def _card() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60)
    return proc.stdout.strip() or "nvidia-smi: no output"


def _fresh_cache(models, cfg, batch, max_seq, pos, device):
    cache = models.init_cache(cfg, batch, max_seq, kv_dtype=torch.bfloat16,
                              device=device)
    cache["pos"].fill_(pos)
    return cache


def _eager(step, params, cache, tok, steps, device):
    cuda = device.type == "cuda"
    out = []
    if cuda:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for _ in range(steps):
        tok, cache = step(params, cache, tok)
        out.append(tok)
    issue_s = time.perf_counter() - t0
    if cuda:
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / steps
    else:
        ms = (time.perf_counter() - t0) / steps * 1e3
    return ms, issue_s / steps * 1e3, torch.cat(out, 1).cpu()


def _profiled(step, params, cache, tok, steps):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            tok, cache = step(params, cache, tok)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = sorted(((ev.self_device_time_total, ev.count, ev.key)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA), reverse=True)
    busy_us = sum(r[0] for r in rows)
    return wall_us, busy_us, sum(r[1] for r in rows), rows


def _graphed(models, cfg, params, cache, tok, steps):
    """One decode step captured as a CUDA graph (``pos`` advanced in place
    inside it), replayed ``steps`` times."""
    static_tok = tok.clone()
    pos = cache["pos"]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm-up: allocations, caches
        for _ in range(2):
            models.forward_decode(params, cfg, static_tok, cache,
                                  compute_dtype=torch.bfloat16)
            cache["pos"] = pos
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        logits, cache = models.forward_decode(params, cfg, static_tok, cache,
                                              compute_dtype=torch.bfloat16)
        static_next = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
        pos.copy_(cache["pos"])
    cache["pos"] = pos
    return graph, static_tok, static_next


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3_8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=2048)
    ap.add_argument("--pos", type=int, default=128)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)

    from repro_torch import models
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.core.problem import resolve_device
    from repro_torch.launch import serve
    from repro_torch.serve.engine import ServeConfig, make_serve_step

    device = resolve_device(a.device)
    cuda = device.type == "cuda"
    if cuda:
        print(f"[decode] card {_card()}")
    cfg = get_reduced(a.arch) if a.reduced else get_config(a.arch)
    params = serve.build_params(cfg, a.seed, device)
    step = make_serve_step(cfg, ServeConfig(batch=a.batch,
                                            max_seq=a.max_seq))
    tok = serve.random_prompt(cfg, a.batch, 1, a.seed, device)
    fresh = lambda: _fresh_cache(models, cfg, a.batch, a.max_seq, a.pos,
                                 device)
    _eager(step, params, fresh(), tok, 2, device)          # warm-up
    ms, issue_ms, eager_tokens = _eager(step, params, fresh(), tok, a.steps,
                                        device)
    out = {"arch": cfg.name, "batch": a.batch, "max_seq": a.max_seq,
           "device": str(device), "eager_ms": ms, "issue_ms": issue_ms}
    print(f"[decode] {cfg.name}, batch {a.batch}, cache {a.max_seq} slots "
          f"at position {a.pos}: eager {ms:.4f} ms a step, the host issues "
          f"a step in {issue_ms:.4f} ms")
    if cuda:
        wall_us, busy_us, n_kernels, rows = _profiled(step, params, fresh(),
                                                      tok, a.steps)
        out.update(profiled_wall_ms=wall_us / a.steps / 1e3,
                   device_ms=busy_us / a.steps / 1e3,
                   busy_share=busy_us / wall_us,
                   kernels_per_step=n_kernels / a.steps)
        print(f"[decode] under the profiler: {wall_us / a.steps / 1e3:.4f} "
              f"ms of wall and {busy_us / a.steps / 1e3:.4f} ms of device "
              f"time a step ({100 * busy_us / wall_us:.1f}% busy), "
              f"{n_kernels / a.steps:.1f} kernels a step")
        for dev_us, count, key in rows[:12]:
            print(f"[decode]   {dev_us / a.steps / 1e3:8.4f} ms a step "
                  f"{100 * dev_us / busy_us:5.1f}% x{count / a.steps:<6.1f} "
                  f"{key[:80]}")
        cache = fresh()
        graph, static_tok, static_next = _graphed(models, cfg, params, cache,
                                                  tok, a.steps)
        cache["pos"].fill_(a.pos)
        static_tok.copy_(tok)
        got = []
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(a.steps):
            graph.replay()
            got.append(static_next.clone())
            static_tok.copy_(static_next)
        end.record()
        torch.cuda.synchronize()
        graph_ms = start.elapsed_time(end) / a.steps
        same = torch.equal(torch.cat(got, 1).cpu(), eager_tokens)
        out.update(graph_ms=graph_ms, graph_tokens_equal=same)
        print(f"[decode] one step as a CUDA graph: {graph_ms:.4f} ms a step "
              f"replayed; its {a.steps} greedy tokens equal the eager "
              f"steps' {same}")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
