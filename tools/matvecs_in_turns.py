"""Time the dense matvecs of two checkouts in turns, beside ``torch.bmm``.

    python tools/matvecs_in_turns.py OLD_CHECKOUT NEW_CHECKOUT [--rounds 1]
        [--shape K M N ...]

On one CUDA card: for each round, a fresh process per checkout, in the
order old, new, new, old, builds that checkout's kernels and times its
``kernels.ops.bmatvec`` and ``bmatvec_t`` (the public entry points, the
same in every checkout since the dense path was ported) at each shape, f32
and bf16 ``A`` (seeded, drawn on the card, entries of 1/sqrt(N)), with
CUDA events over back-to-back calls, each call in turns with one
``torch.bmm`` of the same product; each process prints one JSON line of
ms per (kernel, dtype, shape).  The default shapes are the densified
main-path stack [8, 4,099, 6,145], the same bytes at k = 1 and k = 32, and
the dense engine sweep's [32, 256, 256] (there the host's time to issue a
call shows).  At the first shape, f32, each process also times the fused
half-steps (``ops.fused_forward_step``, ``fused_backward_step``) on the
operands of ``testing.step_operands`` and prints a digest of their
outputs' bytes, so that the two checkouts' bits can be compared.  Compare
a number only with the other checkout's in the same call.  Exits nonzero
without a CUDA device or when a process fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

SHAPES = ((8, 4099, 6145), (1, 32792, 6145), (32, 1025, 6145),
          (32, 256, 256))

# what one process runs inside a checkout
CHILD = r"""
import hashlib, json, sys
sys.path.insert(0, "src")
import torch
from repro_torch import testing
from repro_torch.kernels import build, ops
build.build()
shapes = json.loads(sys.argv[1])


def event_ms(fn, reps=30, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


row = {}
k, m, n = shapes[0]
g = torch.Generator(device="cuda").manual_seed(0)
A = torch.randn((k, m, n), generator=g, device="cuda") / n ** 0.5
o = {key: torch.as_tensor(v, device="cuda")
     for key, v in testing.step_operands(k, m, n, 1).items()}
steps = {
    "fused_forward_step": lambda: ops.fused_forward_step(
        A, o["x"], o["c"], o["l"], o["u"], o["tau"], o["kty"]),
    "fused_backward_step": lambda: ops.fused_backward_step(
        A, o["y"], o["q"], o["sigma"], o["mask"], o["kxn"], o["kxp"])}
for name, fn in steps.items():
    digest = hashlib.sha256()
    for t in fn():
        digest.update(t.cpu().numpy().tobytes())
    row[f"{name} float32 {k}x{m}x{n} digest"] = digest.hexdigest()[:16]
    row[f"{name} float32 {k}x{m}x{n}"] = min(event_ms(fn), event_ms(fn))
del A
for k, m, n in shapes:
    g = torch.Generator(device="cuda").manual_seed(0)
    A32 = torch.randn((k, m, n), generator=g, device="cuda") / n ** 0.5
    x = torch.randn((k, n), generator=g, device="cuda")
    y = torch.randn((k, m), generator=g, device="cuda")
    for dt in (torch.float32, torch.bfloat16):
        A = A32.to(dt)
        xb, yb = x.to(dt), y.to(dt)
        fns = {"bmatvec": lambda: ops.bmatvec(A, x),
               "bmatvec_t": lambda: ops.bmatvec_t(A, y),
               "bmm": lambda: torch.bmm(A, xb[:, :, None]),
               "bmm_t": lambda: torch.bmm(yb[:, None, :], A)}
        ms = {}
        for name in ("bmatvec", "bmm", "bmm", "bmatvec", "bmatvec_t",
                     "bmm_t", "bmm_t", "bmatvec_t"):
            t = event_ms(fns[name])
            ms[name] = min(ms.get(name, t), t)
        for name, t in ms.items():
            row[f"{name} {str(dt)[6:]} {k}x{m}x{n}"] = t
        del A
    del A32
print(json.dumps(row))
"""


def run(checkout: Path, shapes) -> dict:
    proc = subprocess.run([sys.executable, "-c", CHILD, json.dumps(shapes)],
                          cwd=checkout, capture_output=True, text=True,
                          timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{checkout}: exit {proc.returncode}\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old", type=Path)
    ap.add_argument("new", type=Path)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--shape", type=int, nargs=3, action="append")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("matvecs_in_turns: no CUDA device", file=sys.stderr)
        return 2
    shapes = [list(s) for s in (args.shape or SHAPES)]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"[card] {card}", flush=True)
    rows = {"old": [], "new": []}
    for _ in range(args.rounds):
        for who in ("old", "new", "new", "old"):
            row = run(getattr(args, who), shapes)
            rows[who].append(row)
            print(json.dumps({"checkout": who, **row}), flush=True)
    for key in rows["new"][0]:
        old = [r[key] for r in rows["old"] if key in r]
        new = [r[key] for r in rows["new"]]
        if key.endswith("digest"):
            print(f"[turns] {key}: old {sorted(set(old))}, new "
                  f"{sorted(set(new))}, equal {set(old) == set(new)}")
        elif old:
            print(f"[turns] {key}: old {min(old):.4f} ms, new "
                  f"{min(new):.4f} ms (least of {len(new)})")
        else:
            print(f"[turns] {key}: new {min(new):.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
