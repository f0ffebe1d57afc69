"""Device times of variants of the dense matvec stream, in turns with
``torch.bmm``.

    python tools/matvec_variants.py [--variant NAME=kDepth:3,kBlocksPerSm:3]
        [--shape 8 4099 6145] [--rounds 3]

A variant is ``src/repro_torch/kernels/csrc/pdhg_matvec.cu`` with some of
its ``constexpr int kName = value;`` lines replaced (``BLOCKS_PER_SM``
patched with ``kBlocksPerSm``, for the plan), or with a wrapper-only
constant changed (``MIN_COL_ROWS``, ``SMS``, ``ROW_BLOCK_BYTES``, or
``COL_CHUNK_F32``, the f32 entry of ``COL_CHUNK_BYTES``); ``base`` is the
source as committed and is always run.  Every variant is built with the
committed source's ``nvcc`` flags, one ``nvcc`` each, all started
together, into ``build/matvec_variants/``.  For f32 and bf16 ``A`` of the shape (seeded,
drawn on the card) each variant's ``bmatvec`` and ``bmatvec_t`` are held
against their plain versions (1e-4, bf16 2e-2) and to one CUDA launch a
call, then timed with CUDA events over back-to-back calls in turns with
one ``torch.bmm`` of the same product (the order reversed every other
round); the least ms of the rounds is printed for each, with the card's
name and power limit, and written to ``build/matvec_variants/ms.json``.
At the default shape a call moves 403-806 MB, so the host's time to issue
it is hidden and the events time the device.  Exits nonzero without a CUDA
device or if a variant does not build or disagrees.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import pdhg_matvec as mv  # noqa: E402

OUT_DIR = ROOT / "build" / "matvec_variants"
# source constants whose wrapper constant the launch reads (the plan's
# blocks a lane); every other kName is the source's alone
WRAPPER_NAME = {"kBlocksPerSm": "BLOCKS_PER_SM"}
# the wrapper's own plan constants a variant may set (COL_CHUNK_F32 is the
# f32 entry of COL_CHUNK_BYTES)
WRAPPER_ONLY = ("MIN_COL_ROWS", "SMS", "ROW_BLOCK_BYTES", "COL_CHUNK_F32")
# what use() restores before each variant
SAVED = ("BLOCKS_PER_SM", "MIN_COL_ROWS", "SMS", "ROW_BLOCK_BYTES",
         "COL_CHUNK_BYTES")
DTYPES = (torch.float32, torch.bfloat16)
KERNELS = ("bmatvec", "bmatvec_t")


def parse_variant(spec: str):
    name, _, body = spec.partition("=")
    changes = {}
    for item in filter(None, body.split(",")):
        key, _, value = item.partition(":")
        if not key.startswith("k") and key not in WRAPPER_ONLY:
            raise SystemExit(f"unknown constant {key!r} in {spec!r}")
        changes[key] = int(value)
    return name, changes


def build_variants(variants: dict) -> dict:
    """{name: loaded library} of every variant, built together."""
    source = (build.CSRC / "pdhg_matvec.cu").read_text()
    nvcc = build._nvcc()
    procs = {}
    for name, changes in variants.items():
        text = source
        for key, value in changes.items():
            if key.startswith("k"):
                text, n = re.subn(rf"constexpr int {key} = \d+;",
                                  f"constexpr int {key} = {value};", text)
                if n != 1:
                    raise SystemExit(f"{key} not found once in the source")
        out = OUT_DIR / name
        out.mkdir(parents=True, exist_ok=True)
        (out / "pdhg_matvec.cu").write_text(text)
        cmd = [nvcc, *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
               str(out / "pdhg_matvec.so"), str(out / "pdhg_matvec.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"variant {name} did not build:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas] {name}: {line.strip()}")
        libs[name] = ctypes.CDLL(str(OUT_DIR / name / "pdhg_matvec.so"))
    return libs


def use(lib, changes: dict, defaults: dict) -> None:
    """Point the wrapper at ``lib`` with the variant's constants."""
    for key, value in defaults.items():
        setattr(mv, key, value)
    for key, value in changes.items():
        if key == "COL_CHUNK_F32":
            mv.COL_CHUNK_BYTES = {**defaults["COL_CHUNK_BYTES"], 4: value}
        elif key in WRAPPER_NAME or key in WRAPPER_ONLY:
            setattr(mv, WRAPPER_NAME.get(key, key), value)
    saved, mv._lib = build.load, None
    build.load = lambda name: lib
    try:
        mv.library()
    finally:
        build.load = saved


def event_ms(fn, reps: int = 30, warmup: int = 3) -> float:
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


def check(A, x, y) -> dict:
    """Max abs error of each kernel against its plain version; raises
    where it is off or a call made other than one CUDA launch."""
    tol = 1e-4 if A.dtype == torch.float32 else 2e-2
    errs = {}
    for name, v in (("bmatvec", x), ("bmatvec_t", y)):
        fn = getattr(ops, name)
        before = mv.CUDA_LAUNCHES[name]
        got = fn(A, v, backend="kernel")
        torch.cuda.synchronize()
        if mv.CUDA_LAUNCHES[name] - before != 1:
            raise SystemExit(f"{name}: not one CUDA launch a call")
        want = fn(A, v, backend="ref")
        err = (got - want).abs()
        if not bool((err <= tol + tol * want.abs()).all()):
            raise SystemExit(f"{name} {A.dtype}: off by {float(err.max())}")
        errs[name] = float(err.max())
    return errs


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({exc})"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--shape", type=int, nargs=3, default=(8, 4099, 6145))
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("matvec_variants: no CUDA device", file=sys.stderr)
        return 2
    variants = dict([("base", {})] + [parse_variant(v) for v in args.variant])
    defaults = {name: getattr(mv, name) for name in SAVED}
    libs = build_variants(variants)
    k, m, n = args.shape
    g = torch.Generator(device="cuda").manual_seed(0)
    # entries of 1/sqrt(N), so the f32 rounding of each sum stays below
    # the 1e-4 product tolerance
    A32 = torch.randn((k, m, n), generator=g, device="cuda") / n ** 0.5
    x = torch.randn((k, n), generator=g, device="cuda")
    y = torch.randn((k, m), generator=g, device="cuda")
    As = {dt: A32.to(dt) for dt in DTYPES}
    card = card_line()
    print(f"[card] {torch.cuda.get_device_name(0)}; {card}")
    errs, failed = {}, []
    for name, lib in list(libs.items()):
        use(lib, variants[name], defaults)
        try:
            for dt, A in As.items():
                errs[f"{name} {str(dt)[6:]}"] = check(A, x, y)
        except (RuntimeError, SystemExit) as exc:
            print(f"[check] variant {name} failed: {exc}")
            failed.append(name)
            del libs[name]
    print(f"[check] max abs err against the plain versions: {errs}")

    def bmm(A, name):
        if name == "bmatvec":
            return lambda: torch.bmm(A, x.to(A.dtype)[:, :, None])
        return lambda: torch.bmm(y.to(A.dtype)[:, None, :], A)

    best: dict = {}
    order = ["torch.bmm", *libs]
    for rnd in range(args.rounds):
        for who in (order if rnd % 2 == 0 else order[::-1]):
            if who != "torch.bmm":
                use(libs[who], variants[who], defaults)
            for dt, A in As.items():
                for name in KERNELS:
                    v = x if name == "bmatvec" else y
                    fn = (bmm(A, name) if who == "torch.bmm" else
                          (lambda A=A, v=v, name=name:
                           getattr(mv, name)(A, v)))
                    key = f"{who} {name} {str(dt)[6:]}"
                    best[key] = min(best.get(key, float("inf")),
                                    event_ms(fn))
    for key, ms in best.items():
        print(f"[ms] {key}: {ms:.4f}")
    (OUT_DIR / "ms.json").write_text(json.dumps(dict(
        device=torch.cuda.get_device_name(0), card=card, shape=args.shape,
        variants=variants, max_abs_err=errs, ms=best, failed=failed),
        indent=1))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
