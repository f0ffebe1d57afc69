"""Build and load the hand-written CUDA kernels of ``csrc/``.

Every ``csrc/*.cu`` source becomes one shared library with a plain C
interface, compiled by ``nvcc -gencode arch=compute_90a,code=sm_90a -O3
-shared -Xcompiler -fPIC`` into ``build/repro_torch_kernels/`` at the
repository root and loaded with ``ctypes``.  The libraries are keyed on a
hash of every file in ``csrc/`` (sources and shared headers) and the flags,
and the first :func:`build` starts one ``nvcc`` per missing library, all at
once, and waits for them together.  Nothing is built when this module is
imported, and a failed build raises: there is no fallback.  One lock
serialises :func:`build` and :func:`load` across the threads of a process
(the serving dispatcher's worker and the callers' threads may touch the
kernels first together), and each build writes a temporary file named by
process and thread before it renames it into place.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# what the last build of each library printed (ptxas register and spill
# report) and how long it took, by source name
build_info: dict = {}
_libs: dict = {}
# held by build() and load(): one thread builds, the others wait and find
# the libraries built
_lock = threading.RLock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       f"{cuda_home}/bin); the CUDA kernels cannot be built")


def sources() -> list:
    """The kernel sources: one library each."""
    return sorted(CSRC.glob("*.cu"))


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives for the
    current sources and flags."""
    return BUILD_DIR / f"{name}-{_key()}.so"


def build() -> dict:
    """Compile every library not built yet, one ``nvcc`` per source, all
    started together; returns ``{name: path}``."""
    with _lock:
        return _build()


def _build() -> dict:
    paths = {src.stem: library_path(src.stem) for src in sources()}
    todo = {name: path for name, path in paths.items() if not path.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name, out in todo.items():
        tmp = out.with_name(
            f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (cmd, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (cmd, tmp, out, proc) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{stderr}")
            continue
        os.replace(tmp, out)
        build_info[name] = dict(seconds=time.perf_counter() - t0,
                                log=stdout + stderr)
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (building every missing
    library first)."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(build()[name]))
        return _libs[name]
