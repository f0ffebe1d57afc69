"""The kernel build (``repro_torch.kernels.build``) under threads, on the
CPU: ``nvcc`` is replaced by a fake that writes its ``-o`` file, so the
locking and the temporary files are what is tested."""

import sys
import threading
import time

import pytest

from repro_torch.kernels import build


class FakeNvcc:
    """``subprocess.Popen`` of a fake nvcc: writes its ``-o`` file after a
    pause (long enough for a second thread to start its own build) and
    records every call."""

    calls: list = []
    lock = threading.Lock()

    def __init__(self, cmd, **kw):
        self.cmd = cmd
        self.returncode = None
        with self.lock:
            FakeNvcc.calls.append(cmd)

    def communicate(self):
        time.sleep(0.1)
        out = self.cmd[self.cmd.index("-o") + 1]
        with open(out, "wb") as f:
            f.write(b"library " + self.cmd[-1].encode())
        self.returncode = 0
        return "", "ptxas info: fake\n"


@pytest.fixture
def fake_nvcc(monkeypatch, tmp_path):
    FakeNvcc.calls = []
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "Popen", FakeNvcc)
    return tmp_path / "kernels"


def test_two_threads_build_each_library_once(fake_nvcc):
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    barrier, results = threading.Barrier(2), []

    def run():
        barrier.wait()
        results.append(build.build())

    threads = [threading.Thread(target=run) for _ in range(2)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and len(results) == 2
    names = sorted(src.stem for src in build.sources())
    assert sorted(results[0]) == names and results[0] == results[1]
    built = sorted(c[-1] for c in FakeNvcc.calls)
    assert built == sorted(str(build.CSRC / f"{n}.cu") for n in names)
    for name, path in results[0].items():
        assert path.read_bytes() == \
            b"library " + str(build.CSRC / f"{name}.cu").encode()
    assert not list(fake_nvcc.glob("*.tmp"))
    # a build with every library present starts no nvcc
    assert build.build() == results[0] and len(FakeNvcc.calls) == len(names)


def test_temporary_files_are_named_by_process_and_thread(fake_nvcc):
    build.build()
    tmps = [c[c.index("-o") + 1] for c in FakeNvcc.calls]
    ident = f".{build.os.getpid()}.{threading.get_ident()}.tmp"
    assert tmps and all(t.endswith(ident) for t in tmps)
