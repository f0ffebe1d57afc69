"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program.  Module names are compared by
their whole top-level name: ``repro_torch`` is not ``repro``."""

import json
import subprocess
import sys

from popbench_tiny import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def tops_after(code: str) -> set:
    p = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                        "print(json.dumps(sorted({m.split('.')[0] for m in "
                        "sys.modules})))"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "PYTHONPATH": "src",
                            "HOME": str(ROOT / "build"),
                            "OMP_NUM_THREADS": "1"})
    assert p.returncode == 0, p.stderr[-2000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_the_jax_package():
    tops = tops_after(
        "import sys; sys.path.insert(0, 'popbench/tests')\n"
        "from popbench_tiny import run\n"
        "assert run(seconds=0.2, trace=True)['result']['correct']\n")
    assert "repro_torch" in tops
    assert not tops & FORBIDDEN, tops & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    tops = tops_after(
        "import popbench.reference.gavel, popbench.reference.pdhg\n"
        "import popbench.generate, popbench.fleets.gavel\n")
    assert not tops & (FORBIDDEN | {"repro_torch"})


def test_the_whole_name_is_compared():
    from popbench import run
    assert run.loaded_forbidden(["repro_torch.core", "reprox.y", "numpy",
                                 "jaxtyping"]) == []
    assert run.loaded_forbidden(["repro.core.pdhg", "jax", "flax.linen",
                                 "repro_torch"]) == ["flax", "jax", "repro"]
