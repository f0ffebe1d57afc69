"""The port's train step (``repro_torch.train.train_step``) against the
reference's ``make_train_step`` under ``jax.jit``, on the CPU, for each of
the 10 reduced architectures at 1 and 2 microbatches over two steps.

Parameters come from the reference's ``init_params`` through
``interop.params_from_numpy``; batches are drawn with numpy from a seed
(``testing.train_batch``), and every MoE routing of the port is checked
for a tie at the top-k cut (``testing.router_tie_guard``).  The optimizer
runs at ``testing.PARITY_ADAMW`` in both packages (the full 3e-4 at step
1, eps 1e-6: at eps 1e-8 a gradient within f32 noise of zero moves its
parameter by anything in +-lr).

Tolerances (f32 on the CPU; the two packages run the same products in
another order; measured maxima in brackets, zamba2's Mamba2 the largest):
the loss within ``F32_TOL`` (9.5e-7), grad_norm within ``F32_TOL`` of its
value (6.6e-6), lr equal (equal), parameters within ``F32_TOL`` (1.6e-5),
m and v within ``MOMENT_RTOL`` of each leaf's largest (1.9e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro import models as rmodels
from repro.train import optimizer as ropt
from repro.train.train_step import TrainConfig as RTrainConfig
from repro.train.train_step import make_train_step as rmake_train_step
from repro_torch import configs as tconfigs
from repro_torch import testing
from repro_torch.interop import _paths, params_from_numpy
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import TrainConfig, make_train_step

F32_TOL = 1e-4
MOMENT_RTOL = 1e-3
B, S = 4, 8


def ref_paths(tree) -> dict:
    """``{a.0.b: numpy leaf}`` of a reference tree (the port's paths)."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {".".join(str(getattr(e, "key", getattr(e, "idx", e)))
                     for e in path): np.asarray(leaf) for path, leaf in flat}


def assert_trees(got, want: dict, what: str, atol=0.0, rtol_of_max=0.0):
    got = {k: v.detach().numpy() for k, v in _paths(got).items()}
    assert set(got) == set(want), what
    for k, w in want.items():
        bound = atol + rtol_of_max * float(np.abs(w).max())
        err = float(np.abs(got[k] - w).max())
        assert err <= bound, f"{what} {k}: {err} > {bound}"


@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("arch", rconfigs.ARCH_IDS)
def test_train_step_matches_reference(arch, n_micro):
    rcfg, tcfg = rconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    rp = rmodels.init_params(jax.random.PRNGKey(1), rcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, rp), tcfg, "cpu")
    rstep = jax.jit(rmake_train_step(rcfg, RTrainConfig(
        n_microbatches=n_micro, compute_dtype="float32",
        adamw=ropt.AdamWConfig(**testing.PARITY_ADAMW))))
    tstep = make_train_step(tcfg, TrainConfig(
        n_microbatches=n_micro, compute_dtype="float32",
        adamw=topt.AdamWConfig(**testing.PARITY_ADAMW)))
    ro, to = ropt.init_state(rp), topt.init_state(tp)
    for step in range(2):
        batch = testing.train_batch(tcfg, B, S, seed=step)
        rp, ro, rm = rstep(rp, ro, {k: jnp.asarray(v.numpy())
                                    for k, v in batch.items()})
        with testing.router_tie_guard():
            tp, to, tm = tstep(tp, to, batch)
        assert abs(float(tm["loss"]) - float(rm["loss"])) <= F32_TOL
        assert abs(float(tm["grad_norm"]) - float(rm["grad_norm"])) <= \
            F32_TOL * float(rm["grad_norm"])
        assert float(tm["lr"]) == float(rm["lr"])
        assert int(to.step) == int(ro.step) == step + 1
        assert_trees(tp, ref_paths(rp), f"step {step} params", atol=F32_TOL)
        assert_trees(to.m, ref_paths(ro.m), f"step {step} m",
                     rtol_of_max=MOMENT_RTOL)
        assert_trees(to.v, ref_paths(ro.v), f"step {step} v",
                     rtol_of_max=MOMENT_RTOL)
