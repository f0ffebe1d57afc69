"""Known-bad fixture: DomainSpec fill-style contract violations."""
from repro_torch.domains.base import DomainSpec


def _step(inst, solve, exec_cfg, warm):
    return None


def _problem(inst):
    return None


def _build(inst, idx_row, frac, scale):
    return None


# BAD: no problem=, no step_override=, declarative hooks incomplete
INCOMPLETE = DomainSpec(
    name="incomplete",
    n_entities=len,
    build_sub=_build,
)

# BAD: step_override plus pipeline hooks the override silently ignores
OVERRIDE_MIX = DomainSpec(
    name="override_mix",
    step_override=_step,
    problem=_problem,
    K_mv=_build,
)

# BAD: problem factory mixed with declarative builder hooks
PROBLEM_MIX = DomainSpec(
    name="problem_mix",
    problem=_problem,
    build_sub=_build,
    extract=_build,
)
