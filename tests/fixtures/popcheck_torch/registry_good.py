"""Good twin: one fill style each, as the built-in domains do it."""
from repro_torch.domains.base import DomainSpec


def _step(inst, solve, exec_cfg, warm):
    return None


def _problem(inst):
    return None


def _hook(*a):
    return None


VIA_PROBLEM = DomainSpec(
    name="via_problem",
    problem=_problem,
    round=_hook,            # shared hooks are fine with problem=
    evaluate=_hook,
)

VIA_OVERRIDE = DomainSpec(
    name="via_override",
    step_override=_step,
    round=_hook,            # round/evaluate run on the override's output
    evaluate=_hook,
)

DECLARATIVE = DomainSpec(
    name="declarative",
    n_entities=len,
    entity_attrs=_hook,
    build_sub=_hook,
    K_mv=_hook,
    KT_mv=_hook,
    extract=_hook,
    sub_layout=_hook,
)
