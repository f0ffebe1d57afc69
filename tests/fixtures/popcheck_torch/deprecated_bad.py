"""Known-bad fixture: internal code going through the compat doors."""
from repro_torch.core import pop
from repro_torch.core.pop import pop_solve
from repro_torch.sched.gavel_service import GavelScheduler


def run(prob, wl):
    alloc, res, t, _ = pop.solve_full(prob, solver_kw={})      # BAD
    r = pop_solve(prob, 4, strategy="stratified")              # BAD
    sched = GavelScheduler(wl)                                 # BAD
    return alloc, r, sched
