"""Good twin: the one public surface — solve_instance / solve_full_ex /
sessions; problem METHODS named like the doors are the problem's own API
and are fine."""
from repro_torch.core import ExecConfig, SolveConfig, pop
from repro_torch.service import PopService


def run(prob, lb_prob, inst):
    full = pop.solve_full_ex(prob, exec_cfg=ExecConfig())
    r = pop.solve_instance(prob, SolveConfig(k=4), ExecConfig())
    sess = PopService().session("tenant", domain="gavel")
    alloc = sess.step(inst)
    # method calls, not module doors: LoadBalanceProblem's own surface
    lb = lb_prob.pop_solve(4, solver_kw={})
    lb_full = lb_prob.solve_full(solver_kw={})
    return full, r, alloc, lb, lb_full
