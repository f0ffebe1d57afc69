"""POP core in PyTorch: solver, partitioning, planning, execution.

Re-exports the names ``repro/core/__init__.py`` does, under the same
``__all__``, so ``from repro_torch.core import ExecConfig, SolveConfig,
pop, skewed_partition`` is the twin of the reference's import."""

from .problem import LinearProgram, MixedIntegerProgram, stack_lps, BIG
from .pdhg import (
    OperatorLP, SolveResult, solve, solve_stacked, solve_dense, solve_batched,
    dense_ops, dense_K_mv, dense_KT_mv, ruiz_equilibrate,
    StepEngine, matvec_engine, fused_dense_engine, fused_structured_engine,
    fused_structured_full_engine, select_engine,
    StructuredOperator, structured_from_coo, structured_to_dense, stack_ops,
    quantize_structured, dequantize_structured,
    scale_operator, unscale_solution,
)
from .partition import (
    random_partition, stratified_partition, stratified_partition_multidim,
    clustered_partition, skewed_partition, similarity_report,
)
from .replicate import ReplicationPlan, plan_replication, replicated_partition
from .reduce import coalesce_concat, coalesce_replicated
from .backends import (
    MAP_BACKENDS, available_backends, get_backend, register_backend,
    select_backend, resolve_exec, solve_map, solve_one, make_map_solver,
)
from .config import SolveConfig, ExecConfig
from .plan import PopPlan, SubLayout, WarmStart, remap_warm
from .pop import (POPProblem, POPResult, FullResult, pop_solve,
                  solve_instance, solve_full, solve_full_ex)
from .maxmin import epigraph_rows, maxmin_objective
from .rounding import round_relaxation

__all__ = [
    "LinearProgram", "MixedIntegerProgram", "stack_lps", "BIG",
    "OperatorLP", "SolveResult", "solve", "solve_stacked", "solve_dense",
    "solve_batched",
    "dense_ops", "dense_K_mv", "dense_KT_mv", "ruiz_equilibrate",
    "StepEngine", "matvec_engine", "fused_dense_engine",
    "fused_structured_engine", "fused_structured_full_engine",
    "select_engine",
    "StructuredOperator", "structured_from_coo", "structured_to_dense",
    "stack_ops", "quantize_structured", "dequantize_structured",
    "scale_operator", "unscale_solution",
    "random_partition", "stratified_partition", "stratified_partition_multidim",
    "clustered_partition", "skewed_partition", "similarity_report",
    "ReplicationPlan", "plan_replication", "replicated_partition",
    "coalesce_concat", "coalesce_replicated",
    "MAP_BACKENDS", "available_backends", "get_backend", "register_backend",
    "select_backend", "resolve_exec", "solve_map", "solve_one",
    "make_map_solver",
    "SolveConfig", "ExecConfig",
    "PopPlan", "SubLayout", "WarmStart", "remap_warm",
    "POPProblem", "POPResult", "FullResult", "pop_solve", "solve_instance",
    "solve_full", "solve_full_ex",
    "epigraph_rows", "maxmin_objective",
    "round_relaxation",
]
