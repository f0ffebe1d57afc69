"""POP core in PyTorch: solver, partitioning, planning, execution."""
