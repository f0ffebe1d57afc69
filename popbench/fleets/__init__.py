"""Per-domain fleet generators: the initial fleet of a configuration, one
round's drift and one round's churn, drawn from a numpy ``Generator``.
Each module is a frozen copy of the port's own seeded workloads, so a
later change to the program cannot move the yardstick."""
