"""One reader per per-layer metric: ``popbench/metrics/<name>.py`` defines
``read(run: popbench.trace.TraceRun) -> float | None``.  A reader that
finds nothing to read returns None, and the run leaves the metric out."""
