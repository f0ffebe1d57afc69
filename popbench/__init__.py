"""The benchmark of the PyTorch and CUDA port of POP (``repro_torch``).

One run drives one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix) through the port's ``PopService`` on one card, checks every
step of the timed window against the plain reference in
``popbench/reference/`` and prints one JSON line: see ``popbench/run.py``.
"""
