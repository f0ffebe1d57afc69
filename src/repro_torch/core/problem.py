"""Canonical-form LP constants (counterpart of ``repro/core/problem.py``).

Only the ``BIG`` sentinel is ported so far: the dense ``LinearProgram``
container and ``stack_lps`` belong to the dense path (ROADMAP item 9).
Padding is self-neutralising exactly as in the reference: padded
variables get ``l = u = 0``, padded inequality rows ``h = +BIG``.
"""

from __future__ import annotations

BIG = 1e9  # stand-in for +inf in padded rows / free bounds (f32-safe)
