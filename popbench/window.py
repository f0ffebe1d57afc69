"""The timed window and the statistics of its steps.

The window opens when set-up ends.  It holds every step that *started*
before ``seconds`` had elapsed, and it lasts until the last of those steps
ends: a long step is never cut off and no fraction of a step counts."""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np


@dataclasses.dataclass
class Window:
    start: float
    end: float
    walls: list          # each step's wall seconds, in order

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @property
    def steps(self) -> int:
        return len(self.walls)


def run_window(seconds: float, step: Callable[[], float],
               clock: Callable[[], float] = time.perf_counter) -> Window:
    """Call ``step`` (which returns its own wall seconds) while fewer than
    ``seconds`` have passed since the window opened."""
    start = clock()
    end, walls = start, []
    while clock() - start < seconds:
        walls.append(step())
        end = clock()
    return Window(start, end, walls)


def step_s(w: Window) -> float:
    """The window's length over the steps it holds."""
    return w.seconds / w.steps


def step_p90_s(w: Window) -> float:
    """The 90th percentile of every step's wall time (linear between
    order statistics)."""
    return float(np.percentile(np.asarray(w.walls, np.float64), 90))
