"""The window rule: every step that started before the deadline counts,
and the window lasts until the last of them ends."""

import numpy as np
import pytest

from popbench import window


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_window_keeps_the_step_that_crosses_the_deadline():
    clock = Clock()
    durations = iter([1.0, 1.0, 5.0, 1.0, 1.0])

    def step():
        d = next(durations)
        clock.t += d
        return d

    w = window.run_window(4.0, step, clock)
    assert w.walls == [1.0, 1.0, 5.0]          # the third started at 2 s
    assert w.seconds == pytest.approx(7.0)
    assert window.step_s(w) == pytest.approx(7.0 / 3)


def test_window_time_between_steps_counts():
    clock = Clock()

    def step():
        clock.t += 0.5                          # the round's generation
        clock.t += 1.0
        return 1.0

    w = window.run_window(3.0, step, clock)
    assert w.steps == 2
    assert window.step_s(w) == pytest.approx(1.5)


def test_p90_is_over_every_step():
    w = window.Window(0.0, 10.0, [1.0] * 9 + [11.0])
    assert window.step_p90_s(w) == pytest.approx(np.percentile(w.walls, 90))
    assert window.step_p90_s(w) == pytest.approx(2.0)
    w = window.Window(0.0, 10.0, [float(i) for i in range(1, 21)])
    assert window.step_p90_s(w) == pytest.approx(18.1)

