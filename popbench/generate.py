"""The one general round generator.

A traffic mix is a JSON file ``popbench/traffic/<mix>.json`` of
parameters (``churn``: the share of entities replaced on a churn round,
``churn_every``: every how many rounds one comes; 0 for never).  The
configuration names its domain, and ``popbench/fleets/<domain>.py`` draws
that domain's fleet, its drift and its churn.  Round 0 is the initial
fleet; every later round drifts the previous one and, on every
``churn_every``-th round, churns it.

Every draw (the initial fleet, each round's drift and churn) comes from
one numpy Generator seeded with ``--seed``: the same seed gives the same
rounds, and every seed the same sizes and churn schedule.  Round ``r``
is the same for a seed however many rounds follow it."""

from __future__ import annotations

import importlib
import json
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent


def load_mix(name: str) -> dict:
    return json.loads((ROOT / "traffic" / f"{name}.json").read_text())


def fleet_module(domain: str):
    return importlib.import_module(f"popbench.fleets.{domain}")


class Rounds:
    """The rounds of one run: each call of :meth:`next` draws the next."""

    def __init__(self, config: dict, mix: dict, seed: int):
        self.config = config
        self.mix = mix
        self.fleet_mod = fleet_module(config["domain"])
        self.rng = np.random.default_rng(int(seed) % 2 ** 64)
        self.round = -1
        self.fleet = None
        self.next_id = 0

    def is_churn(self, r: int) -> bool:
        every = int(self.mix.get("churn_every", 0))
        return r > 0 and every > 0 and r % every == 0

    def next(self) -> dict:
        self.round += 1
        r = self.round
        if r == 0:
            self.fleet = self.fleet_mod.initial(self.config, self.rng)
        else:
            self.fleet = self.fleet_mod.drift(self.fleet, self.config,
                                              self.rng)
            if self.is_churn(r):
                self.fleet = self.fleet_mod.churn(
                    self.fleet, self.config, float(self.mix["churn"]),
                    self.rng, self.next_id)
        self.next_id = max(self.next_id, int(self.fleet["ids"].max()) + 1)
        return dict(self.fleet, round=r, churn=self.is_churn(r))
