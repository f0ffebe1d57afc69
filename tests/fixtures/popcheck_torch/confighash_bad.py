"""Known-bad fixture: cache-key classes that cannot actually hash."""
import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class LeakyConfig:
    # BAD: dict/Tensor fields on a frozen dataclass, never re-frozen —
    # hash(LeakyConfig(...)) raises (or compares elementwise) and every
    # keyed cache breaks
    solver_kw: dict = dataclasses.field(default_factory=dict)
    weights: torch.Tensor = None


class EqOnly:
    # BAD: __eq__ without __hash__ -> Python sets __hash__ = None
    def __eq__(self, other):
        return isinstance(other, EqOnly)
