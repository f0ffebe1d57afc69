"""Good twin: dict inputs frozen to item tuples in __post_init__ (the
SolveConfig/ExecConfig pattern), eq and hash defined together."""
import dataclasses
from typing import Union


@dataclasses.dataclass(frozen=True)
class FrozenConfig:
    solver_kw: Union[dict, tuple] = ()

    def __post_init__(self):
        if isinstance(self.solver_kw, dict):
            object.__setattr__(self, "solver_kw",
                               tuple(sorted(self.solver_kw.items())))


class EqAndHash:
    def __eq__(self, other):
        return isinstance(other, EqAndHash)

    def __hash__(self):
        return hash(type(self))
