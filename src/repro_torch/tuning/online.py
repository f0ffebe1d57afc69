"""The online refiner: per-session curve estimates + SLO-driven retuning
— the port of ``repro/tuning/online.py``, line for line (pure Python).

A tuned session (``PopService.session(tenant, instance, slo=...)``) owns
one :class:`OnlineTuner`.  Every fault-free step feeds the tuner the
:class:`~repro_torch.service.Allocation`'s reported solve time and domain
quality scalar; the tuner EMA-updates its per-k estimates and **re-plans
only when the SLO is violated or newly slack** — never on noise:

* violations must persist ``patience`` consecutive steps before a move,
* every move is one power-of-two notch of k (the stack shapes a
  session meets stay O(log) like the degradation ladder's budgets),
* after a move the tuner holds still for ``cooldown`` steps so the new
  operating point gets measured before it is judged,
* a quality violation first escalates replication at the current k (the
  granular-POP recovery) when the profile has rows for it, and only then
  shrinks k.

The session routes a retuned ``SolveConfig`` through the normal
``prepare_instance`` path, so the existing ``repair_plan``/``remap_warm``
machinery carries warm state across the k change — retuning never costs
a cold start.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..core.config import ExecConfig, SolveConfig
from .profile import TuningProfile
from .slo import SLOTarget, TunedPlan, latency_at, plan_for_slo, \
    quality_loss_at

__all__ = ["OnlineTuner", "TuneEvent"]

_EMA = 0.5


@dataclasses.dataclass
class TuneEvent:
    """What one observation decided: the violation recorded this step (if
    any) and the new config to apply from the next step (if retuned)."""

    violation: Optional[str] = None      # "latency" | "quality" | None
    new_solve: Optional[SolveConfig] = None


class OnlineTuner:
    """Per-session curve refinement + re-planning against one SLO."""

    def __init__(self, profile: Optional[TuningProfile], domain: str,
                 slo: SLOTarget, base_solve: SolveConfig,
                 base_exec: ExecConfig, *, patience: int = 2,
                 cooldown: int = 3):
        self.profile = profile
        self.domain = domain
        self.slo = slo
        self.base_solve = base_solve
        self.base_exec = base_exec
        self.patience = max(int(patience), 1)
        self.cooldown = max(int(cooldown), 0)
        self.plan: Optional[TunedPlan] = None
        self.solve_cfg: Optional[SolveConfig] = None
        self.n_entities: Optional[int] = None
        # online estimates, keyed by the k that actually ran
        self.lat_ema: dict = {}
        self.qual_ema: dict = {}
        self._hot = 0            # consecutive violated steps
        self._slack = 0          # consecutive clearly-slack steps
        self._cool = 0           # steps left before the next move may fire

    # ---------------------------------------------------------- planning --
    def plan_initial(self, n_entities: int) -> SolveConfig:
        """The offline pick for this instance size (identity when the
        profile carries no curves for the domain)."""
        self.n_entities = int(n_entities)
        if self.profile is not None:
            self.plan = plan_for_slo(self.profile, self.domain, n_entities,
                                     self.slo, self.base_solve,
                                     self.base_exec)
            self.solve_cfg = self.plan.solve
        else:
            self.solve_cfg = self.base_solve
        return self.solve_cfg

    def ensure_planned(self, n_entities: int,
                       current: SolveConfig) -> Optional[SolveConfig]:
        """First-step hook for sessions created without an instance:
        returns the planned config once, None after."""
        if self.solve_cfg is not None:
            return None
        cfg = self.plan_initial(n_entities)
        return cfg if cfg != current else None

    # ------------------------------------------------------- observation --
    def observe(self, k: int, solve_time_s: float,
                quality: Optional[float]) -> TuneEvent:
        """Fold one fault-free step's measurements in; decide whether to
        move.  Returns the step's :class:`TuneEvent`."""
        k = max(int(k), 1)
        if solve_time_s > 0.0:
            old = self.lat_ema.get(k)
            self.lat_ema[k] = (solve_time_s if old is None
                               else (1 - _EMA) * old + _EMA * solve_time_s)
        if quality is not None and quality > 0.0:
            old = self.qual_ema.get(k)
            self.qual_ema[k] = (quality if old is None
                                else (1 - _EMA) * old + _EMA * quality)
        if self._cool > 0:
            self._cool -= 1

        violation = self._violation(k)
        ev = TuneEvent(violation=violation)
        if violation is not None:
            self._hot += 1
            self._slack = 0
            if self._hot >= self.patience and self._cool == 0:
                ev.new_solve = self._move(k, violation)
        else:
            self._hot = 0
            if self._newly_slack(k):
                self._slack += 1
                if self._slack >= self.patience and self._cool == 0:
                    ev.new_solve = self._move(k, "slack")
            else:
                self._slack = 0
        if ev.new_solve is not None:
            self._hot = self._slack = 0
            self._cool = self.cooldown
            self.solve_cfg = ev.new_solve
        return ev

    # ---------------------------------------------------------- decisions --
    def _violation(self, k: int) -> Optional[str]:
        dl = self.slo.step_deadline_s
        lat = self.lat_ema.get(k)
        if dl is not None and lat is not None and lat > dl:
            return "latency"
        loss = self._observed_loss(k)
        if loss is not None and loss > self.slo.max_quality_loss + 1e-9:
            return "quality"
        return None

    def _observed_loss(self, k: int) -> Optional[float]:
        """Estimated relative quality loss at k vs the best quality this
        session has observed at any SMALLER k (smaller k = closer to the
        full solve; comparing against larger k would read improvement as
        loss)."""
        q = self.qual_ema.get(k)
        if q is None:
            return None
        ref = max((v for kk, v in self.qual_ema.items() if kk < k),
                  default=None)
        if ref is None or ref <= 0.0:
            return None
        return max(1.0 - q / ref, 0.0)

    def _newly_slack(self, k: int) -> bool:
        """A deadline-limited pick can step back toward quality once the
        measured latency shows the next-smaller k would comfortably fit:
        the curves' k->k/2 latency ratio applied to the measured EMA must
        stay under 80% of the deadline."""
        dl = self.slo.step_deadline_s
        if dl is None or k <= 1 or self.profile is None:
            return False
        if self.plan is None or self.plan.source not in ("deadline-limited",
                                                         "replicated"):
            return False
        if quality_loss_at_or_zero(self.profile, self.domain, k) <= \
                self.slo.max_quality_loss:
            return False                   # current k already loses nothing
        lat = self.lat_ema.get(k)
        curves = self.profile.domains.get(self.domain)
        if lat is None or curves is None:
            return False
        t_k = latency_at(curves, k, self.n_entities)
        t_half = latency_at(curves, k // 2, self.n_entities)
        if not t_k or t_half is None:
            return False
        return lat * (t_half / t_k) <= 0.8 * dl

    def _move(self, k: int, why: str) -> Optional[SolveConfig]:
        """One pow2 notch in the direction ``why`` demands; None when the
        move is impossible (already at the edge)."""
        cur = self.solve_cfg or self.base_solve
        if why == "latency":
            new_k = k * 2
            if self.n_entities is not None:
                if new_k * 2 > max(self.n_entities, 2):
                    return None
                cand = dataclasses.replace(cur, k=new_k)
                # min_per_sub clamping can void the move: don't churn the
                # config (and the retune counter) for an unchanged split
                if cand.k_for(self.n_entities) == \
                        cur.k_for(self.n_entities):
                    return None
                return cand
            return dataclasses.replace(cur, k=new_k)
        # quality violated (or slack): first try replication at this k,
        # then halve
        if why == "quality" and self.profile is not None \
                and cur.replicate_threshold is None:
            curves = self.profile.domains.get(self.domain)
            rows = [r for r in (curves.replication if curves else ())
                    if int(r[0]) == k
                    and 1.0 - r[2] <= self.slo.max_quality_loss + 1e-12]
            if rows:
                thr = min(rows, key=lambda r: 1.0 - r[2])[1]
                return dataclasses.replace(cur, replicate_threshold=thr)
        if k <= 1:
            return None
        return dataclasses.replace(cur, k=k // 2, replicate_threshold=None)


def quality_loss_at_or_zero(profile: TuningProfile, domain: str,
                            k: int) -> float:
    curves = profile.domains.get(domain)
    return 0.0 if curves is None else quality_loss_at(curves, k)
