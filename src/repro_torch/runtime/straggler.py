"""Straggler mitigation via FPM residuals (beyond-paper use of the model).

The paper's FPM predicts what a healthy group's step SHOULD take at its
current allocation.  A group whose observed time exceeds its own prediction
by ``factor`` for ``patience`` consecutive steps is flagged:

  * REPROFILE — its FPM points are stale (thermal throttling, recovered
    preemption): invalidate them so DFPA re-learns the speed function;
  * QUARANTINE — persistent (factor_hard) offender: remove from the group
    set entirely (the elastic path redistributes its units).

This turns the paper's performance model into a health detector — the
observation→model→action loop the paper uses for balance, reused for fault
tolerance.  ``Scheduler.straggler_actions`` runs it over a session's host
bank and applies REPROFILE itself; the caller acts on QUARANTINE with
``Scheduler.leave``.  The reference package's detector, copied: it reads
host numpy models only, so it is the same on every backend of the port.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.fpm import PiecewiseLinearFPM
from ..core.modelbank import ModelBank

try:  # telemetry is optional: detection runs identically without obs/
    from ..obs.telemetry import active as _obs_active
except ImportError:  # pragma: no cover - obs layer absent
    def _obs_active():
        return None

__all__ = ["StragglerAction", "StragglerDetector"]


class StragglerAction(Enum):
    NONE = "none"
    REPROFILE = "reprofile"
    QUARANTINE = "quarantine"


@dataclass
class StragglerDetector:
    factor: float = 1.5  # observed / predicted ratio that counts as a strike
    factor_hard: float = 3.0  # instant-escalation ratio
    patience: int = 3  # consecutive strikes before REPROFILE
    patience_hard: int = 6  # consecutive strikes before QUARANTINE

    # Both maps are keyed by the CURRENT group index space.  When the group
    # set changes (``Scheduler.resize``/``join``/``leave``), the detector
    # must be remapped through :meth:`remap` — carrying it across a resize
    # unmapped makes every survivor inherit its departed neighbour's strike
    # count and can falsely quarantine a healthy group.
    strikes: Dict[int, int] = field(default_factory=dict)
    history: List[tuple] = field(default_factory=list)

    def remap(self, surviving: Sequence[int], joined: int = 0) -> "StragglerDetector":
        """New detector for a resized group set: survivor ``surviving[j]``
        keeps its strike count under its new index ``j``, departed groups'
        strikes are dropped, and ``joined`` newcomers start clean.
        ``history`` rows are remapped the same way (departed groups' rows
        dropped) so post-resize forensics read in the new index space."""
        new_of = {int(old): new for new, old in enumerate(surviving)}
        det = StragglerDetector(
            factor=self.factor,
            factor_hard=self.factor_hard,
            patience=self.patience,
            patience_hard=self.patience_hard,
        )
        det.strikes = {
            new_of[g]: s for g, s in self.strikes.items() if g in new_of
        }
        det.history = [
            (new_of[row[0]], *row[1:]) for row in self.history if row[0] in new_of
        ]
        return det

    def update(
        self,
        group: int,
        model: PiecewiseLinearFPM,
        d_units: int,
        observed_t: float,
    ) -> StragglerAction:
        if model.num_points == 0 or d_units <= 0 or observed_t <= 0:
            return StragglerAction.NONE
        predicted = model.time(float(d_units))
        if predicted <= 0:
            return StragglerAction.NONE
        ratio = observed_t / predicted
        self.history.append((group, d_units, predicted, observed_t, ratio))
        return self._strike(group, ratio)

    def update_batch(
        self,
        bank: ModelBank,
        d_units: Sequence[int],
        observed: Sequence[float],
    ) -> List[StragglerAction]:
        """Fleet-wide strike update: ONE batched ``bank.time`` pass predicts
        every group's healthy step time, then the scalar strike automaton runs
        only on the few groups whose prediction is usable.

        ``bank`` is the session's host model-bank snapshot
        (``Scheduler.store.bank()``); returns one action per group.
        Equivalent to calling :meth:`update` per group, without the ``p``
        scalar ``time`` evaluations.
        """
        d = np.asarray(d_units, dtype=np.float64)
        obs = np.asarray(observed, dtype=np.float64)
        predicted = bank.time(d)
        usable = (bank.counts > 0) & (d > 0) & (obs > 0) & (predicted > 0)
        actions = [StragglerAction.NONE] * bank.p
        for g in np.nonzero(usable)[0]:
            g = int(g)
            ratio = float(obs[g] / predicted[g])
            self.history.append((g, int(d[g]), float(predicted[g]), float(obs[g]), ratio))
            actions[g] = self._strike(g, ratio)
        return actions

    def _strike(self, group: int, ratio: float) -> StragglerAction:
        if ratio < self.factor:
            self.strikes[group] = 0
            return StragglerAction.NONE
        s = self.strikes.get(group, 0) + (2 if ratio >= self.factor_hard else 1)
        self.strikes[group] = s
        if s >= self.patience_hard:
            self.strikes[group] = 0
            self._report(group, ratio, s, StragglerAction.QUARANTINE)
            return StragglerAction.QUARANTINE
        if s >= self.patience:
            self._report(group, ratio, s, StragglerAction.REPROFILE)
            return StragglerAction.REPROFILE
        self._report(group, ratio, s, StragglerAction.NONE)
        return StragglerAction.NONE

    def _report(
        self, group: int, ratio: float, strikes: int, verdict: StragglerAction
    ) -> None:
        """Mirror a strike (and its verdict, if any) into telemetry with the
        (predicted, observed) evidence from the matching history row."""
        tel = _obs_active()
        if tel is None or not tel.enabled:
            return
        evidence = {}
        if self.history and self.history[-1][0] == group:
            _, d_units, predicted, observed, _ = self.history[-1]
            evidence = {
                "d_units": int(d_units),
                "predicted": float(predicted),
                "observed": float(observed),
            }
        tel.counter("straggler.strike")
        tel.event("straggler.strike", group=int(group), ratio=float(ratio),
                  strikes=int(strikes), **evidence)
        if verdict is not StragglerAction.NONE:
            tel.counter(f"straggler.{verdict.value}")
            tel.event("straggler.verdict", group=int(group),
                      action=verdict.value, ratio=float(ratio),
                      strikes=int(strikes), **evidence)

    def reprofile(self, controller, group: int) -> None:
        """Invalidate a group's FPM (keep only the freshest operating point
        so the partitioner stays feasible).

        ``Scheduler`` implements this itself (``Scheduler.reprofile``; wired
        automatically by ``Scheduler.straggler_actions``) — delegate when
        available (``BalanceController`` delegates to its ``Scheduler``),
        keep the legacy in-place mutation for duck-typed controllers."""
        if hasattr(controller, "reprofile"):
            controller.reprofile(group)
            return
        m = controller.models[group]
        if m.num_points > 1:
            # keep the most recent point at the current allocation if present
            di = controller.d[group]
            pts = [(x, s) for x, s in m.as_points() if x == float(di)]
            controller.models[group] = (
                PiecewiseLinearFPM.from_points(pts) if pts else PiecewiseLinearFPM()
            )
        keys = [k for k in controller._ema if k[0] == group]
        for k in keys:
            del controller._ema[k]
        # A device-resident bank carry on the controller now disagrees with
        # the scalar models; drop it so it rebuilds lazily.
        if getattr(controller, "_device_bank", None) is not None:
            controller._device_bank = None
