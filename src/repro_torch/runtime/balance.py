"""BalanceController: the paper's DFPA running ONLINE inside training.

.. deprecated::
    The online loop lives on the facade —
    :class:`repro_torch.core.scheduler.Scheduler` (``observe`` /
    ``repartition`` / ``state_dict``) — with the model estimates in a
    ``SpeedStore`` whose backend is resolved once at construction.
    ``BalanceController`` remains as a thin wrapper that delegates every
    method to an internal ``Scheduler`` (``observe``/``bank``/
    ``device_bank`` emit ``DeprecationWarning``).  Its default backend is
    ``"numpy"`` (host); ``backend="torch"`` keeps the device-resident carry
    on ``device`` (``"cuda"`` by default).

The paper runs dedicated benchmark rounds; in a training loop every global
step already measures exactly what DFPA needs — ``t_i(d_i)`` for the current
distribution — so probing is FREE.  The controller:

  1. starts from the even distribution (or a warm start from checkpointed
     FPM points after an elastic event);
  2. after each global step, folds the observed per-group times into the
     piecewise-linear FPM estimates (the paper's step 5);
  3. when the imbalance exceeds ``eps``, re-partitions the units with the
     geometric algorithm of [16] (the paper's step 3);
  4. exposes its FPM points for checkpointing and the straggler detector.

EMA smoothing (``smooth``) de-noises wall-clock measurements — the paper's
deterministic-benchmark assumption does not hold for real step times.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from ..core.convert import scheduler_state_from_reference
from ..core.fpm import PiecewiseLinearFPM
from ..core.modelbank import ModelBank
from ..core.scheduler import Policy, Scheduler
from ..core.speedstore import SpeedStore, _warn_legacy

__all__ = ["BalanceController", "GroupTimer"]


@dataclass
class GroupTimer:
    """Host-side wall-clock timing of one group's step (the paper's
    ``t_i(d_i)`` measurement)."""

    _t0: float = 0.0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        return time.perf_counter() - self._t0


class BalanceController:
    """Legacy online-DFPA controller; now a shim over ``Scheduler``."""

    def __init__(
        self,
        n_units: int,
        num_groups: int,
        eps: float = 0.1,
        min_units: int = 1,
        smooth: float = 0.5,
        caps: Optional[Sequence[int]] = None,
        backend: str = "numpy",
        models: Optional[List[PiecewiseLinearFPM]] = None,
        d: Optional[List[int]] = None,
        device="cuda",
    ):
        store = (
            SpeedStore.from_models(models, backend=backend, device=device)
            if models
            else SpeedStore.empty(num_groups, backend=backend, device=device)
        )
        self._sched = Scheduler(
            store,
            policy=Policy.DFPA,
            n_units=n_units,
            eps=eps,
            min_units=min_units,
            caps=caps,
            smooth=smooth,
            backend=backend,
            device=device,
        )
        if d:
            self._sched.d = list(d)

    @classmethod
    def _wrap(cls, sched: Scheduler) -> "BalanceController":
        """Adopt an existing Scheduler without re-initialising (the elastic
        shim's path)."""
        self = object.__new__(cls)
        self._sched = sched
        return self

    # -- delegated configuration / state --------------------------------------

    @property
    def n_units(self) -> int:
        return self._sched.n_units

    @property
    def num_groups(self) -> int:
        return self._sched.num_groups

    @property
    def eps(self) -> float:
        return self._sched.eps

    @property
    def min_units(self) -> int:
        return self._sched.min_units

    @property
    def smooth(self) -> float:
        return self._sched.smooth

    @property
    def caps(self):
        return self._sched.caps

    @property
    def backend(self) -> str:
        return self._sched.backend

    @property
    def models(self) -> List[PiecewiseLinearFPM]:
        return self._sched.store.models

    @property
    def d(self) -> List[int]:
        return self._sched.d

    @d.setter
    def d(self, value) -> None:
        self._sched.d = list(value)

    @property
    def rebalances(self) -> int:
        return self._sched.rebalances

    @property
    def steps_observed(self) -> int:
        return self._sched.steps_observed

    @property
    def _ema(self) -> Dict:
        return self._sched._ema

    @property
    def _device_bank(self):
        return self._sched.store._tbank

    @_device_bank.setter
    def _device_bank(self, value) -> None:
        self._sched.store._tbank = value

    # -- the online DFPA loop -------------------------------------------------

    def observe(self, times: Sequence[float]) -> bool:
        """Fold one global step's per-group times in; returns True if the
        distribution changed.

        .. deprecated:: use ``Scheduler.observe``.
        """
        _warn_legacy("BalanceController.observe()", "Scheduler.observe()")
        return self._sched.observe(times)

    def bank(self) -> ModelBank:
        """Batched snapshot of the current per-group FPM estimates.

        .. deprecated:: use ``Scheduler.store.bank()``.
        """
        _warn_legacy("BalanceController.bank()", "SpeedStore.bank()")
        return self._sched.store.bank()

    def _carry_bank(self):
        """The internal fold-in carry (donation-eligible: its buffers may be
        consumed by the next ``observe``)."""
        return self._sched.store._carry()

    def device_bank(self):
        """The ``TorchModelBank`` snapshot the device partitioner consumes.

        .. deprecated:: use ``Scheduler.store.device_bank()``.
        """
        _warn_legacy("BalanceController.device_bank()", "SpeedStore.device_bank()")
        return self._sched.store.device_bank()

    def reprofile(self, group: int) -> None:
        """Invalidate a group's FPM estimate (straggler recovery)."""
        self._sched.reprofile(group)

    @property
    def imbalance_estimate(self) -> float:
        return self._sched.imbalance_estimate

    # -- persistence (self-adaptability across restarts) ----------------------

    def state_dict(self) -> Dict:
        """Full config + estimates (the legacy keys ``n_units``/``d``/
        ``points`` survive; ``backend``/``smooth``/``eps``/``min_units``/
        ``caps`` now round-trip too — the state-asymmetry fix)."""
        return self._sched.state_dict()

    @classmethod
    def from_state(cls, state: Dict, *, eps: Optional[float] = None, **kw) -> "BalanceController":
        """Restore a controller saved by :meth:`state_dict` — this package's
        or the reference's (its ``"jax"`` backend restores as ``"torch"``);
        ``kw`` override config fields (``backend=``, ``device=``, ...)."""
        state = scheduler_state_from_reference(state)
        models = [PiecewiseLinearFPM.from_points(p) for p in state["points"]]
        cfg = dict(
            eps=state.get("eps", 0.1) if eps is None else eps,
            min_units=state.get("min_units", 1),
            smooth=state.get("smooth", 0.5),
            caps=state.get("caps"),
            backend=state.get("backend", "numpy"),
        )
        cfg.update(kw)
        self = cls(
            n_units=state["n_units"],
            num_groups=len(models),
            models=models,
            d=list(state["d"]),
            **cfg,
        )
        self._sched._ema = {
            (int(g), int(du)): float(v) for g, du, v in state.get("ema", [])
        }
        self._sched.rebalances = int(state.get("rebalances", 0))
        self._sched.steps_observed = int(state.get("steps_observed", 0))
        return self
