"""Elastic scaling: group join/leave -> warm-started DFPA re-partition.

.. deprecated::
    Elastic membership now lives on the facade —
    :meth:`repro_torch.core.scheduler.Scheduler.join` /
    :meth:`~repro.core.scheduler.Scheduler.leave` /
    :meth:`~repro.core.scheduler.Scheduler.resize` — which keep the
    survivors' FPM points (the paper's §3.2 trick of reusing all previous
    benchmark results), seed joiners from the fastest survivor's estimate,
    and re-partition immediately.  :func:`elastic_rebalance` remains as a
    thin shim delegating to ``Scheduler.resize``.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ..core.speedstore import _warn_legacy
from .balance import BalanceController

__all__ = ["elastic_rebalance"]


def elastic_rebalance(
    controller: BalanceController,
    surviving: Sequence[int],
    joined: int = 0,
    *,
    caps: Optional[Sequence[int]] = None,
) -> BalanceController:
    """Build a controller for the new group set.

    ``surviving`` — indices (into the old controller) still alive;
    ``joined``    — number of new groups appended after the survivors.

    .. deprecated:: use ``Scheduler.resize`` (or the in-place
       ``Scheduler.join`` / ``Scheduler.leave``).
    """
    _warn_legacy("elastic_rebalance()", "Scheduler.resize()/join()/leave()")
    sched = controller._sched if isinstance(controller, BalanceController) else controller
    return BalanceController._wrap(sched.resize(surviving, joined=joined, caps=caps))
