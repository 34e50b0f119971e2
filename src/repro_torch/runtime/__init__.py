"""Runtime: ``ServeEngine`` (prefill, then greedy decode) and
``ReplicaDispatcher`` (DFPA over request chunks across serving replicas,
one tenant through ``Scheduler`` or many through ``FleetScheduler``), the
straggler detector (``StragglerDetector``, ``StragglerAction``), which
``core.Scheduler.straggler_actions`` drives, and the deprecated
``BalanceController`` / ``GroupTimer`` / ``elastic_rebalance`` shims over
``Scheduler``.  The training loop comes later (ROADMAP queue 1, item 10:
what remains of the LLM stack)."""

from .balance import BalanceController, GroupTimer
from .elastic import elastic_rebalance
from .serve_loop import ReplicaDispatcher, ServeEngine
from .straggler import StragglerAction, StragglerDetector

__all__ = [
    "ServeEngine",
    "ReplicaDispatcher",
    "BalanceController",
    "GroupTimer",
    "StragglerDetector",
    "StragglerAction",
    "elastic_rebalance",
]
