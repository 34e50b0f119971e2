"""Runtime: ``ServeEngine`` (prefill, then greedy decode) and the straggler
detector (``StragglerDetector``, ``StragglerAction``), which
``core.Scheduler.straggler_actions`` drives.  ``ReplicaDispatcher`` and the
``BalanceController`` / ``elastic_rebalance`` shims come later (ROADMAP
queue 1, item 8: serving dispatch)."""

from .serve_loop import ServeEngine
from .straggler import StragglerAction, StragglerDetector

__all__ = ["ServeEngine", "StragglerAction", "StragglerDetector"]
