"""Runtime: ``ServeEngine`` (prefill, then greedy decode) and
``ReplicaDispatcher`` (DFPA over request chunks across serving replicas,
one tenant through ``Scheduler`` or many through ``FleetScheduler``), the
straggler detector (``StragglerDetector``, ``StragglerAction``), which
``core.Scheduler.straggler_actions`` drives, and the deprecated
``BalanceController`` / ``GroupTimer`` / ``elastic_rebalance`` shims over
``Scheduler``; the training step (``TrainState``, ``init_train_state``,
``make_train_step``, ``loss_for_config``), which ``launch.train`` drives."""

from .balance import BalanceController, GroupTimer
from .elastic import elastic_rebalance
from .serve_loop import ReplicaDispatcher, ServeEngine
from .straggler import StragglerAction, StragglerDetector
from .train_loop import TrainState, init_train_state, loss_for_config, make_train_step

__all__ = [
    "TrainState",
    "make_train_step",
    "init_train_state",
    "loss_for_config",
    "ServeEngine",
    "ReplicaDispatcher",
    "BalanceController",
    "GroupTimer",
    "StragglerDetector",
    "StragglerAction",
    "elastic_rebalance",
]
