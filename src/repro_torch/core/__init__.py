"""The paper's contribution on PyTorch: FPMs, the geometric partitioner of
[16], DFPA, and the calibrated heterogeneous-cluster simulator.

Three model representations back the partitioners, as in the reference:

* **scalar** (``fpm.py``) — one ``SpeedModel`` object per processor;
* **host bank** (``modelbank.py``) — ``ModelBank``, all ``p`` models as
  padded numpy arrays;
* **device bank** (``modelbank_torch.py``) — ``TorchModelBank``, the same
  padded layout as torch tensors on the card, where the ``t*`` bisection,
  the integer completion and the observation fold-in run.

The entry point is the ``Scheduler`` facade (``scheduler.py``) over a
``SpeedStore`` (``speedstore.py``), backend and device resolved once; it
also carries the nested 2-D grid partitioner (``partition2d.py`` holds its
helpers), the two-level partitioner (``hierarchy.py``) and the time/energy
front (``energy.py``).  ``convert.py`` carries the reference package's
banks and checkpoints over.  The fleet's measurement primitives
(``FleetExecutor``, ``BatchedSimulatedExecutor2D``, ``FleetRoundLog``,
``DelayedBatchedExecutor``, the serving harness's ``TraceExecutor2D``)
live in ``executor.py``; the fleet itself is
``repro_torch.fleet``.
"""

from .convert import bank_from_arrays
from .executor import (
    BatchedSimulatedExecutor,
    BatchedSimulatedExecutor2D,
    CallableExecutor,
    DelayedBatchedExecutor,
    Executor,
    FleetExecutor,
    FleetRoundLog,
    RoundLog,
    SimulatedExecutor,
    TraceExecutor2D,
)
from .fpm import AnalyticModel, ConstantModel, PiecewiseLinearFPM, SpeedModel, imbalance
from .hierarchy import Hierarchy
from .modelbank import ModelBank, aggregate_groups, group_members
from .modelbank_torch import DeferredPartition, TorchModelBank, fetch_partition
from .partition import cpm_partition, partition_continuous, partition_units
from .partition2d import app_time_2d
from .scheduler import Partition, Policy, Scheduler
from .simulator import (
    HCL_SPECS,
    NodeSpec,
    full_model_build_cost,
    make_grid5000_specs,
    make_grid5000_time_fns,
    make_hcl_time_fn_batch,
    make_hcl_time_fns,
    matmul_app_time_1d,
    speed_fn_1d,
    speed_fn_1d_batch,
    speed_fn_2d,
    speed_fn_2d_batch,
    time_fn_1d,
    time_fn_1d_batch,
    time_fn_2d_batch,
)
from .speedstore import SpeedStore, sample_analytic_points

__all__ = [
    "AnalyticModel",
    "BatchedSimulatedExecutor",
    "BatchedSimulatedExecutor2D",
    "CallableExecutor",
    "ConstantModel",
    "DeferredPartition",
    "DelayedBatchedExecutor",
    "Executor",
    "FleetExecutor",
    "FleetRoundLog",
    "HCL_SPECS",
    "Hierarchy",
    "ModelBank",
    "NodeSpec",
    "Partition",
    "PiecewiseLinearFPM",
    "Policy",
    "RoundLog",
    "Scheduler",
    "SimulatedExecutor",
    "SpeedModel",
    "SpeedStore",
    "TorchModelBank",
    "TraceExecutor2D",
    "aggregate_groups",
    "app_time_2d",
    "bank_from_arrays",
    "cpm_partition",
    "fetch_partition",
    "full_model_build_cost",
    "group_members",
    "imbalance",
    "make_grid5000_specs",
    "make_grid5000_time_fns",
    "make_hcl_time_fn_batch",
    "make_hcl_time_fns",
    "matmul_app_time_1d",
    "partition_continuous",
    "partition_units",
    "sample_analytic_points",
    "speed_fn_1d",
    "speed_fn_1d_batch",
    "speed_fn_2d",
    "speed_fn_2d_batch",
    "time_fn_1d",
    "time_fn_1d_batch",
    "time_fn_2d_batch",
]
