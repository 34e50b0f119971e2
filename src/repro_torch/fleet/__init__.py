"""Fleet: multi-tenant scheduling over one heterogeneous platform.

The layer above the single-job ``Scheduler`` facade: a
:class:`FleetScheduler` admits many concurrent jobs (:class:`JobSpec` each),
keeps ONE stacked ``[q, p, k]`` device bank as its carry, and runs every
admitted job's DFPA measurement round as one stacked repartition, one
batched measurement (:class:`~repro_torch.core.executor.FleetExecutor`) and
one stacked fold-in.  Results are bit-identical to q independent
``Scheduler.autotune`` loops.

:class:`ProfileRegistry` persists the partial speed-function estimates
across sessions, keyed by (device class, workload tag), so admitted jobs
warm-start from prior measurements instead of cold probes.
"""

from .registry import ProfileRegistry
from .scheduler import FleetScheduler, JobSpec

__all__ = ["FleetScheduler", "JobSpec", "ProfileRegistry"]
