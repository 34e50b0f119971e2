"""The paper's contribution, Distributed Functional Partitioning Algorithm:
the port's copy of the reference's deprecated ``core/dfpa.py`` shim.

DFPA balances ``n`` equal computation units across ``p`` processors whose
speed functions are unknown a priori, to relative accuracy ``eps``: run
the even distribution, and while the times differ by more than ``eps``,
turn the observations into partial piecewise-linear FPM estimates,
re-partition optimally for them, execute and measure.

.. deprecated::
    The loop lives on the facade, :meth:`Scheduler.autotune`, where the
    estimates are a ``SpeedStore`` and the result a typed ``Partition``.
    :func:`dfpa` is a thin shim: it emits ``DeprecationWarning``, delegates
    to ``Scheduler.autotune`` and repacks the ``Partition`` into the legacy
    :class:`DFPAResult`, round for round as the reference's shim does.
    ``backend`` is ``"numpy"`` (the host bank, the reference's default) or
    ``"torch"`` (the bank on ``device``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from .executor import Executor
from .fpm import PiecewiseLinearFPM

__all__ = ["DFPAResult", "dfpa"]


@dataclass
class DFPAResult:
    d: List[int]  # final distribution (the paper's output array d)
    times: List[float]  # execution times observed for d (the output array t)
    iterations: int  # number of parallel rounds executed
    converged: bool  # eps test passed (False -> fixed-point/max_iter stop)
    imbalance: float  # final max |t_i - t_j| / t_i
    models: List[PiecewiseLinearFPM]  # the partial FPM estimates built
    history: List[Tuple[List[int], List[float]]] = field(default_factory=list)

    @property
    def points_per_proc(self) -> List[int]:
        return [m.num_points for m in self.models]


def dfpa(
    executor: Executor,
    n: int,
    eps: float,
    *,
    max_iter: int = 100,
    caps: Optional[Sequence[int]] = None,
    min_units: int = 0,
    warm_models: Optional[Sequence[PiecewiseLinearFPM]] = None,
    warm_start_d: Optional[Sequence[int]] = None,
    probe_budget: Optional[int] = None,
    backend: str = "numpy",
    device="cuda",
) -> DFPAResult:
    """Run DFPA over ``executor``.

    .. deprecated:: use ``Scheduler.autotune`` (see module docstring).
    """
    from .scheduler import Policy, Scheduler
    from .speedstore import SpeedStore, _warn_legacy

    _warn_legacy("dfpa()", "Scheduler.autotune()")
    if backend not in ("numpy", "torch"):
        raise ValueError(f"unknown backend {backend!r}")
    p = executor.num_procs
    store = (
        SpeedStore.from_models(
            [PiecewiseLinearFPM.from_points(m.as_points()) for m in warm_models],
            backend=backend, device=device,
        )
        if warm_models is not None
        else SpeedStore.empty(max(p, 1), backend=backend, device=device)
    )
    sched = Scheduler(store, policy=Policy.DFPA, backend=backend, device=device)
    part = sched.autotune(
        executor, n, eps,
        max_iter=max_iter, caps=caps, min_units=min_units,
        warm_start_d=warm_start_d, probe_budget=probe_budget,
    )
    return DFPAResult(
        d=list(part.allocations),
        times=list(part.times),
        iterations=part.iterations,
        converged=part.converged,
        imbalance=part.imbalance,
        models=part.diagnostics["models"],
        history=part.diagnostics["history"],
    )
