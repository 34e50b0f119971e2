"""SpeedStore: one resolved home for the fleet's speed models.

The store resolves the backend once, at construction, and then exposes one
protocol:

  * ``speeds(x)`` / ``times(x)``      — batched model evaluation, ``[p]``;
  * ``alloc_at_time(t, caps)``        — the geometric partitioner primitive;
  * ``fold_in(x, s, valid)``          — one observation per processor (the
    paper's step-5 update), applied to the scalar estimates AND, on the
    torch backend, to the device-resident carry in the same call;
  * ``partition_units`` / ``partition_continuous`` / ``partition`` — the
    partitioners, dispatched to the pre-resolved backend;
  * ``state_dict()`` / ``from_state`` — checkpointable estimates;
  * ``attach_energy`` / ``fold_energy`` / ``energy_at`` / ``pareto_front``
    — the energy sub-store (``core/energy.py``): energy-rate models on the
    same backend, and the ``objective=`` / ``energy_cap=`` dispatch of
    :meth:`SpeedStore.partition`.

Three backends:

  * ``"scalar"`` — per-model Python objects (models with no piecewise
    representation, or a forced baseline);
  * ``"numpy"``  — the scalar estimates are the source of truth, banked into
    a host :class:`~.modelbank.ModelBank` per partition call;
  * ``"torch"``  — a :class:`~.modelbank_torch.TorchModelBank` carry lives on
    ``device`` (default ``"cuda"``) and is updated by ``fold_in`` instead of
    being rebuilt from the scalars.

``dtype`` is the device bank's float dtype (default float64, the dtype of
the bit-parity contract with the numpy backend); the host backends always
compute in float64.  ``AnalyticModel`` s can ride the banked backends by
sample-and-bank (``analytic_tol=``, :func:`sample_analytic_points`).
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .fpm import ConstantModel, PiecewiseLinearFPM, SpeedModel, imbalance
from .modelbank import ModelBank
from .modelbank_torch import TorchModelBank, resolve_device
from .partition import (
    _continuous_bank,
    _continuous_scalar,
    _partition_units_bank,
    _partition_units_scalar,
    _prep_continuous_caps,
    _prep_unit_caps,
)

try:  # telemetry is optional: the store runs identically without obs/
    from ..obs.telemetry import active as _obs_active
except ImportError:  # pragma: no cover - obs layer absent
    def _obs_active():
        return None

__all__ = ["SpeedStore", "sample_analytic_points", "BACKENDS"]

BACKENDS = ("scalar", "numpy", "torch")


def _warn_legacy(old: str, new: str) -> None:
    """One DeprecationWarning per legacy entry point, pointing at the facade."""
    warnings.warn(
        f"{old} is deprecated; use {new} — see core/scheduler.py and "
        "core/speedstore.py (backend resolved once at construction)",
        DeprecationWarning,
        stacklevel=3,
    )


def _dtype_name(dtype) -> Optional[str]:
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return np.dtype(dtype).name


def sample_analytic_points(
    model: SpeedModel,
    *,
    hi: float,
    lo: float = 1.0,
    tol: float = 0.01,
    max_points: int = 64,
) -> List[Tuple[float, float]]:
    """Adaptive piecewise-linear fit of ``model.speed`` on ``[lo, hi]``:
    repeatedly split the segment whose midpoint linear interpolation deviates
    most from the true speed, until every segment is within relative ``tol``
    or ``max_points`` is reached."""
    lo = max(float(lo), 1e-9)
    hi = float(hi)
    if hi <= lo:
        hi = lo * 2.0
    xs = [lo, hi]
    ss = [float(model.speed(lo)), float(model.speed(hi))]

    def _mid_err(k: int) -> Tuple[float, float, float]:
        xm = 0.5 * (xs[k] + xs[k + 1])
        s_true = float(model.speed(xm))
        s_lin = 0.5 * (ss[k] + ss[k + 1])
        denom = abs(s_true) if s_true != 0.0 else 1e-300
        return abs(s_lin - s_true) / denom, xm, s_true

    while len(xs) < max_points:
        worst = None
        for k in range(len(xs) - 1):
            err, xm, sm = _mid_err(k)
            if worst is None or err > worst[0]:
                worst = (err, k, xm, sm)
        if worst is None or worst[0] <= tol:
            break
        _, k, xm, sm = worst
        xs.insert(k + 1, xm)
        ss.insert(k + 1, sm)
    return [(x, max(s, 1e-300)) for x, s in zip(xs, ss)]


class SpeedStore:
    """Polymorphic model container with the backend resolved at construction.

    Build it with :meth:`from_models`, :meth:`from_speeds`, :meth:`from_bank`,
    :meth:`from_torch_bank`, :meth:`empty`, :meth:`from_state` or (for the
    legacy adapters) :meth:`resolve`.
    """

    def __init__(
        self,
        models: Optional[List[SpeedModel]],
        backend: str,
        *,
        bank: Optional[ModelBank] = None,
        tbank: Optional[TorchModelBank] = None,
        dtype=None,
        device="cuda",
    ):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        self._models = list(models) if models is not None else None
        self.backend = backend
        self.dtype = dtype  # device-bank float dtype policy (None = float64)
        # the torch backend's device, checked now so a missing card raises at
        # construction; the host backends never touch it
        self.device = resolve_device(device) if backend == "torch" else torch.device(device)
        # fold counter, in lock-step with the carry's generation tag
        self.fold_generation = 0
        self._np_bank = bank  # wrapped ModelBank (models is None) only
        self._tbank = tbank  # device carry (torch backend); None -> lazy rebuild
        # optional energy sub-store on the same backend: energy-rate models
        # er_i(x) = x / E_i(x), so _energy.times(d) are the energies E_i(d)
        self._energy: Optional["SpeedStore"] = None

    # -- construction --------------------------------------------------------

    @classmethod
    def from_models(
        cls,
        models: Sequence[SpeedModel],
        *,
        backend: str = "auto",
        analytic_tol: Optional[float] = None,
        analytic_hi: Optional[float] = None,
        analytic_lo: float = 1.0,
        analytic_max_points: int = 64,
        dtype=None,
        device="cuda",
    ) -> "SpeedStore":
        """Build a store from scalar models, resolving the backend once.

        ``backend="auto"`` picks ``"numpy"`` when every model has a piecewise
        representation and ``"scalar"`` otherwise; a banked backend asked
        for non-piecewise models also keeps the scalar path.  With
        ``analytic_tol`` (and ``analytic_hi``) non-piecewise models are
        sample-and-banked first.
        """
        models = list(models)
        if analytic_tol is not None:
            if analytic_hi is None:
                raise ValueError("analytic_tol requires analytic_hi (sampling range)")
            banked = []
            for m in models:
                if isinstance(m, (PiecewiseLinearFPM, ConstantModel)) or hasattr(m, "as_points"):
                    banked.append(m)
                else:
                    banked.append(
                        PiecewiseLinearFPM.from_points(
                            sample_analytic_points(
                                m, hi=analytic_hi, lo=analytic_lo,
                                tol=analytic_tol, max_points=analytic_max_points,
                            )
                        )
                    )
            models = banked
        if backend not in ("auto",) + BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        if backend == "scalar":
            return cls(models, "scalar", dtype=dtype, device=device)
        try:
            ModelBank.from_models(models)
        except TypeError:
            return cls(models, "scalar", dtype=dtype, device=device)
        if backend == "torch":
            return cls(
                models, "torch", dtype=dtype, device=device,
                tbank=cls._initial_carry(models, dtype, device),
            )
        return cls(models, "numpy", dtype=dtype, device=device)

    @staticmethod
    def _initial_carry(models: Sequence[SpeedModel], dtype, device) -> TorchModelBank:
        """The DFPA device carry: built from the models when any has points
        (a model with no point count, such as a ``ConstantModel``, is always
        evaluable), otherwise the empty bank."""
        if any(getattr(m, "num_points", 1) > 0 for m in models):
            return TorchModelBank.from_models(models, device=device, dtype=dtype)
        return TorchModelBank.empty(len(models), device=device, dtype=dtype)

    @classmethod
    def from_speeds(cls, speeds: Sequence[float], *, backend: str = "numpy", device="cuda") -> "SpeedStore":
        """CPM store: one constant-speed model per processor."""
        return cls.from_models(
            [ConstantModel(float(s)) for s in speeds], backend=backend, device=device
        )

    @classmethod
    def empty(cls, p: int, *, backend: str = "numpy", dtype=None, device="cuda") -> "SpeedStore":
        """``p`` empty piecewise estimates (the cold-start DFPA state)."""
        models = [PiecewiseLinearFPM() for _ in range(p)]
        if backend == "torch":
            return cls(
                models, "torch", dtype=dtype, device=device,
                tbank=cls._initial_carry(models, dtype, device),
            )
        if backend in ("numpy", "scalar"):
            return cls(models, backend, dtype=dtype, device=device)
        raise ValueError(f"unknown backend {backend!r}")

    @classmethod
    def from_bank(cls, bank: ModelBank, *, device="cuda") -> "SpeedStore":
        """Wrap an existing numpy bank (no scalar mirror until needed)."""
        return cls(None, "numpy", bank=bank, device=device)

    @classmethod
    def from_torch_bank(cls, tbank: TorchModelBank) -> "SpeedStore":
        """Wrap an existing device bank (no scalar mirror until needed)."""
        if tbank.xs.ndim != 2:
            raise ValueError("a store holds one [p, k] bank, not a stacked one")
        return cls(None, "torch", tbank=tbank, dtype=tbank.dtype, device=tbank.device)

    @classmethod
    def resolve(
        cls, source, *, backend: str = "numpy", vectorize: bool = True, device="cuda"
    ) -> "SpeedStore":
        """Adapt any legacy ``models`` argument — scalar sequence,
        ``ModelBank``, ``TorchModelBank`` or an existing store."""
        if backend not in ("numpy", "torch"):
            raise ValueError(f"unknown backend {backend!r}")
        if isinstance(source, cls):
            return source
        if getattr(source, "is_torch", False):
            if backend == "torch" and vectorize:
                return cls.from_torch_bank(source)
            bank = source.to_bank()
            if not vectorize:
                return cls(bank.to_models(), "scalar", device=device)
            return cls.from_bank(bank, device=device)
        if isinstance(source, ModelBank):
            if not vectorize:
                return cls(source.to_models(), "scalar", device=device)
            if backend == "torch":
                return cls(
                    None, "torch", device=device,
                    tbank=TorchModelBank.from_bank(source, device=device),
                )
            return cls.from_bank(source, device=device)
        models = list(source)
        if not vectorize:
            return cls(models, "scalar", device=device)
        return cls.from_models(models, backend=backend, device=device)

    # -- shape / access ------------------------------------------------------

    @property
    def p(self) -> int:
        if self._models is not None:
            return len(self._models)
        if self._np_bank is not None:
            return self._np_bank.p
        return self._tbank.p

    def __len__(self) -> int:
        return self.p

    @property
    def models(self) -> List[SpeedModel]:
        """The live scalar estimates (materialized from the bank if the store
        was built as a pure bank wrapper)."""
        self._ensure_models()
        return self._models

    def _ensure_models(self) -> None:
        if self._models is not None:
            return
        if self._np_bank is not None:
            self._models = self._np_bank.to_models()
        else:
            self._models = self._tbank.to_bank().to_models()

    def to_models(self) -> List[SpeedModel]:
        return list(self.models)

    @property
    def num_points(self) -> List[int]:
        """Observed points per model; models without a piecewise
        representation count as 1 — they are always evaluable."""
        if self._models is not None:
            return [getattr(m, "num_points", 1) for m in self._models]
        return [int(c) for c in np.asarray(self.bank().counts)]

    def bank(self) -> ModelBank:
        """Numpy-bank snapshot of the current estimates."""
        if self._models is None:
            if self._np_bank is not None:
                return self._np_bank
            return self._tbank.to_bank()
        return ModelBank.from_models(self._models)

    def _carry(self) -> TorchModelBank:
        """The torch device carry; rebuilt lazily from the scalar models
        after an invalidation (``reset_row``)."""
        if self._tbank is None:
            self._tbank = self._initial_carry(self._models, self.dtype, self.device)
        return self._tbank

    def device_bank(self, *, snapshot: bool = True) -> TorchModelBank:
        """``TorchModelBank`` view: the carry itself on the torch backend,
        built from the models otherwise.  With ``snapshot=True`` the carry is
        copied, so later folds (which update it in place) cannot change the
        caller's bank."""
        if self.backend == "torch":
            tb = self._carry()
            return tb.copy() if snapshot else tb
        return TorchModelBank.from_bank(self.bank(), device=self.device, dtype=self.dtype)

    def drop_carry(self) -> None:
        """Invalidate the device carry (rebuilt lazily from the models)."""
        self._ensure_models()
        self._tbank = None

    # -- the model-query protocol --------------------------------------------

    def speeds(self, x) -> np.ndarray:
        """Batched ``s_i(x_i)`` as a host ``[p]`` array (NaN on empty rows)."""
        if self.backend == "torch":
            return self._carry().speed(np.asarray(x, dtype=np.float64)).cpu().numpy()
        if self.backend == "numpy":
            return self.bank().speed(x)
        x = np.broadcast_to(np.asarray(x, dtype=np.float64), (self.p,))
        out = np.empty(self.p, dtype=np.float64)
        for i, m in enumerate(self.models):
            if getattr(m, "num_points", 1) == 0:
                out[i] = np.nan
            else:
                out[i] = m.speed(float(x[i]))
        return out

    def times(self, x) -> np.ndarray:
        """Batched ``t_i(x_i) = x_i / s_i(x_i)`` (0 for non-positive x)."""
        if self.backend == "torch":
            return self._carry().time(np.asarray(x, dtype=np.float64)).cpu().numpy()
        if self.backend == "numpy":
            return self.bank().time(x)
        x = np.broadcast_to(np.asarray(x, dtype=np.float64), (self.p,))
        out = np.empty(self.p, dtype=np.float64)
        for i, m in enumerate(self.models):
            if getattr(m, "num_points", 1) == 0:
                out[i] = np.nan if x[i] > 0 else 0.0
            else:
                out[i] = m.time(float(x[i]))
        return out

    def alloc_at_time(self, t: float, caps) -> np.ndarray:
        """Batched ``max { x in [0, cap_i] : x / s_i(x) <= t }``."""
        if self.backend == "torch":
            return (
                self._carry().alloc_at_time(t, np.asarray(caps, dtype=np.float64)).cpu().numpy()
            )
        if self.backend == "numpy":
            return self.bank().alloc_at_time(t, caps)
        caps = np.broadcast_to(np.asarray(caps, dtype=np.float64), (self.p,))
        return np.asarray(
            [m.alloc_at_time(t, float(c)) for m, c in zip(self.models, caps)]
        )

    # -- observation fold-in -------------------------------------------------

    def fold_in(self, x, s, valid: Optional[Sequence[bool]] = None) -> "SpeedStore":
        """Insert one observation ``(x_i, s_i)`` per processor into the
        scalar estimates and, on the torch backend, into the device carry —
        one vectorized sorted insert instead of a rebuild.  Rows with
        ``valid[i] == False`` are untouched.  Mutates and returns the store."""
        self._ensure_models()
        xs = [float(v) for v in np.broadcast_to(np.asarray(x, dtype=np.float64), (self.p,))]
        ss = [float(v) for v in np.broadcast_to(np.asarray(s, dtype=np.float64), (self.p,))]
        vv = (
            [bool(v) for v in np.broadcast_to(np.asarray(valid, dtype=bool), (self.p,))]
            if valid is not None
            else [True] * self.p
        )
        for i, (xi, si, ok) in enumerate(zip(xs, ss, vv)):
            if ok:
                self._models[i].add_point(xi, si)
        if self.backend == "torch":
            self._tbank = self._carry().fold_in(xs, ss, vv)
        self.fold_generation += 1
        tel = _obs_active()
        if tel is not None and tel.enabled:
            tel.counter("speedstore.fold_in")
            tel.gauge("speedstore.fold_generation", self.fold_generation)
        return self

    # -- the energy sub-store (core/energy.py) -------------------------------

    @property
    def energy(self) -> Optional["SpeedStore"]:
        """The attached energy sub-store (None until ``attach_energy`` /
        ``fold_energy``)."""
        return self._energy

    @property
    def has_energy(self) -> bool:
        return self._energy is not None

    def attach_energy(self, models: Sequence[SpeedModel]) -> "SpeedStore":
        """Attach per-processor energy-rate models (``er_i(x) = x / E_i(x)``,
        built from measured ``(x, energy)`` samples with
        ``energy.energy_model``) as a sub-store on THIS store's backend and
        device, so energy partitions ride the same path as speed.  Returns
        the store."""
        models = list(models)
        if len(models) != self.p:
            raise ValueError(
                f"need {self.p} energy models (one per processor), got {len(models)}"
            )
        es = SpeedStore.from_models(
            models, backend=self.backend, dtype=self.dtype, device=self.device
        )
        if self.backend in ("numpy", "torch") and es.backend != self.backend:
            raise TypeError(
                "energy models need a piecewise representation to ride the "
                f"banked {self.backend!r} backend (sample-and-bank them first)"
            )
        self._energy = es
        return self

    def fold_energy(self, x, energy, valid: Optional[Sequence[bool]] = None) -> "SpeedStore":
        """Insert one measured ``(x_i, energy_i)`` observation per processor
        into the energy estimates — the energy twin of :meth:`fold_in`, with
        the rate conversion ``er = x / E`` done here.  Non-positive /
        non-finite energies (and rows with ``valid[i] == False``) are
        skipped.  Creates an empty energy sub-store on first fold."""
        if self._energy is None:
            self._energy = SpeedStore.empty(
                self.p, backend=self.backend, dtype=self.dtype, device=self.device
            )
        xs = np.broadcast_to(np.asarray(x, dtype=np.float64), (self.p,))
        es = np.broadcast_to(np.asarray(energy, dtype=np.float64), (self.p,))
        vv = (
            np.broadcast_to(np.asarray(valid, dtype=bool), (self.p,))
            if valid is not None
            else np.ones(self.p, dtype=bool)
        )
        ok = vv & (xs > 0.0) & (es > 0.0) & np.isfinite(es) & np.isfinite(xs)
        rates = np.where(ok, xs / np.where(es > 0.0, es, 1.0), 1.0)
        self._energy.fold_in(xs, rates, ok)
        return self

    def energy_at(self, d) -> np.ndarray:
        """Per-processor energies ``E_i(d_i)`` under the current energy
        estimates (0 for ``d_i <= 0``)."""
        if self._energy is None:
            raise ValueError(
                "no energy models attached; call attach_energy() or fold_energy()"
            )
        return self._energy.times([float(v) for v in np.broadcast_to(np.asarray(d), (self.p,))])

    def fleet_energy(self, d) -> float:
        """Total fleet energy ``sum_i E_i(d_i)`` (rows without units or
        without estimates contribute 0)."""
        e = self.energy_at(d)
        darr = np.broadcast_to(np.asarray(d, dtype=np.float64), (self.p,))
        return float(np.where((darr > 0.0) & np.isfinite(e), e, 0.0).sum())

    def pareto_front(
        self, n: int, caps=None, *, min_units: int = 0, num_points: int = 17,
        completion: str = "auto",
    ):
        """The makespan/total-energy Pareto front of integer partitions
        (``core.energy.ParetoFront``): endpoints are exactly the
        ``objective="time"`` and ``objective="energy"`` solutions, interior
        points are energy solves under time-threshold-tightened caps — one
        stacked ``[T, p, k]`` program on the torch backend, bit-identical to
        the numpy sweep."""
        if self._energy is None:
            raise ValueError(
                "no energy models attached; call attach_energy() or fold_energy()"
            )
        from .energy import pareto_front as _pareto_front

        icaps = _prep_unit_caps(self.p, n, caps, min_units)
        return _pareto_front(
            self, self._energy, int(n), icaps,
            min_units=min_units, num_points=num_points, completion=completion,
        )

    def reset_row(self, i: int, points: Sequence[Tuple[float, float]] = ()) -> None:
        """Replace processor ``i``'s estimate (keep only the supplied points,
        typically the freshest operating point).  The device carry is dropped
        and rebuilt lazily."""
        self._ensure_models()
        self._models[i] = (
            PiecewiseLinearFPM.from_points(points) if points else PiecewiseLinearFPM()
        )
        self._tbank = None

    # -- the partitioners (backend pre-resolved) ------------------------------

    def partition_continuous(
        self, n: float, caps=None, *, rel_tol: float = 1e-12, max_steps: int = 200
    ) -> Tuple[List[float], float]:
        """Continuous optimal partition (allocations, t*)."""
        p = self.p
        if p == 0:
            raise ValueError("no processors")
        if n <= 0:
            return [0.0] * p, 0.0
        if self.backend == "torch":
            caps_l = _prep_continuous_caps(p, float(n), caps)
            xs, t_star = self._carry().partition_continuous(
                float(n), caps_l, rel_tol=rel_tol, max_steps=max_steps
            )
            return [float(v) for v in xs.cpu().numpy()], float(t_star)
        if self.backend == "numpy":
            return _continuous_bank(self.bank(), float(n), caps, rel_tol=rel_tol, max_steps=max_steps)
        return _continuous_scalar(self.models, float(n), caps, rel_tol=rel_tol, max_steps=max_steps)

    def partition_units(
        self, n: int, caps=None, *, min_units: int = 0, completion: str = "auto",
        objective: str = "time", energy_cap: Optional[float] = None,
    ) -> List[int]:
        """Integer partition of ``n`` units (allocations only)."""
        return self.partition(
            n, caps, min_units=min_units, completion=completion,
            objective=objective, energy_cap=energy_cap,
        )[0]

    def partition(
        self, n: int, caps=None, *, min_units: int = 0, completion: str = "auto",
        objective: str = "time", energy_cap: Optional[float] = None,
    ) -> Tuple[List[int], float]:
        """Integer partition plus the continuous solve's ``t*``.

        ``completion`` routes the integer completion: ``"auto"`` takes the
        threshold count on the torch backend iff the bank is monotone-time
        and the exact per-unit loop otherwise (always on the numpy host
        path); ``"greedy"`` / ``"threshold"`` force a mode.  The scalar
        backend runs its exact loop and refuses ``"threshold"``.

        ``objective`` selects what the geometric solve balances (see
        ``core/energy.py``; ``"energy"``/``"pareto"`` need energy models
        attached): ``"time"`` is the default; ``"energy"`` runs the same
        solve on the energy bank — the returned scalar is the equal-energy
        point; ``"pareto"`` computes the makespan/energy front and picks
        the knee — or, with ``energy_cap``, the fastest point whose total
        energy fits the budget (``energy_cap`` with any objective routes
        through the front; the returned scalar is the picked point's
        predicted makespan).
        """
        if completion not in ("auto", "threshold", "greedy"):
            raise ValueError(f"unknown completion mode {completion!r}")
        if objective not in ("time", "energy", "pareto"):
            raise ValueError(f"unknown objective {objective!r}")
        if (objective != "time" or energy_cap is not None) and self._energy is None:
            raise ValueError(
                f"objective={objective!r}/energy_cap need energy models; "
                "call attach_energy() or fold_energy() first"
            )
        if objective == "energy" and energy_cap is None:
            return self._energy.partition(
                n, caps, min_units=min_units, completion=completion
            )
        if objective == "pareto" or energy_cap is not None:
            front = self.pareto_front(
                n, caps, min_units=min_units, completion=completion
            )
            idx = front.pick(energy_cap)
            return [int(v) for v in front.allocations[idx]], float(front.times[idx])
        icaps = _prep_unit_caps(self.p, n, caps, min_units)
        tel = _obs_active()
        rec = tel is not None and tel.enabled
        if rec:
            t0 = tel.clock()
        if self.backend == "torch":
            d, t_star = self._carry().partition_units(
                n, icaps, min_units=min_units, with_t=True, completion=completion
            )
            if rec:
                # the device bisection reports no host iteration count; the
                # allocations are host arrays by now, so the span covers the
                # device work
                tel.span_at("speedstore.partition", t0, tel.clock(),
                            n=int(n), backend="torch")
            return [int(v) for v in d], float(t_star)
        if self.backend == "numpy":
            out = _partition_units_bank(
                self.bank(), n, icaps, min_units=min_units, completion=completion
            )
        else:
            if completion == "threshold":
                raise ValueError(
                    "the scalar backend has no threshold completion; use a banked "
                    "backend or completion='auto'/'greedy'"
                )
            out = _partition_units_scalar(self.models, n, icaps, min_units=min_units)
        if rec:
            from . import partition as _partition_mod

            tel.gauge("speedstore.bisection_steps", _partition_mod._LAST_BISECTION_STEPS)
            tel.span_at("speedstore.partition", t0, tel.clock(),
                        n=int(n), backend=self.backend)
        return out

    # -- derived metrics ------------------------------------------------------

    def imbalance_estimate(self, d: Sequence[int]) -> float:
        """Predicted imbalance of distribution ``d`` under the current
        estimates (groups without points or units are ignored)."""
        pts = self.num_points
        ts = [
            float(t)
            for t, di, k in zip(self.times([float(v) for v in d]), d, pts)
            if di > 0 and k > 0 and np.isfinite(t)
        ]
        return imbalance(ts)

    # -- persistence ----------------------------------------------------------

    def state_dict(self) -> Dict:
        """Checkpointable estimates (the reference's schema).  Raises
        ``TypeError`` for models with no piecewise representation."""
        points = []
        for m in self.models:
            if not hasattr(m, "as_points"):
                if isinstance(m, ConstantModel):
                    points.append([(1.0, float(m.s))])
                    continue
                raise TypeError(
                    f"{type(m).__name__} has no piecewise representation; "
                    "build the store with analytic_tol to sample-and-bank it"
                )
            points.append([(float(x), float(s)) for x, s in m.as_points()])
        state = {"backend": self.backend, "points": points, "dtype": _dtype_name(self.dtype)}
        if self._energy is not None:
            state["energy_points"] = self._energy.state_dict()["points"]
        return state

    @classmethod
    def from_state(cls, state: Dict, *, backend: Optional[str] = None, device="cuda") -> "SpeedStore":
        """Restore from :meth:`state_dict` — the port's or the reference's
        (see ``core/convert.py``)."""
        from .convert import store_state_from_reference

        state = store_state_from_reference(state)
        models = [PiecewiseLinearFPM.from_points(p) for p in state["points"]]
        store = cls.from_models(
            models,
            backend=backend or state.get("backend", "numpy"),
            dtype=state.get("dtype"),
            device=device,
        )
        if state.get("energy_points"):
            store.attach_energy(
                [PiecewiseLinearFPM.from_points(p) for p in state["energy_points"]]
            )
        return store
