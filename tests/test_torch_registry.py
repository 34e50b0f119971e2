"""The port's profile registry (``repro_torch.fleet.registry``): the cases
of ``tests/test_registry_staleness.py`` on the port's copy.

The invariants:

* ``record`` stamps ``observed_at`` (injectable ``now=`` for determinism)
  and refreshes LRU recency; ``get`` refreshes recency without touching the
  timestamp; eviction removes the least-recently-used entry, silently.
* ``state_dict``/``from_state`` round-trip the timestamp as an OPTIONAL
  field: states written before the field existed load fine (``VERSION``
  stays 1), and entries without it report ``observed_at() is None``; the
  reference's registry and the port's read each other's states.
* A fleet with ``staleness_tol`` set (``"numpy"`` and ``"torch"``, the
  carry on the CPU) compares a warm job's first measured round against the
  warm models' prediction; a device class beyond the tolerance loses its
  entry (``drop``) with a ``UserWarning`` and a ``registry.stale_profile``
  event, once, and the job continues from fresh measurements.  Accurate
  warm profiles are untouched, and the check never fires with
  ``staleness_tol=None``.
"""

import warnings

import numpy as np
import pytest

from repro.fleet import ProfileRegistry as RefProfileRegistry

from repro_torch import obs
from repro_torch.fleet import FleetScheduler, JobSpec, ProfileRegistry

BACKENDS = ["numpy", "torch"]


# ---------------------------------------------------------------------------
# observed_at / LRU / drop
# ---------------------------------------------------------------------------


def test_observed_at_recorded_and_refreshed():
    reg = ProfileRegistry()
    reg.record("A", "w", [(1.0, 2.0)], now=100.0)
    assert reg.observed_at("A", "w") == 100.0
    reg.record("A", "w", [(2.0, 3.0)], now=200.0)
    assert reg.observed_at("A", "w") == 200.0
    assert reg.observed_at("missing", "w") is None
    # get() refreshes recency, not the timestamp
    assert reg.get("A", "w") is not None
    assert reg.observed_at("A", "w") == 200.0


def test_record_without_now_uses_wall_clock():
    import time

    reg = ProfileRegistry()
    before = time.time()
    reg.record("A", "w", [(1.0, 2.0)])
    assert before <= reg.observed_at("A", "w") <= time.time()


def test_max_entries_lru_eviction():
    reg = ProfileRegistry(max_entries=2)
    reg.record("A", "w", [(1.0, 2.0)], now=1.0)
    reg.record("B", "w", [(1.0, 2.0)], now=2.0)
    reg.get("A", "w")  # touch A: B becomes least recently used
    reg.record("C", "w", [(1.0, 2.0)], now=3.0)
    assert ("B", "w") not in reg
    assert ("A", "w") in reg and ("C", "w") in reg
    assert len(reg) == 2
    # a re-record of an existing key is a refresh, not an insert
    reg.record("A", "w", [(5.0, 5.0)], now=4.0)
    assert len(reg) == 2 and ("C", "w") in reg


def test_max_entries_validation():
    with pytest.raises(ValueError, match="max_entries must be >= 1"):
        ProfileRegistry(max_entries=0)


def test_drop():
    reg = ProfileRegistry()
    reg.record("A", "w", [(1.0, 2.0)], now=1.0)
    assert reg.drop("A", "w") is True
    assert ("A", "w") not in reg
    assert reg.observed_at("A", "w") is None
    assert reg.drop("A", "w") is False  # idempotent


# ---------------------------------------------------------------------------
# persistence: optional field, backward compatible both directions
# ---------------------------------------------------------------------------


def test_state_roundtrip_with_observed_at():
    reg = ProfileRegistry()
    reg.record("A", "w", [(1.0, 2.0)], now=42.5)
    st = reg.state_dict()
    assert st["version"] == 1
    assert st["entries"][0]["observed_at"] == 42.5
    reg2 = ProfileRegistry.from_state(st)
    assert reg2.observed_at("A", "w") == 42.5
    assert reg2.get("A", "w") == [(1.0, 2.0)]


def test_old_state_without_observed_at_loads():
    old = {
        "version": 1,
        "entries": [
            {"device_class": "A", "workload": "w", "points": [[1.0, 2.0]]}
        ],
    }
    reg = ProfileRegistry.from_state(old)
    assert reg.get("A", "w") == [(1.0, 2.0)]
    assert reg.observed_at("A", "w") is None
    # and the entry round-trips back WITHOUT inventing a timestamp
    assert "observed_at" not in reg.state_dict()["entries"][0]


def test_from_state_bad_observed_at_ignored():
    st = {
        "version": 1,
        "entries": [
            {"device_class": "A", "workload": "w", "points": [[1.0, 2.0]],
             "observed_at": "yesterday"}
        ],
    }
    reg = ProfileRegistry.from_state(st)
    assert reg.get("A", "w") == [(1.0, 2.0)]
    assert reg.observed_at("A", "w") is None


def test_from_state_respects_max_entries():
    st = ProfileRegistry().state_dict()
    st["entries"] = [
        {"device_class": c, "workload": "w", "points": [[1.0, 2.0]]}
        for c in "ABC"
    ]
    reg = ProfileRegistry.from_state(st, max_entries=2)
    assert len(reg) == 2


# ---------------------------------------------------------------------------
# the fleet staleness check
# ---------------------------------------------------------------------------

_P = 12


class _Exec:
    def __init__(self, p=_P, seed=5):
        r = np.random.default_rng(seed)
        self.base = r.uniform(5.0, 50.0, size=p)
        self.num_procs = p

    def run_jobs(self, names, D):
        D = np.asarray(D, dtype=np.float64)
        return np.where(D > 0, D / self.base[None, :], 0.0)


def _stale_registry():
    """A warm profile that predicts ~1000 units/time on every class — far
    from what _Exec measures."""
    reg = ProfileRegistry()
    reg.record("X", "w", [(10.0, 1000.0), (500.0, 1000.0)])
    return reg


def _run_warm(reg, *, staleness_tol, workload="w", backend="numpy"):
    fs = FleetScheduler(
        _P,
        backend=backend,
        device="cpu",
        registry=reg,
        device_classes=["X"] * _P,
        staleness_tol=staleness_tol,
    )
    fs.admit(JobSpec(name="j", n=600, eps=0.05, max_iter=3, workload=workload))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        fs.run(_Exec(), max_rounds=4)
    return [w for w in rec if "stale warm profile" in str(w.message)]


@pytest.mark.parametrize("backend", BACKENDS)
def test_stale_warm_profile_dropped_with_warning(backend):
    reg = _stale_registry()
    tel = obs.Telemetry()
    with obs.use(tel):
        stale = _run_warm(reg, staleness_tol=0.5, backend=backend)
    assert len(stale) == 1
    assert ("X", "w") not in reg  # entry dropped, fleet keeps running
    events = [e for e in tel.events if e.name == "registry.stale_profile"]
    assert len(events) == 1 and events[0].attrs["device_class"] == "X"
    assert events[0].attrs["median_rel_err"] > 0.5


@pytest.mark.parametrize("backend", BACKENDS)
def test_staleness_check_disabled_by_default(backend):
    reg = _stale_registry()
    stale = _run_warm(reg, staleness_tol=None, backend=backend)
    assert stale == []
    assert ("X", "w") in reg


@pytest.mark.parametrize("backend", BACKENDS)
def test_accurate_warm_profile_survives(backend):
    ex = _Exec()
    classes = [f"c{i}" for i in range(_P)]
    reg = ProfileRegistry()
    donor = FleetScheduler(
        _P, backend=backend, device="cpu", registry=reg, device_classes=classes
    )
    donor.admit(JobSpec(name="seed", n=600, eps=0.05, max_iter=8, workload="w"))
    donor.run(ex, max_rounds=10)
    donor.retire("seed")
    assert len(reg) > 0
    fs = FleetScheduler(
        _P, backend=backend, device="cpu", registry=reg, device_classes=classes,
        staleness_tol=0.5,
    )
    fs.admit(JobSpec(name="j2", n=600, eps=0.05, max_iter=3, workload="w"))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        fs.run(ex, max_rounds=4)
    assert [w for w in rec if "stale warm profile" in str(w.message)] == []
    assert len(reg) > 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_cold_job_never_trips_staleness(backend):
    """No registry entry for this workload: the flag never arms."""
    reg = _stale_registry()
    fs = FleetScheduler(
        _P, backend=backend, device="cpu", registry=reg, device_classes=["X"] * _P,
        staleness_tol=0.5,
    )
    fs.admit(JobSpec(name="j", n=600, eps=0.05, max_iter=3, workload="other"))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        fs.run(_Exec(), max_rounds=4)
    assert [w for w in rec if "stale warm profile" in str(w.message)] == []
    assert ("X", "w") in reg


# ---------------------------------------------------------------------------
# the reference's registry and the port's read each other's states
# ---------------------------------------------------------------------------


def test_states_cross_between_packages(tmp_path):
    port, ref = ProfileRegistry(max_entries=3), RefProfileRegistry(max_entries=3)
    for reg in (port, ref):
        reg.record("A", "w", [(1.0, 2.0), (4.0, 3.0)], now=1.0)
        reg.record("B", "w", [(2.0, 5.0)], now=2.0)
        reg.record("A", "w", [(1.0, 2.5)], now=3.0)
        reg.record_energy("A", "w", [(1.0, 0.5)])
        reg.get("B", "w")
        reg.record("C", "v", [(3.0, 1.0)], now=4.0)
        reg.record("D", "v", [(3.0, 1.0)], now=5.0)
    assert port.state_dict() == ref.state_dict()
    assert list(port.keys()) == list(ref.keys())
    path = tmp_path / "port.json"
    port.save(str(path))
    assert RefProfileRegistry.load(str(path)).state_dict() == port.state_dict()
    assert ProfileRegistry.from_state(ref.state_dict()).state_dict() == ref.state_dict()


def test_registry_warning_event_mirrors_the_warning(tmp_path):
    tel = obs.Telemetry()
    with obs.use(tel), pytest.warns(UserWarning, match="not found"):
        ProfileRegistry.load(str(tmp_path / "nope.json"))
    events = [e for e in tel.events if e.name == "registry.warning"]
    assert len(events) == 1 and events[0].attrs["kind"] == "not_found"
