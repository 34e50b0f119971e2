"""Persistent profile registry: partial speed-function estimates that
outlive the session that measured them.

The paper's economic argument is that *partial* estimates — a handful of
(size, speed) points per processor — are already sufficient for a given
accuracy.  Those points are expensive only the first time: they are paid for
in real measurement rounds (CPM probes, DFPA iterations).  A multi-tenant
fleet sees the same (device class, workload) pairs over and over, so the
registry keys each partial estimate by ``(device_class, workload_tag)`` and
merges it back in when a new job is admitted: the newcomer's first
distribution is computed from *yesterday's* points instead of an even split,
and the DFPA loop starts from round ~k instead of round 1 (the warm-start
path of ``Scheduler.autotune`` / ``FleetScheduler.admit``).

Key scheme
----------

One entry per ``(device_class, workload_tag)`` — NOT per processor: two A100
groups running the same decode workload share a speed function up to noise,
and sharing the entry is exactly what makes the registry useful for a job
that lands on *different* processors of the same classes.  Entries hold
plain ``[(x, speed), ...]`` point lists, the same representation as
``PiecewiseLinearFPM.as_points()`` / the ``SpeedStore.state_dict``
``points`` field, and merging follows ``add_point`` semantics: a duplicate
``x`` replaces the stored speed (freshest observation wins), anything else
sorted-inserts.

Failure policy
--------------

A registry must never take a fleet down: a missing file, corrupt JSON, or a
malformed entry degrades to a cold start with a ``UserWarning`` — the job
just pays the measurement rounds it would have paid without a registry.

Staleness and bounds
--------------------

Profiles age: a driver update or thermal re-limit changes a device class's
speed function, and yesterday's points then *mislead* the warm start.  Two
mechanisms keep the registry honest:

* every entry carries an ``observed_at`` timestamp (refreshed on
  ``record``); ``FleetScheduler`` compares a warm-started job's FIRST
  measured round against the warm prediction and, beyond
  ``staleness_tol``, calls :meth:`drop` on the offending entry with a
  ``UserWarning`` — the job continues from its fresh measurements;
* ``max_entries`` bounds the registry LRU-style (dict insertion order;
  ``get``/``record`` refresh recency), so a long-lived fleet cycling
  through many workloads cannot grow it without bound.

``observed_at`` is an OPTIONAL JSON field: state dicts written by older
sessions load fine (no timestamp -> treated as never refreshed, first in
line for eviction), and older sessions ignore the extra field — the
round-trip stays backward-compatible in both directions (``VERSION`` stays
1).

Energy profiles
---------------

Energy profiles ride alongside speed ones under the SAME key scheme:
``record_energy``/``get_energy``/``warm_energy_models`` mirror the speed
trio, storing energy-RATE points (``er_i(x) = x / E_i(x)`` — the
representation of ``core/energy.py``, so the same positive/sorted
validation applies).  Evicting or dropping a speed entry removes its
energy sibling; persistence adds an OPTIONAL ``energy_entries`` list that
older readers ignore (``VERSION`` still 1).
"""

from __future__ import annotations

import json
import os
import time
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.fpm import PiecewiseLinearFPM

try:  # telemetry is optional: the registry runs identically without obs/
    from ..obs.telemetry import active as _obs_active
except ImportError:  # pragma: no cover - obs layer absent
    def _obs_active():
        return None

__all__ = ["ProfileRegistry"]


def _warn(message: str, *, stacklevel: int = 2, **attrs) -> None:
    """``warnings.warn`` with a structured telemetry mirror: the warning
    behaviour is byte-identical (same message, category, user-facing
    stacklevel), but an installed sink also gets a ``registry.warning``
    event carrying the machine-readable fields — so cold-start causes show
    up in traces without scraping warning text."""
    tel = _obs_active()
    if tel is not None and tel.enabled:
        tel.event("registry.warning", message=message, **attrs)
    warnings.warn(message, UserWarning, stacklevel=stacklevel + 1)

Point = Tuple[float, float]


def _valid_points(points) -> Optional[List[Point]]:
    """Validate one entry's point list; None (not a raise) on any malformed
    shape — the caller warns and falls back to a cold start."""
    try:
        out = [(float(x), float(s)) for x, s in points]
    except (TypeError, ValueError):
        return None
    if not out:
        return None
    for x, s in out:
        if not (x > 0.0 and s > 0.0) or x != x or s != s or x == float("inf") or s == float("inf"):
            return None
    if any(b[0] < a[0] for a, b in zip(out, out[1:])):
        return None
    return out


class ProfileRegistry:
    """(device-class, workload-tag)-keyed store of partial FPM estimates.

    ``get``/``record`` are the in-memory protocol; ``state_dict``/
    ``from_state`` mirror the repo's persistence convention and
    ``save``/``load`` wrap them in JSON-on-disk.  ``warm_models`` and
    ``record_job`` are the fleet-facing pair: models out on admit, points
    back on retire.
    """

    VERSION = 1

    def __init__(
        self,
        entries: Optional[Dict[Tuple[str, str], List[Point]]] = None,
        *,
        max_entries: Optional[int] = None,
    ):
        if max_entries is not None and int(max_entries) < 1:
            raise ValueError(f"max_entries must be >= 1 (got {max_entries})")
        self._entries: Dict[Tuple[str, str], List[Point]] = dict(entries or {})
        self._observed: Dict[Tuple[str, str], float] = {}
        # energy-RATE point lists keyed like _entries (see module docstring)
        self._energy: Dict[Tuple[str, str], List[Point]] = {}
        self.max_entries = int(max_entries) if max_entries is not None else None
        self._evict()

    # -- in-memory protocol ---------------------------------------------------

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: Tuple[str, str]) -> bool:
        return tuple(key) in self._entries

    def keys(self):
        return self._entries.keys()

    def _touch(self, key: Tuple[str, str]) -> None:
        # Recency = dict insertion order; re-inserting moves the key to the
        # end, so eviction pops from the front.
        self._entries[key] = self._entries.pop(key)

    def _evict(self) -> None:
        if self.max_entries is None:
            return
        while len(self._entries) > self.max_entries:
            key = next(iter(self._entries))
            del self._entries[key]
            self._observed.pop(key, None)
            self._energy.pop(key, None)

    def observed_at(self, device_class: str, workload: str) -> Optional[float]:
        """When this entry's points were last recorded (``record``'s ``now``),
        or None for entries that predate the timestamp field."""
        return self._observed.get((str(device_class), str(workload)))

    def drop(self, device_class: str, workload: str) -> bool:
        """Remove one entry (the staleness path: a warm prediction that the
        first measured round contradicts).  True if something was dropped."""
        key = (str(device_class), str(workload))
        self._observed.pop(key, None)
        self._energy.pop(key, None)
        return self._entries.pop(key, None) is not None

    def get(self, device_class: str, workload: str) -> Optional[List[Point]]:
        """The stored points for one (class, workload) pair, or None."""
        key = (str(device_class), str(workload))
        pts = self._entries.get(key)
        if pts is None:
            return None
        ok = _valid_points(pts)
        if ok is None:
            _warn(
                f"profile registry entry ({device_class!r}, {workload!r}) is "
                "malformed; ignoring it (cold start)",
                kind="malformed_entry",
                device_class=str(device_class),
                workload=str(workload),
            )
            return None
        self._touch(key)
        return list(ok)

    def record(
        self,
        device_class: str,
        workload: str,
        points: Sequence[Point],
        *,
        now: Optional[float] = None,
    ) -> None:
        """Merge one estimate's points into its entry (``add_point``
        semantics: duplicate ``x`` replaces — freshest observation wins).
        ``now`` overrides the ``observed_at`` timestamp (tests)."""
        key = (str(device_class), str(workload))
        merged = PiecewiseLinearFPM.from_points(self._entries.get(key, []))
        for x, s in points:
            merged.add_point(float(x), float(s))
        self._entries.pop(key, None)
        self._entries[key] = [(float(x), float(s)) for x, s in merged.as_points()]
        self._observed[key] = float(now) if now is not None else time.time()
        self._evict()

    # -- energy profiles (same keys, energy-rate points) ----------------------

    def get_energy(self, device_class: str, workload: str) -> Optional[List[Point]]:
        """The stored energy-rate points for one (class, workload) pair, or
        None.  Malformed entries degrade exactly like :meth:`get`."""
        key = (str(device_class), str(workload))
        pts = self._energy.get(key)
        if pts is None:
            return None
        ok = _valid_points(pts)
        if ok is None:
            _warn(
                f"energy profile entry ({device_class!r}, {workload!r}) is "
                "malformed; ignoring it",
                kind="malformed_energy_entry",
                device_class=str(device_class),
                workload=str(workload),
            )
            return None
        return list(ok)

    def record_energy(
        self, device_class: str, workload: str, points: Sequence[Point]
    ) -> None:
        """Merge energy-rate points into the key's energy entry (duplicate
        ``x`` replaces — freshest observation wins)."""
        key = (str(device_class), str(workload))
        merged = PiecewiseLinearFPM.from_points(self._energy.get(key, []))
        for x, s in points:
            merged.add_point(float(x), float(s))
        self._energy[key] = [(float(x), float(s)) for x, s in merged.as_points()]

    def warm_energy_models(
        self, device_classes: Sequence[str], workload: Optional[str]
    ) -> Optional[List[PiecewiseLinearFPM]]:
        """One energy-rate model per processor, or None unless EVERY
        processor's class has a valid energy entry (a partial energy bank
        cannot price a fleet-wide cap, so it is all-or-nothing — unlike
        speed warm starts, where a cold row just costs measurement rounds)."""
        if workload is None:
            return None
        models = []
        for cls_ in device_classes:
            pts = self.get_energy(cls_, workload)
            if not pts:
                return None
            models.append(PiecewiseLinearFPM.from_points(pts))
        return models

    # -- the fleet-facing pair ------------------------------------------------

    def warm_models(
        self, device_classes: Sequence[str], workload: Optional[str]
    ) -> List[PiecewiseLinearFPM]:
        """One model per processor, warm where the registry has a valid
        entry for that processor's class, empty (cold) otherwise."""
        models = []
        for cls_ in device_classes:
            pts = self.get(cls_, workload) if workload is not None else None
            models.append(
                PiecewiseLinearFPM.from_points(pts) if pts else PiecewiseLinearFPM()
            )
        return models

    def record_job(
        self,
        device_classes: Sequence[str],
        workload: Optional[str],
        models: Sequence[PiecewiseLinearFPM],
        *,
        now: Optional[float] = None,
        energy_models: Optional[Sequence[PiecewiseLinearFPM]] = None,
    ) -> None:
        """Fold a retiring job's learned estimates back in, processor by
        processor in index order (same-class processors merge into one
        entry; deterministic, so a registry round-trip is reproducible).
        ``energy_models`` (energy-rate FPMs) ride along into the energy
        entries when given."""
        if workload is None:
            return
        for cls_, m in zip(device_classes, models):
            pts = m.as_points() if getattr(m, "num_points", 0) > 0 else []
            if pts:
                self.record(cls_, workload, pts, now=now)
        if energy_models is not None:
            for cls_, m in zip(device_classes, energy_models):
                pts = m.as_points() if getattr(m, "num_points", 0) > 0 else []
                if pts:
                    self.record_energy(cls_, workload, pts)

    # -- persistence (the state_dict protocol + JSON on disk) -----------------

    def state_dict(self) -> Dict:
        out = []
        for (c, w), pts in sorted(self._entries.items()):
            e = {"device_class": c, "workload": w, "points": [[x, s] for x, s in pts]}
            ts = self._observed.get((c, w))
            if ts is not None:
                e["observed_at"] = ts  # optional field: older readers ignore it
            out.append(e)
        state = {"version": self.VERSION, "entries": out}
        if self._energy:
            # optional field: older readers ignore it (VERSION stays 1)
            state["energy_entries"] = [
                {"device_class": c, "workload": w, "points": [[x, s] for x, s in pts]}
                for (c, w), pts in sorted(self._energy.items())
            ]
        return state

    @classmethod
    def from_state(
        cls, state: Dict, *, max_entries: Optional[int] = None
    ) -> "ProfileRegistry":
        entries: Dict[Tuple[str, str], List[Point]] = {}
        observed: Dict[Tuple[str, str], float] = {}
        raw = state.get("entries")
        if not isinstance(raw, list):
            raise ValueError("registry state has no entries list")
        for e in raw:
            pts = _valid_points(e.get("points", []))
            if pts is None:
                _warn(
                    f"skipping malformed registry entry "
                    f"({e.get('device_class')!r}, {e.get('workload')!r})",
                    kind="malformed_state_entry",
                    device_class=str(e.get("device_class")),
                    workload=str(e.get("workload")),
                )
                continue
            key = (str(e["device_class"]), str(e["workload"]))
            entries[key] = pts
            ts = e.get("observed_at")
            if isinstance(ts, (int, float)) and ts == ts:
                observed[key] = float(ts)
        reg = cls(entries, max_entries=max_entries)
        reg._observed = {k: observed[k] for k in observed if k in reg._entries}
        for e in state.get("energy_entries") or []:
            pts = _valid_points(e.get("points", []))
            if pts is None:
                _warn(
                    f"skipping malformed energy registry entry "
                    f"({e.get('device_class')!r}, {e.get('workload')!r})",
                    kind="malformed_state_energy_entry",
                    device_class=str(e.get("device_class")),
                    workload=str(e.get("workload")),
                )
                continue
            reg._energy[(str(e["device_class"]), str(e["workload"]))] = pts
        return reg

    def save(self, path: str) -> None:
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(self.state_dict(), f, indent=1)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "ProfileRegistry":
        """Load from disk; ANY failure — missing file, corrupt JSON, wrong
        shape — warns and returns an empty registry (cold start), never
        raises: a broken profile cache must not take the fleet down."""
        try:
            with open(path) as f:
                state = json.load(f)
        except FileNotFoundError:
            _warn(
                f"profile registry {path!r} not found; starting cold",
                kind="not_found",
                path=str(path),
            )
            return cls()
        except (OSError, json.JSONDecodeError) as e:
            _warn(
                f"profile registry {path!r} unreadable ({e}); starting cold",
                kind="unreadable",
                path=str(path),
                error=str(e),
            )
            return cls()
        try:
            return cls.from_state(state)
        except (ValueError, KeyError, TypeError) as e:
            _warn(
                f"profile registry {path!r} malformed ({e}); starting cold",
                kind="malformed",
                path=str(path),
                error=str(e),
            )
            return cls()
