"""The telemetry sink: spans, counters, gauges, events — and the no-op.

Design constraints (they shape every API choice here):

* **Near-zero cost when disabled.**  The scheduler stack is instrumented on
  its hot paths (every round, every fold, every bisection).  All
  instrumentation sites follow one pattern::

      tel = _obs_active()
      if tel is not None and tel.enabled:
          ...record...

  so a disabled build executes two attribute checks and nothing else — no
  allocation, no call into this module (``tests/test_torch_obs.py`` locks
  this with a counting stub sink).  ``span()`` context managers are reserved for
  cold paths (examples, harnesses); hot paths use explicit
  ``t0 = tel.clock()`` … ``tel.span_at(name, t0, tel.clock())`` pairs.

* **Never on device paths.**  Telemetry records host-side bookkeeping only;
  no instrumentation site touches a tensor bound for the card or waits for
  it, so results are bit-identical with telemetry on or off.

* **Process-global, import-optional.**  The active sink is a module global
  (``active()`` / ``install()``); instrumented modules import it inside a
  ``try`` so the whole ``repro_torch.obs`` package can be absent (or stubbed by a
  test) without changing scheduler behaviour.

* **Injectable clock.**  ``Telemetry(clock=...)`` makes traces deterministic
  in tests and lets harnesses record on a simulated time axis.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Dict, List, NamedTuple, Optional

__all__ = [
    "Event",
    "Telemetry",
    "NoopTelemetry",
    "NOOP",
    "active",
    "install",
    "uninstall",
    "use",
]


class Event(NamedTuple):
    """One recorded fact.  ``kind`` is ``"span"`` (t0 < t1), ``"counter"``
    (value = increment), ``"gauge"`` (value = level) or ``"event"`` (a point
    occurrence); ``attrs`` carries site-specific context (JSON-safe)."""

    kind: str
    name: str
    t0: float
    t1: float
    value: float
    attrs: Dict[str, Any]

    def to_dict(self) -> Dict[str, Any]:
        return {
            "kind": self.kind,
            "name": self.name,
            "t0": self.t0,
            "t1": self.t1,
            "value": self.value,
            "attrs": dict(self.attrs),
        }


class _Span:
    """Context-manager span (cold paths; hot paths use ``span_at``)."""

    __slots__ = ("_tel", "_name", "_attrs", "_t0")

    def __init__(self, tel: "Telemetry", name: str, attrs: Dict[str, Any]):
        self._tel = tel
        self._name = name
        self._attrs = attrs

    def __enter__(self) -> "_Span":
        self._t0 = self._tel.clock()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self._tel.span_at(self._name, self._t0, self._tel.clock(), **self._attrs)
        return False


class _NoopSpan:
    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NOOP_SPAN = _NoopSpan()
_EMPTY: Dict[str, Any] = {}


class Telemetry:
    """A recording sink.

    ``capacity`` bounds the event buffer (a ring: oldest events drop) —
    the flight recorder builds on this; ``None`` keeps everything.
    ``counters`` accumulate (name -> running total) and ``gauges`` hold the
    last written level, independent of the ring, so a bounded recorder
    still reports whole-run totals.
    """

    enabled: bool = True

    def __init__(
        self,
        *,
        clock: Callable[[], float] = time.perf_counter,
        capacity: Optional[int] = None,
    ):
        self.clock = clock
        self.capacity = capacity
        self.events: Any = (
            [] if capacity is None else deque(maxlen=int(capacity))
        )
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}

    # -- recording ------------------------------------------------------------

    def span(self, name: str, **attrs: Any) -> _Span:
        """``with tel.span("repartition"): ...`` — records one span event."""
        return _Span(self, name, attrs)

    def span_at(self, name: str, t0: float, t1: float, **attrs: Any) -> None:
        """Record a span with explicit endpoints (hot paths, simulated
        time axes)."""
        self.events.append(Event("span", name, t0, t1, t1 - t0, attrs or _EMPTY))

    def counter(self, name: str, value: float = 1, **attrs: Any) -> None:
        self.counters[name] = self.counters.get(name, 0) + value
        t = self.clock()
        self.events.append(Event("counter", name, t, t, value, attrs or _EMPTY))

    def gauge(self, name: str, value: float, **attrs: Any) -> None:
        self.gauges[name] = value
        t = self.clock()
        self.events.append(Event("gauge", name, t, t, value, attrs or _EMPTY))

    def event(self, name: str, **attrs: Any) -> None:
        t = self.clock()
        self.events.append(Event("event", name, t, t, 1.0, attrs or _EMPTY))

    # -- introspection --------------------------------------------------------

    def spans(self, name: Optional[str] = None) -> List[Event]:
        return [
            e for e in self.events
            if e.kind == "span" and (name is None or e.name == name)
        ]

    def to_payload(self) -> Dict[str, Any]:
        """JSON-safe dump: the (possibly ring-bounded) events plus the
        unbounded counter totals and last gauge levels."""
        return {
            "events": [e.to_dict() for e in self.events],
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
        }

    def clear(self) -> None:
        self.events.clear()
        self.counters.clear()
        self.gauges.clear()


class NoopTelemetry:
    """The disabled default.  ``enabled`` is False so guarded call sites
    skip it entirely; the methods still exist (and do nothing) so an
    unguarded call is safe."""

    enabled: bool = False
    clock = staticmethod(time.perf_counter)

    def span(self, name: str, **attrs: Any) -> _NoopSpan:
        return _NOOP_SPAN

    def span_at(self, name: str, t0: float, t1: float, **attrs: Any) -> None:
        return None

    def counter(self, name: str, value: float = 1, **attrs: Any) -> None:
        return None

    def gauge(self, name: str, value: float, **attrs: Any) -> None:
        return None

    def event(self, name: str, **attrs: Any) -> None:
        return None


NOOP = NoopTelemetry()
_ACTIVE: Any = NOOP


def active() -> Any:
    """The process-global sink every instrumentation site consults."""
    return _ACTIVE


def install(tel: Optional[Any]) -> Any:
    """Make ``tel`` the process-global sink; returns the previous one.
    ``install(None)`` restores the no-op."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = tel if tel is not None else NOOP
    return prev


def uninstall() -> None:
    install(None)


class use:
    """``with use(tel): ...`` — scoped install/restore."""

    def __init__(self, tel: Optional[Any]):
        self._tel = tel
        self._prev: Any = None

    def __enter__(self) -> Any:
        self._prev = install(self._tel)
        return self._tel

    def __exit__(self, exc_type, exc, tb) -> bool:
        install(self._prev)
        return False
