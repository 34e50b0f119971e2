"""The flight recorder: a bounded telemetry ring plus estimate snapshots,
dumped to JSON when a serving incident fires.

A long-running session (a serving loop, a DFPA loop that keeps observing)
runs for hours; an unbounded event list is not an option and a
post-incident rerun rarely reproduces the throttle that caused the
QUARANTINE.  The recorder keeps the LAST ``capacity`` events (the telemetry
ring) and the last ``snapshot_capacity`` estimate snapshots the caller
takes per epoch, so when :meth:`dump` fires — on a QUARANTINE verdict or a
benchmark gate failure — the file already holds the rounds leading up to
the incident: the straggler strikes with their (predicted, observed, ratio)
evidence, the partition/fold spans, and what the session believed about every
processor at each recent epoch.
"""

from __future__ import annotations

import json
from collections import deque
from typing import Any, Callable, Dict, Optional

from .telemetry import Telemetry

__all__ = ["FlightRecorder"]


class FlightRecorder(Telemetry):
    """A :class:`Telemetry` sink whose event buffer is a ring.

    Install it like any sink (``obs.install(rec)``) — every instrumented
    layer then feeds the ring.  :meth:`snapshot` adds an estimate snapshot
    (any JSON-safe payload; serving loops typically record per-replica
    predicted speeds or the current distributions); :meth:`dump` writes
    everything plus the incident context to ``path``.
    """

    def __init__(
        self,
        *,
        capacity: int = 512,
        snapshot_capacity: int = 32,
        clock: Optional[Callable[[], float]] = None,
    ):
        kw = {"clock": clock} if clock is not None else {}
        super().__init__(capacity=int(capacity), **kw)
        self.snapshots: deque = deque(maxlen=int(snapshot_capacity))

    def snapshot(self, label: str, data: Any) -> None:
        """Record one estimate snapshot (ring-bounded like the events)."""
        self.snapshots.append({
            "t": self.clock(),
            "label": str(label),
            "data": data,
        })

    def dump(
        self,
        path: str,
        *,
        reason: str,
        context: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        """Write the incident file: reason + caller context + the ring of
        events + counter/gauge totals + the snapshot ring.  Returns the
        written payload."""
        payload: Dict[str, Any] = {
            "kind": "flight-recorder",
            "reason": str(reason),
            "context": dict(context or {}),
            "snapshots": list(self.snapshots),
        }
        payload.update(self.to_payload())
        with open(path, "w") as f:
            json.dump(payload, f, indent=2)
        return payload
