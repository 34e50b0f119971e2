"""Chrome-trace / Perfetto JSON export of a telemetry recording.

The Trace Event Format (the ``chrome://tracing`` / Perfetto JSON dialect)
renders named duration events on per-thread tracks: the scheduler track
shows the ``scheduler.*``, ``speedstore.*`` and ``hier.*`` spans of a
session in order, and a span's ``track`` attribute puts it on a row of its
own (the serving dispatcher's per-replica rows).

Mapping:

* span events  -> ``"ph": "X"`` complete events (``ts``/``dur`` in µs);
* counters and gauges -> ``"ph": "C"`` counter events (charted as stacked
  area tracks by the viewers);
* point events -> ``"ph": "i"`` instant events;
* tracks       -> synthetic ``tid`` s, named via ``thread_name`` metadata —
  a span's ``track`` attr (e.g. ``"replica:3"``) picks its row; everything
  else lands on the ``"scheduler"`` track.

The written file is a superset of the format: alongside ``traceEvents`` it
carries a ``repro`` block (counter totals, gauge levels) which the viewers
ignore but ``python -m repro_torch.obs.report`` reads back; the block keeps
the reference package's key, so either package's report reads either
package's trace.  Timestamps are whatever clock the
:class:`~repro_torch.obs.telemetry.Telemetry` was built with, scaled to
microseconds.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from .telemetry import Telemetry

__all__ = ["to_chrome_trace", "export_chrome_trace"]

_SCHEDULER_TRACK = "scheduler"


def to_chrome_trace(tel: Telemetry) -> Dict[str, Any]:
    """Build the trace dict (see module docstring) from a recording."""
    tracks: Dict[str, int] = {_SCHEDULER_TRACK: 0}
    trace_events: List[Dict[str, Any]] = []

    def tid(track: str) -> int:
        t = tracks.get(track)
        if t is None:
            t = tracks[track] = len(tracks)
        return t

    for e in tel.events:
        track = e.attrs.get("track", _SCHEDULER_TRACK) if e.attrs else _SCHEDULER_TRACK
        args = {k: v for k, v in (e.attrs or {}).items() if k != "track"}
        if e.kind == "span":
            trace_events.append({
                "name": e.name,
                "cat": e.name.split(".", 1)[0],
                "ph": "X",
                "ts": e.t0 * 1e6,
                "dur": max((e.t1 - e.t0) * 1e6, 0.0),
                "pid": 0,
                "tid": tid(track),
                "args": args,
            })
        elif e.kind in ("counter", "gauge"):
            trace_events.append({
                "name": e.name,
                "ph": "C",
                "ts": e.t0 * 1e6,
                "pid": 0,
                "args": {e.kind: e.value, **args},
            })
        else:
            trace_events.append({
                "name": e.name,
                "cat": e.name.split(".", 1)[0],
                "ph": "i",
                "s": "g",
                "ts": e.t0 * 1e6,
                "pid": 0,
                "tid": tid(track),
                "args": args,
            })
    for track, t in tracks.items():
        trace_events.append({
            "name": "thread_name",
            "ph": "M",
            "pid": 0,
            "tid": t,
            "args": {"name": track},
        })
    return {
        "traceEvents": trace_events,
        "displayTimeUnit": "ms",
        "repro": {
            "counters": dict(tel.counters),
            "gauges": dict(tel.gauges),
        },
    }


def export_chrome_trace(tel: Telemetry, path: str) -> Dict[str, Any]:
    """Write the trace JSON to ``path``; returns the written dict."""
    trace = to_chrome_trace(tel)
    with open(path, "w") as f:
        json.dump(trace, f)
    return trace


def span_count(trace: Dict[str, Any], name: Optional[str] = None) -> int:
    """Number of duration spans in an exported trace (validation helper)."""
    return sum(
        1
        for ev in trace.get("traceEvents", [])
        if ev.get("ph") == "X" and (name is None or ev.get("name") == name)
    )
