"""The traced run: ``torch.profiler`` over the measured window, reduced to
the device's busy time, time by kernel and idle gaps by what the host was
doing.

The window is marked by a ``bench.window`` annotation; device activity
(kernels, copies, fills) is clipped to it and merged, so overlapping work
counts once.  A gap between device activities is named by the innermost
``bench.*`` annotation the host was inside at its midpoint (``host`` when
none).  Gaps shorter than ``SHORT_GAP_NS`` are summed as ``launch``: the
host enqueuing the next kernel behind a running one.  Every event on the
card (kernels, copies, fills) counts as busy; of the host's events only the
``bench.*`` annotations are kept (a traced window holds millions of
operator events).
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional

import torch
from torch.autograd import DeviceType

SHORT_GAP_NS = 20_000
TOP = 10
NAME_CHARS = 120


def _start_ns(e) -> int:
    return e.start_ns() if hasattr(e, "start_ns") else int(e.start_us() * 1000)


def _duration_ns(e) -> int:
    return e.duration_ns() if hasattr(e, "duration_ns") else int(e.duration_us() * 1000)


class Tracer:
    """``with Tracer(on, device): ...`` profiles the block when ``on``;
    ``summary()`` reduces the trace (``None`` when off)."""

    def __init__(self, on: bool, device: torch.device):
        self.on, self.device, self.prof = on, device, None

    def __enter__(self) -> "Tracer":
        if self.on:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()
        self._window = torch.profiler.record_function("bench.window")
        self._window.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        self._window.__exit__(*exc)
        if self.prof is not None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.prof.__exit__(*exc)
        return False

    def summary(self) -> Optional[Dict]:
        if self.prof is None:
            return None
        return reduce_events(self.prof.profiler.kineto_results.events())


def _merge(intervals: List[List[int]]) -> List[List[int]]:
    merged: List[List[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _innermost(starts: List[int], spans: List[tuple], t: int, steps: int = 64) -> Optional[str]:
    """The latest-starting span (start, end, name) that covers ``t``."""
    k = bisect.bisect_right(starts, t) - 1
    while k >= 0 and steps > 0:
        a, b, name = spans[k]
        if b >= t:
            return name
        k -= 1
        steps -= 1
    return None


def reduce_events(events) -> Optional[Dict]:
    window, notes, busy_iv = None, [], []
    kernels: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    device = []
    for e in events:
        name = e.name()
        on_card = e.device_type() == DeviceType.CUDA
        if name.startswith("bench."):
            if not on_card:
                a = _start_ns(e)
                span = (a, a + _duration_ns(e), name)
                if name == "bench.window":
                    window = span
                else:
                    notes.append(span)
        elif on_card:
            device.append((_start_ns(e), _duration_ns(e), name))
    if window is None:
        return None
    w0, w1, _ = window
    for a, dur, name in device:
        b = a + dur
        if b > w0 and a < w1:
            k = kernels[name]
            k[0] += 1
            k[1] += (min(b, w1) - max(a, w0)) / 1e9
            busy_iv.append([max(a, w0), min(b, w1)])
    busy = _merge(busy_iv)
    busy_s = sum(b - a for a, b in busy) / 1e9
    notes.sort()
    note_starts = [n[0] for n in notes]
    gaps: Dict[str, float] = defaultdict(float)
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        if b - a < SHORT_GAP_NS:
            gaps["launch"] += (b - a) / 1e9
            continue
        gaps[_innermost(note_starts, notes, (a + b) // 2) or "host"] += (b - a) / 1e9
    by_time = sorted(kernels.items(), key=lambda kv: -kv[1][1])
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy_s,
        "kernels": {name: {"count": c, "seconds": s} for name, (c, s) in kernels.items()},
        "device_ops": [[name[:NAME_CHARS], s] for name, (_, s) in by_time[:TOP]],
        "idle_gaps": [[name[:NAME_CHARS], s] for name, s in sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]],
    }


def kernel_seconds(summary: Optional[Dict], fragment: str) -> tuple:
    """(launches, device seconds) of the kernels whose name holds ``fragment``."""
    if not summary:
        return 0, 0.0
    hits = [k for name, k in summary["kernels"].items() if fragment in name]
    return sum(k["count"] for k in hits), sum(k["seconds"] for k in hits)
