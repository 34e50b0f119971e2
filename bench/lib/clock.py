"""Platform time: what the paper's parallel platform would take.

The benchmark emulates heterogeneous processors (or replicas) on one card:
each runs its share ``r_i`` times over, one after another.  A round of the
real platform runs them side by side, so it takes ``max_i t_i``, each
``t_i`` read from CUDA events around that processor's work.  Between rounds
the platform waits for the scheduler: its host time is read on the host
clock with the card drained before and after.  Platform time is the sum of
both over the window.
"""

from __future__ import annotations

import time
from typing import Callable, List, Tuple

import torch


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Span:
    """The time of the work enqueued inside ``with``: CUDA events on the
    card (read later, without a synchronisation in between), the host
    clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)

    def __enter__(self) -> "Span":
        if self.cuda:
            self.start.record()
        else:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        if self.cuda:
            self.end.record()
        else:
            self.t1 = time.perf_counter()
        return False

    def seconds(self) -> float:
        if self.cuda:
            self.end.synchronize()
            return self.start.elapsed_time(self.end) / 1e3
        return self.t1 - self.t0


class SchedClock:
    """Host time of the scheduler's calls, each timed with the card drained
    before and after (a real platform waits for the scheduler).  ``wrap``
    times methods of an object in place; ``take`` returns the seconds since
    the last ``take`` and starts a new stretch."""

    def __init__(self, device: torch.device):
        self.device = device
        self.calls: List[Tuple[str, float]] = []
        self._since = 0

    def timed(self, name: str, fn: Callable) -> Callable:
        def call(*args, **kwargs):
            sync(self.device)
            t0 = time.perf_counter()
            with torch.profiler.record_function(f"bench.sched.{name}"):
                out = fn(*args, **kwargs)
                sync(self.device)
            self.calls.append((name, time.perf_counter() - t0))
            return out
        return call

    def wrap(self, obj, *names: str) -> None:
        for name in names:
            setattr(obj, name, self.timed(name, getattr(obj, name)))

    def take(self) -> float:
        seconds = sum(s for _, s in self.calls[self._since:])
        self._since = len(self.calls)
        return seconds
