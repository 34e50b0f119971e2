"""Arithmetic that several metric readers share.  A reader that finds
nothing to read returns ``None``, and the run leaves its metric out; a
share of a peak or a roofline is never reported as 0 for want of data."""

from __future__ import annotations

import sys
from typing import Dict, Optional

from bench.lib import counts
from bench.lib.trace import kernel_seconds


def mfu_pct(record: Dict, work: str) -> Optional[float]:
    """The work's operations over the card time of the runs that did it
    (CUDA events, repeats included), as a share of the bf16 peak."""
    w = record.get("work", {}).get(work)
    if not w or w["card_s"] <= 0:
        return None
    return 100.0 * w["flops"] / w["card_s"] / counts.PEAK_FLOPS_BF16


def roofline_pct(record: Dict, kernel: str, fragment: str) -> Optional[float]:
    """The kernel's least time (its bound, summed over every launch of the
    window) over its device time in the trace.  ``None`` without a trace,
    and when the trace does not hold exactly the launches the window made."""
    launched, seconds = kernel_seconds(record.get("trace"), fragment)
    want = record.get("bounds", {}).get(kernel)
    if not launched or not want or seconds <= 0:
        return None
    if launched != want["launches"]:
        print(f"bench: the trace holds {launched} {kernel} launches, the window made {want['launches']}",
              file=sys.stderr)
        return None
    return 100.0 * want["bound_s"] / seconds


def idle_pct(record: Dict) -> Optional[float]:
    """The share of the traced window in which no work ran on the card."""
    tr = record.get("trace")
    if not tr or tr["busy_s"] <= 0 or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
