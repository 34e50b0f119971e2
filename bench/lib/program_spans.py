"""The program's own spans: what ``repro_torch.obs`` records into its
profiled sink (``obs.profiled()``) while ``torch.profiler`` records, which
in a run of ``bench/run.py`` is the traced window alone.  The sink keeps
every profiler session of the process, and a run traces one window.

A program without that sink, or a window in which the spans were not
recorded, gives ``None``: never 0 for want of data.
"""

from __future__ import annotations

from typing import List, Optional


def sink():
    """The program's profiled sink, or ``None`` where it has none."""
    from repro_torch import obs

    get = getattr(obs, "profiled", None)
    return get() if get is not None else None


def spans(name: str) -> List:
    tel = sink()
    return tel.spans(name) if tel is not None else []


def mean_ms(name: str) -> Optional[float]:
    """The mean host time of the spans named ``name``, in ms."""
    got = spans(name)
    if not got:
        return None
    return 1e3 * sum(e.t1 - e.t0 for e in got) / len(got)
