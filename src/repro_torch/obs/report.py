"""Summarize a telemetry recording into the paper-style table.

``MetricsSnapshot.from_payload`` accepts either artifact this package
writes — a Chrome-trace export (``{"traceEvents": [...], "repro": ...}``)
or a flight-recorder / ``Telemetry.to_payload()`` dump (``{"events": ...,
"counters": ..., "gauges": ...}``) — and distills the scheduler-stack
signals into one row: the paper's overhead fraction (distribution cost vs
execution time), device dispatches per round, compile counts, speculation
hit rates, and straggler reaction.

Run it on a file::

    python -m repro_torch.obs.report trace.json
"""

from __future__ import annotations

import json
import sys
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["MetricsSnapshot", "summarize", "main"]


def _load_counters_gauges(payload: Dict[str, Any]) -> Tuple[Dict, Dict, List]:
    """(counters, gauges, span rows) from either artifact format.  Span rows
    are ``(name, duration_seconds)``."""
    spans: List[Tuple[str, float]] = []
    if "traceEvents" in payload:
        repro = payload.get("repro", {})
        for ev in payload["traceEvents"]:
            if ev.get("ph") == "X":
                spans.append((ev.get("name", "?"), float(ev.get("dur", 0.0)) / 1e6))
        return dict(repro.get("counters", {})), dict(repro.get("gauges", {})), spans
    for e in payload.get("events", []):
        if e.get("kind") == "span":
            spans.append((e.get("name", "?"), float(e["t1"]) - float(e["t0"])))
    return (
        dict(payload.get("counters", {})),
        dict(payload.get("gauges", {})),
        spans,
    )


@dataclass
class MetricsSnapshot:
    """One summarized recording (all fields optional: a recording made by a
    bare ``Scheduler`` simply leaves the fleet/serving rows None; the
    serving rows are gauges a serving-trace harness sets, which the port
    does not have yet, and its fleet never records recompiles, so those
    read 0)."""

    rounds: Optional[float] = None
    device_dispatches: Optional[float] = None
    dispatches_per_round: Optional[float] = None
    restacks: Optional[float] = None
    recompiles_partition: float = 0.0
    recompiles_fold: float = 0.0
    predispatches: Optional[float] = None
    stale_reads: Optional[float] = None
    speculative_misses: Optional[float] = None
    speculation_hit_rate: Optional[float] = None
    fold_ins: float = 0.0
    overhead_frac: Optional[float] = None
    reaction_epochs: Optional[float] = None
    strikes: float = 0.0
    reprofiles: float = 0.0
    quarantines: float = 0.0
    span_totals: Dict[str, float] = field(default_factory=dict)
    span_counts: Dict[str, int] = field(default_factory=dict)

    @classmethod
    def from_payload(cls, payload: Dict[str, Any]) -> "MetricsSnapshot":
        counters, gauges, spans = _load_counters_gauges(payload)
        snap = cls()
        snap.rounds = gauges.get("fleet.rounds")
        snap.device_dispatches = gauges.get("fleet.device_dispatches")
        if snap.rounds and snap.device_dispatches is not None:
            snap.dispatches_per_round = snap.device_dispatches / snap.rounds
        snap.restacks = gauges.get("fleet.restacks")
        snap.recompiles_partition = counters.get("fleet.recompile.partition", 0.0)
        snap.recompiles_fold = counters.get("fleet.recompile.fold", 0.0)
        snap.predispatches = gauges.get("fleet.predispatches")
        snap.stale_reads = gauges.get("fleet.stale_reads")
        snap.speculative_misses = gauges.get("fleet.speculative_misses")
        if snap.stale_reads is not None and snap.speculative_misses is not None:
            tried = snap.stale_reads + snap.speculative_misses
            if tried > 0:
                snap.speculation_hit_rate = snap.stale_reads / tried
        snap.fold_ins = counters.get("speedstore.fold_in", 0.0)
        snap.overhead_frac = gauges.get("serve.rebalance_overhead_frac")
        snap.reaction_epochs = gauges.get("serve.reaction_epochs")
        snap.strikes = counters.get("straggler.strike", 0.0)
        snap.reprofiles = counters.get("straggler.reprofile", 0.0)
        snap.quarantines = counters.get("straggler.quarantine", 0.0)
        for name, dur in spans:
            snap.span_totals[name] = snap.span_totals.get(name, 0.0) + dur
            snap.span_counts[name] = snap.span_counts.get(name, 0) + 1
        return snap

    @classmethod
    def from_file(cls, path: str) -> "MetricsSnapshot":
        with open(path) as f:
            return cls.from_payload(json.load(f))

    def table(self) -> str:
        """The paper-style summary table as a string."""
        rows: List[Tuple[str, str]] = []

        def add(label: str, v, fmt: str = "{:.4g}") -> None:
            if v is not None:
                rows.append((label, fmt.format(v)))

        add("overhead fraction (rebalance / serving)", self.overhead_frac, "{:.4%}")
        add("rounds", self.rounds, "{:.0f}")
        add("device dispatches", self.device_dispatches, "{:.0f}")
        add("dispatches / round", self.dispatches_per_round)
        add("restacks", self.restacks, "{:.0f}")
        add("recompiles (partition)", self.recompiles_partition, "{:.0f}")
        add("recompiles (fold)", self.recompiles_fold, "{:.0f}")
        add("pre-dispatched partitions", self.predispatches, "{:.0f}")
        add("speculative reads consumed", self.stale_reads, "{:.0f}")
        add("speculative misses", self.speculative_misses, "{:.0f}")
        add("speculation hit rate", self.speculation_hit_rate, "{:.1%}")
        add("fold-ins", self.fold_ins or None, "{:.0f}")
        add("straggler strikes", self.strikes or None, "{:.0f}")
        add("reprofiles", self.reprofiles or None, "{:.0f}")
        add("quarantines", self.quarantines or None, "{:.0f}")
        add("reaction (epochs)", self.reaction_epochs, "{:.0f}")
        width = max((len(k) for k, _ in rows), default=10)
        lines = [f"  {k:<{width}}  {v}" for k, v in rows]
        if self.span_totals:
            lines.append("")
            lines.append("  span wall totals:")
            for name in sorted(self.span_totals, key=self.span_totals.get,
                               reverse=True):
                lines.append(
                    f"    {name:<28} {self.span_totals[name] * 1e3:10.3f} ms"
                    f"  x{self.span_counts[name]}"
                )
        return "\n".join(lines)


def summarize(path: str) -> MetricsSnapshot:
    snap = MetricsSnapshot.from_file(path)
    print(f"== {path}")
    print(snap.table())
    return snap


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print("usage: python -m repro_torch.obs.report TRACE_OR_RECORDER_JSON...",
              file=sys.stderr)
        return 2
    for path in argv:
        summarize(path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
