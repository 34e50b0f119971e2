"""Observability for the port's scheduler stack: spans, counters, gauges,
traces.

Observing the scheduler
=======================

The paper's central empirical claim is an observability claim: the cost of
distributing the computation (partial FPM estimation + repartitioning) is
orders of magnitude below the execution it optimizes.  This package lets
you *watch* that claim on a live session.  It is the reference package's
``obs`` copied as it is: its modules import only the standard library and
each other, and record the reference's names at the reference's sites.

Everything is off by default — the process-global sink is a no-op and every
instrumentation site in the stack guards itself with a cheap ``enabled``
check, so an uninstrumented run is bit-identical, and it never waits for
the card.  Turn it on by installing a sink::

    from repro_torch import obs

    tel = obs.Telemetry()           # unbounded recording sink
    obs.install(tel)                # process-global: all layers now report
    ...  # run Scheduler work
    obs.uninstall()                 # back to the no-op

    # scoped form
    with obs.use(obs.Telemetry()) as tel:
        sched.autotune(executor, n, eps)

What gets recorded (the port's instrumented layers):

* ``Scheduler`` — ``scheduler.partition`` / ``scheduler.autotune`` spans
  (iterations, convergence), ``scheduler.observe`` counters,
  ``scheduler.reprofile`` events;
* ``SpeedStore`` — ``speedstore.fold_in`` counters, the
  ``speedstore.fold_generation`` gauge, ``speedstore.partition`` spans; the
  host backends (``numpy``, ``scalar``) also gauge
  ``speedstore.bisection_steps``, the host bisection's iteration count,
  which the torch backend, like the reference's jax one, does not have;
* ``Hierarchy`` — aggregation-cache hit/miss counters and outer/inner
  solve spans;
* ``StragglerDetector`` — ``straggler.strike`` events carrying the
  (predicted, observed, ratio) evidence and ``straggler.verdict`` events
  for REPROFILE/QUARANTINE;
* ``FleetScheduler`` and ``ProfileRegistry`` — the ``fleet.*`` spans,
  counters and gauges and ``registry.*`` warnings, as in the reference;
* ``ReplicaDispatcher`` — ``serve.replica_busy`` spans on ``replica:{i}``
  tracks of the simulated serving timeline, and the
  ``serve.split.{serve_host_s,sched_host_s,sched_over_serve}`` gauges of
  each ``balance_fleet``.

Spans read the host clock.  A ``speedstore.partition`` span on the torch
backend covers the device work, since the partition returns host lists;
``fold_in`` may return before the card has finished, and records only its
counter and gauge.

Artifacts:

* :func:`~repro_torch.obs.chrometrace.export_chrome_trace` writes a
  Chrome-trace/Perfetto JSON (open in ``chrome://tracing`` or
  https://ui.perfetto.dev).
* :class:`~repro_torch.obs.flightrec.FlightRecorder` — a ring-bounded sink
  plus estimate snapshots, dumped to JSON on QUARANTINE or gate failure for
  post-incident forensics without a rerun.
* ``python -m repro_torch.obs.report trace.json`` — the paper-style summary
  table (fold-ins, straggler strikes and verdicts, span wall totals) from
  either artifact.
"""

from .chrometrace import export_chrome_trace, to_chrome_trace
from .flightrec import FlightRecorder
from .telemetry import (
    NOOP,
    Event,
    NoopTelemetry,
    Telemetry,
    active,
    install,
    uninstall,
    use,
)

def __getattr__(name):
    # Lazy: ``python -m repro_torch.obs.report`` executes report as
    # __main__, and an eager package-level import of the same module would
    # make runpy warn about the double life.
    if name == "MetricsSnapshot":
        from .report import MetricsSnapshot

        return MetricsSnapshot
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "Event",
    "Telemetry",
    "NoopTelemetry",
    "NOOP",
    "active",
    "install",
    "uninstall",
    "use",
    "FlightRecorder",
    "MetricsSnapshot",
    "export_chrome_trace",
    "to_chrome_trace",
]
