"""Observability for the port's scheduler stack: spans, counters, gauges,
traces.

Observing the scheduler
=======================

The paper's central empirical claim is an observability claim: the cost of
distributing the computation (partial FPM estimation + repartitioning) is
orders of magnitude below the execution it optimizes.  This package lets
you *watch* that claim on a live session.  It is the reference package's
``obs`` with the port's clock, profiler rule and sites added: its modules
import only the standard library and each other (never torch), and record
the reference's names at the reference's sites.

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

or by profiling: with no sink installed, every site records into the
process-global ``obs.profiled()`` sink while a ``torch.profiler`` session
records (torch's own flag, looked up in ``sys.modules``), and into nothing
otherwise.  No environment variable or argument turns it on; the profiled
sink keeps every session's events until ``obs.profiled().clear()``::

    with torch.profiler.profile(activities=[...]):
        ...  # serve, iterate
    spans = obs.profiled().spans("engine.generate")

What gets recorded (the port's instrumented layers):

* ``Scheduler`` — ``scheduler.partition`` / ``scheduler.autotune`` spans
  (iterations, convergence), ``scheduler.observe`` counters,
  ``scheduler.reprofile`` events; the port's own: a ``scheduler.observe``
  span around each ``observe`` (attribute ``repartitioned``) and a
  ``scheduler.repartition`` counter when it changed the distribution;
* ``CallableExecutor`` (the port's own) — an ``executor.proc`` span a timed
  processor run, from before its start event is recorded to after its end
  event is synchronized (attributes ``proc``, ``units``, ``round`` and
  ``device_s``, the CUDA-event seconds the executor reads anyway);
* ``ServeEngine`` (the port's own) — an ``engine.generate`` span a call:
  the host time of making the cache and enqueuing prefill and decode
  (attributes ``batch``, ``prompt_tokens`` a sequence, ``new_tokens``);
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
  ``serve.split.{serve_host_s,sched_host_s}`` gauges of each
  ``balance_fleet`` (the reference's third, their ratio, is left out).

Spans are host intervals on the clock of ``torch.profiler``'s trace
(Unix-epoch seconds, ``time.time``), so they lie against the card's
timeline; no site records, synchronizes or reads the device for telemetry,
and none emits a ``record_function``, NVTX or other profiler event (the
trace would count it as device work).  A ``speedstore.partition`` span on
the torch backend covers the device work, since the partition returns host
lists; ``fold_in`` may return before the card has finished, and records
only its counter and gauge.

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
    profiled,
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
    "profiled",
    "install",
    "uninstall",
    "use",
    "FlightRecorder",
    "MetricsSnapshot",
    "export_chrome_trace",
    "to_chrome_trace",
]
