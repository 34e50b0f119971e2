"""The port's telemetry (``repro_torch.obs``): the sink API, the Chrome
trace, the flight recorder, the report, and the instrumentation of the
port's ``Scheduler``, ``SpeedStore``, ``Hierarchy`` and straggler detector.

The sink-level cases are the reference's (``tests/test_obs.py``, which does
not collect on this toolchain, ROADMAP R1).  The trace, report and
read-only cases drive one port session: ``autotune`` on the HCL simulator,
then serving rounds (``straggler_actions`` before ``observe``) in which one
processor slows down more every round until it is quarantined and
``leave`` s, then a grouped ``partition`` and ``observe`` and a ``join``.
A second session drives the fleet (``repro_torch.fleet``): registry
warnings and a stale profile, measured rounds, rebalances, serving epochs
with a reprofiled replica, a power cap and a hierarchical fleet.

The invariants, on ``backend="numpy"`` and ``"torch"`` (``device="cpu"``):

* a disabled sink receives zero calls;
* with every ``_obs_active`` hook patched to ``None`` (the package absent)
  and with a recording sink installed, the results are bit-identical;
* the same calls through the reference's numpy ``Scheduler`` (and numpy
  ``FleetScheduler``) under ``repro.obs`` record the same span, counter,
  gauge and event names, in the same order, with equal counts and values
  and equal non-time attributes — except that the torch backend records
  no ``speedstore.bisection_steps`` gauge (its bisection runs on the
  device, like the reference's jax backend), its ``backend`` attributes
  read ``"torch"``, and its fleet counts the restacks of its device carry
  (``fleet.restack`` counters, the ``fleet.restacks`` gauge) and its
  device solves (``fleet.device_dispatches``), which the host backends
  leave at 0.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import repro.core as ref_core
import repro.obs as ref_obs

import repro_torch.core as port_core
import repro_torch.runtime.straggler as port_straggler
from repro_torch import obs
from repro_torch.core import PiecewiseLinearFPM
from repro_torch.obs.report import MetricsSnapshot
from repro_torch.runtime.straggler import StragglerAction, StragglerDetector

ROOT = pathlib.Path(__file__).resolve().parents[1]
BACKENDS = ["numpy", "torch"]


# ---------------------------------------------------------------------------
# Telemetry sink API (the reference's cases)
# ---------------------------------------------------------------------------


def test_telemetry_records_all_kinds():
    tel = obs.Telemetry()
    tel.span_at("work", 1.0, 1.5, n=3)
    tel.counter("hits")
    tel.counter("hits", 2)
    tel.gauge("theta", 0.25)
    tel.gauge("theta", 0.75)  # last value wins
    tel.event("boom", who="r2")
    assert tel.enabled
    assert tel.counters["hits"] == 3
    assert tel.gauges["theta"] == 0.75
    spans = tel.spans()
    assert [s.name for s in spans] == ["work"]
    assert spans[0].t1 - spans[0].t0 == pytest.approx(0.5)
    assert spans[0].attrs == {"n": 3}
    kinds = sorted(e.kind for e in tel.events)
    assert kinds == ["counter", "counter", "event", "gauge", "gauge", "span"]
    payload = tel.to_payload()
    assert payload["counters"]["hits"] == 3
    tel.clear()
    assert not tel.events and not tel.counters and not tel.gauges


def test_telemetry_ring_bound():
    tel = obs.Telemetry(capacity=4)
    for i in range(10):
        tel.event("e", i=i)
    assert len(tel.events) == 4
    assert [e.attrs["i"] for e in tel.events] == [6, 7, 8, 9]
    # counters/gauges aggregate regardless of the ring
    for i in range(10):
        tel.counter("c")
    assert tel.counters["c"] == 10


def test_install_active_use():
    assert obs.active() is obs.NOOP
    assert not obs.NOOP.enabled
    tel = obs.Telemetry()
    obs.install(tel)
    try:
        assert obs.active() is tel
    finally:
        obs.uninstall()
    assert obs.active() is obs.NOOP
    with obs.use(tel) as got:
        assert got is tel and obs.active() is tel
    assert obs.active() is obs.NOOP
    # NOOP swallows every call without recording
    obs.NOOP.span_at("x", 0.0, 1.0)
    obs.NOOP.counter("x")
    obs.NOOP.gauge("x", 1.0)
    obs.NOOP.event("x")


def test_lazy_metrics_snapshot_attribute():
    import repro_torch.obs as pkg
    assert pkg.MetricsSnapshot is MetricsSnapshot
    with pytest.raises(AttributeError):
        pkg.no_such_symbol


def test_flight_recorder_ring_and_snapshot_bounds():
    flight = obs.FlightRecorder(capacity=8, snapshot_capacity=2)
    for i in range(20):
        flight.event("e", i=i)
        flight.snapshot(f"s{i}", {"i": i})
    assert len(flight.events) == 8
    assert len(flight.snapshots) == 2
    assert [s["label"] for s in flight.snapshots] == ["s18", "s19"]


# ---------------------------------------------------------------------------
# straggler events + flight recorder (the reference's cases, port detector)
# ---------------------------------------------------------------------------


def _quarantine_under(sink):
    det = StragglerDetector(factor=1.5, patience=3, patience_hard=6)
    model = PiecewiseLinearFPM.from_points([(1.0, 1000.0), (100.0, 1000.0)])
    with obs.use(sink):
        for _ in range(8):
            act = det.update(2, model, d_units=10, observed_t=0.04)
            if act is StragglerAction.QUARANTINE:
                return act
    return act


def test_straggler_strike_events_carry_evidence():
    tel = obs.Telemetry()
    act = _quarantine_under(tel)
    assert act is StragglerAction.QUARANTINE
    strikes = [e for e in tel.events if e.name == "straggler.strike"]
    verdicts = [e for e in tel.events if e.name == "straggler.verdict"]
    assert strikes and verdicts
    ev = strikes[-1].attrs
    assert ev["group"] == 2
    assert ev["ratio"] == pytest.approx(4.0)
    assert ev["predicted"] == pytest.approx(0.01)
    assert ev["observed"] == pytest.approx(0.04)
    assert verdicts[-1].attrs["action"] == "quarantine"
    assert tel.counters["straggler.quarantine"] == 1


def test_flight_recorder_dump_names_offender(tmp_path):
    flight = obs.FlightRecorder(capacity=64, snapshot_capacity=4)
    flight.snapshot("pre", {"allocations": [10, 10, 10]})
    act = _quarantine_under(flight)
    assert act is StragglerAction.QUARANTINE
    path = tmp_path / "incident.flightrec.json"
    flight.dump(str(path), reason="quarantine",
                context={"replica": 2, "epoch": 5})
    dump = json.loads(path.read_text())
    assert dump["kind"] == "flight-recorder"
    assert dump["reason"] == "quarantine"
    assert dump["context"]["replica"] == 2
    assert dump["snapshots"][0]["label"] == "pre"
    strikes = [e for e in dump["events"] if e["name"] == "straggler.strike"]
    assert strikes and strikes[-1]["attrs"]["group"] == 2
    assert strikes[-1]["attrs"]["observed"] == pytest.approx(0.04)


# ---------------------------------------------------------------------------
# one session through every instrumented layer
# ---------------------------------------------------------------------------

N, EPS, SLOW = 2048, 0.05, 3


def _row_fns(tfns, n):
    return [(lambda tf: lambda r: tf(r * n))(tf) for tf in tfns]


def _session(core, backend):
    """autotune, serving rounds with a slowing processor until it leaves,
    then a grouped partition, grouped observe rounds and a join.  Returns
    every distribution and verdict along the way."""
    kw = {"device": "cpu"} if core is port_core else {}
    _, tfns = core.make_hcl_time_fns(N)
    fns = _row_fns(tfns, N)
    sched = core.Scheduler(backend=backend, **kw)
    res = sched.autotune(core.SimulatedExecutor(time_fns=fns), N, EPS, min_units=1)
    out = [("autotune", res.allocations, res.iterations, res.converged)]
    slow = [1.0] * len(fns)
    for k in range(1, 12):
        slow[SLOW] = 2.0 ** k  # doubles every round
        times = [fn(d) * s if d > 0 else 0.0 for fn, d, s in zip(fns, sched.d, slow)]
        acts = [a.value for a in sched.straggler_actions(times)]
        out.append(("actions", acts))
        gone = [g for g, a in enumerate(acts) if a == "quarantine"]
        if gone:
            sched.leave(gone)
            fns = [fn for g, fn in enumerate(fns) if g not in gone]
            slow = [s for g, s in enumerate(slow) if g not in gone]
            out.append(("leave", gone, list(sched.d)))
            break
        sched.observe(times)
        out.append(("observe", list(sched.d)))
    sched.set_groups([i % 4 for i in range(sched.num_groups)])
    part = sched.partition()
    out.append(("hier", part.allocations, part.t_star))
    for _ in range(3):
        sched.observe([fn(d) if d > 0 else 0.0 for fn, d in zip(fns, sched.d)])
        out.append(("observe", list(sched.d)))
    sched.join(1)
    out.append(("join", list(sched.d), [m.as_points() for m in sched.models]))
    return out


def test_session_quarantines_the_slowed_processor():
    tel = obs.Telemetry()
    with obs.use(tel):
        out = _session(port_core, "numpy")
    verdicts = [e.attrs for e in tel.events if e.name == "straggler.verdict"]
    assert [v["group"] for v in verdicts] == [SLOW] * len(verdicts)
    assert [v["action"] for v in verdicts][-1] == "quarantine"
    assert "reprofile" in [v["action"] for v in verdicts]
    assert [e.attrs["group"] for e in tel.events if e.name == "scheduler.reprofile"]
    assert ("leave", [SLOW]) == out[[s[0] for s in out].index("leave")][:2]


class _CountingDisabledSink:
    """enabled=False stub: any recording call is an instrumentation bug."""

    enabled = False

    def __init__(self):
        self.calls = 0

    def _bump(self, *a, **k):
        self.calls += 1

    span = span_at = counter = gauge = event = _bump
    clock = staticmethod(lambda: 0.0)


@pytest.mark.parametrize("backend", BACKENDS)
def test_disabled_sink_means_zero_obs_calls(backend):
    """Every site checks ``enabled`` before calling any recording method
    (the clock included)."""
    stub = _CountingDisabledSink()
    with obs.use(stub):
        _session(port_core, backend)
    assert stub.calls == 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_absent_obs_package_bit_identical(backend, monkeypatch):
    """Every guarded ``_obs_active`` hook returning None (as the ImportError
    fallback does) leaves every result bit-identical."""
    import repro_torch.core.hierarchy as hierarchy
    import repro_torch.core.scheduler as scheduler
    import repro_torch.core.speedstore as speedstore

    want = _session(port_core, backend)
    for mod in (scheduler, speedstore, hierarchy, port_straggler):
        monkeypatch.setattr(mod, "_obs_active", lambda: None)
    assert _session(port_core, backend) == want


@pytest.mark.parametrize("backend", BACKENDS)
def test_telemetry_is_read_only(backend):
    want = _session(port_core, backend)
    with obs.use(obs.Telemetry()):
        got = _session(port_core, backend)
    assert got == want


def _records(tel, backend):
    """(kind, name, value unless a span's duration, attributes) per event,
    rewritten to what the port's ``backend`` records when ``tel`` is the
    reference's numpy session."""
    out = []
    for e in tel.events:
        attrs = dict(e.attrs)
        if backend == "torch" and tel.__module__.startswith("repro.obs"):
            if e.name == "speedstore.bisection_steps":
                continue
            if attrs.get("backend") == "numpy":
                attrs["backend"] = "torch"
        out.append((e.kind, e.name, None if e.kind == "span" else e.value, attrs))
    return out


@pytest.mark.parametrize("backend", BACKENDS)
def test_names_counts_and_attributes_match_the_reference(backend):
    ref_tel, port_tel = ref_obs.Telemetry(), obs.Telemetry()
    with ref_obs.use(ref_tel):
        want = _session(ref_core, "numpy")
    with obs.use(port_tel):
        got = _session(port_core, backend)
    assert got == want
    assert _records(port_tel, backend) == _records(ref_tel, backend)
    names = {e.name for e in port_tel.events}
    assert {"scheduler.autotune", "scheduler.partition", "scheduler.observe", "scheduler.reprofile",
            "speedstore.partition", "speedstore.fold_in", "speedstore.fold_generation",
            "hier.outer", "hier.inner", "hier.agg_cache.miss",
            "straggler.strike", "straggler.verdict", "straggler.reprofile",
            "straggler.quarantine"} <= names
    assert ("speedstore.bisection_steps" in names) == (backend == "numpy")
    counts = dict(port_tel.counters)
    if backend == "torch":
        assert counts == {k: v for k, v in ref_tel.counters.items()}
        assert port_tel.gauges == {k: v for k, v in ref_tel.gauges.items()
                                   if k != "speedstore.bisection_steps"}
    else:
        assert counts == ref_tel.counters and port_tel.gauges == ref_tel.gauges


def test_chrome_trace_is_valid(tmp_path):
    tel = obs.Telemetry()
    with obs.use(tel):
        _session(port_core, "torch")
        tel.gauge("demo.gauge", 0.5)
    path = tmp_path / "trace.json"
    obs.export_chrome_trace(tel, str(path))
    trace = json.loads(path.read_text())
    evs = trace["traceEvents"]
    assert evs, "empty trace"
    for e in evs:
        assert e["ph"] in ("X", "C", "i", "M")
        assert "name" in e and "pid" in e
    xs = [e for e in evs if e["ph"] == "X"]
    assert xs and all(e["dur"] >= 0 and "ts" in e for e in xs)
    assert {e["name"] for e in xs} >= {
        "scheduler.autotune", "scheduler.partition", "speedstore.partition", "hier.outer", "hier.inner",
    }
    assert sum(e["name"] == "scheduler.autotune" for e in xs) == 1
    assert all(e["args"]["backend"] == "torch" for e in xs if e["name"] == "speedstore.partition")
    # the sidecar block carries the aggregates for the report
    assert trace["repro"]["gauges"]["demo.gauge"] == 0.5
    assert trace["repro"]["counters"]["speedstore.fold_in"] == tel.counters["speedstore.fold_in"]


def test_report_snapshot_roundtrip(tmp_path):
    tel = obs.Telemetry()
    with obs.use(tel):
        _session(port_core, "numpy")
    path = tmp_path / "trace.json"
    obs.export_chrome_trace(tel, str(path))
    snap = MetricsSnapshot.from_file(str(path))
    assert snap.fold_ins == tel.counters["speedstore.fold_in"] > 0
    assert snap.strikes == tel.counters["straggler.strike"] > 0
    assert snap.reprofiles == tel.counters["straggler.reprofile"] > 0
    assert snap.quarantines == tel.counters["straggler.quarantine"] == 1
    assert snap.span_counts["scheduler.autotune"] == 1
    assert snap.span_counts["speedstore.partition"] == len(tel.spans("speedstore.partition"))
    assert snap.rounds is None  # this session runs no fleet
    assert snap.table() and "fold-ins" in snap.table() and "span wall totals" in snap.table()
    # the payload of the sink itself reads the same way
    assert MetricsSnapshot.from_payload(tel.to_payload()).span_counts == snap.span_counts
    # the module CLI parses the same file, in process and as ``python -m``
    from repro_torch.obs import report
    assert report.main([str(path)]) == 0
    cli = subprocess.run(
        [sys.executable, "-W", "error::RuntimeWarning", "-m", "repro_torch.obs.report", str(path)],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, capture_output=True, text=True,
        timeout=120,
    )
    assert cli.returncode == 0, cli.stderr
    assert "fold-ins" in cli.stdout and "speedstore.partition" in cli.stdout


# ---------------------------------------------------------------------------
# one fleet session through every fleet site
# ---------------------------------------------------------------------------


def _fleet_session(pkg, core, backend, tmp_path):
    """The fleet's sites in one session: a registry that is missing on disk,
    a stale warm profile dropped on the first round, measured rounds of
    three tenants (one warm), a rebalance with a drifted load, serving
    epochs with replica 2 slowing until it is reprofiled, a power-capped
    rebalance, and a hierarchical fleet's rounds.  Returns what the fleet
    computed."""
    from repro.core.energy import energy_model as ref_energy_model

    from repro_torch.core.energy import energy_model

    emodel = energy_model if core is port_core else ref_energy_model
    kw = {"backend": backend, "device": "cpu"} if core is port_core else {"backend": "numpy"}
    p, q = 6, 3
    rng = np.random.default_rng(800)
    base = rng.uniform(1e-4, 2e-3, (q, p))
    knee = rng.uniform(5.0, 80.0, (q, p))

    def batch(X):
        return X * base + np.where(X > knee, (X - knee) * base * 4.0, 0.0)

    with pytest.warns(UserWarning, match="not found"):
        reg = pkg.ProfileRegistry.load(str(tmp_path / "profiles.json"))  # never written
    reg.record("X", "w", [(10.0, 1000.0), (500.0, 1000.0)])
    fleet = pkg.FleetScheduler(p, registry=reg, device_classes=["X"] * p, staleness_tol=0.5, **kw)
    names = [f"j{j}" for j in range(q)]
    for j, nm in enumerate(names):
        fleet.admit(pkg.JobSpec(name=nm, n=90 + 20 * j, eps=0.05, min_units=1, max_iter=6,
                                workload="w" if j == 0 else None))
    with pytest.warns(UserWarning, match="stale warm profile"):
        res = fleet.run(core.BatchedSimulatedExecutor2D(time_fn_batch_2d=batch, p=p, q=q, job_names=names))
    out = [("run", {nm: (r.allocations, r.diagnostics["history"]) for nm, r in res.items()})]
    out.append(("rebalance", fleet.rebalance({"j1": 150})))
    slow = 1.0
    for _ in range(5):
        ds = fleet.rebalance()
        slow *= 2.0
        times = {nm: [0.01 * (i + 1) * d[i] * (slow if i == 2 else 1.0) for i in range(p)]
                 for nm, d in ds.items()}
        out.append(("actions", [a.value for a in fleet.straggler_actions(times)]))
        fleet.observe(times)
    out.append(("stats", {k: v for k, v in fleet.stats().items() if k not in ("restacks", "device_dispatches")}))
    capped = pkg.FleetScheduler(4, power_cap=50.0, **kw)
    for j, n in enumerate((200, 300)):
        sm = [core.PiecewiseLinearFPM.from_points([(x, 1.0 + 0.5 * i + 0.1 * j) for x in (1.0, 50.0, 400.0)])
              for i in range(4)]
        em = [emodel([(x, 2.0 * (i + 1) + 0.3 * x) for x in (1.0, 50.0, 400.0)]) for i in range(4)]
        capped.admit(pkg.JobSpec(f"c{j}", n), models=sm, energy_models=em)
    out.append(("capped", capped.rebalance()))
    hier = pkg.FleetScheduler(p, groups=[0, 0, 1, 1, 2, 2], **kw)
    for j, nm in enumerate(names):
        hier.admit(pkg.JobSpec(name=nm, n=80 + 10 * j, eps=0.03, min_units=1, max_iter=4))
    res = hier.run(core.BatchedSimulatedExecutor2D(time_fn_batch_2d=batch, p=p, q=q, job_names=names))
    out.append(("hier", {nm: r.allocations for nm, r in res.items()}))
    return out


def _fleet_records(tel, backend):
    """``_records`` with the torch backend's own fleet counts set aside: it
    restacks its device carry (``fleet.restack`` counters, the
    ``fleet.restacks`` gauge) and counts its device solves
    (``fleet.device_dispatches``), which the host backends leave at 0."""
    out = []
    for kind, name, value, attrs in _records(tel, backend):
        if backend == "torch":
            if name == "fleet.restack":
                continue
            if name in ("fleet.restacks", "fleet.device_dispatches"):
                value = None
        out.append((kind, name, value, attrs))
    return out


@pytest.mark.parametrize("backend", BACKENDS)
def test_fleet_events_match_the_reference(backend, tmp_path):
    """The same fleet session through the reference's numpy fleet under
    ``repro.obs`` and through the port's under ``repro_torch.obs``: equal
    results, and equal event names, order, counts and non-time attributes
    (on the torch backend, beside its restack and device-solve counts)."""
    import repro.fleet as ref_fleet

    import repro_torch.fleet as port_fleet

    ref_tel, port_tel = ref_obs.Telemetry(), obs.Telemetry()
    with ref_obs.use(ref_tel):
        want = _fleet_session(ref_fleet, ref_core, "numpy", tmp_path)
    with obs.use(port_tel):
        got = _fleet_session(port_fleet, port_core, backend, tmp_path)
    assert got == want
    assert _fleet_records(port_tel, backend) == _fleet_records(ref_tel, backend)
    names = {e.name for e in port_tel.events}
    assert {"fleet.partition", "fleet.measure", "fleet.fold", "fleet.round", "fleet.rebalance",
            "fleet.observe", "fleet.power_cap", "fleet.power_cap.theta", "fleet.reprofile_replica",
            "fleet.rounds", "registry.warning", "registry.stale_profile", "straggler.strike",
            "hier.outer", "hier.inner"} <= names
    assert not any(n.startswith("fleet.recompile") for n in names)
    restacks = sum(e.name == "fleet.restack" for e in port_tel.events)
    assert (restacks > 0) == (backend == "torch")
    snap = MetricsSnapshot.from_payload(port_tel.to_payload())
    assert snap.rounds == port_tel.gauges["fleet.rounds"] > 0
    assert snap.recompiles_partition == snap.recompiles_fold == 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_fleet_telemetry_read_only_and_disabled_sink(backend, tmp_path, monkeypatch):
    import repro_torch.fleet as port_fleet
    import repro_torch.fleet.registry as registry
    import repro_torch.fleet.scheduler as scheduler

    want = _fleet_session(port_fleet, port_core, backend, tmp_path)
    stub = _CountingDisabledSink()
    with obs.use(stub):
        assert _fleet_session(port_fleet, port_core, backend, tmp_path) == want
    assert stub.calls == 0
    with obs.use(obs.Telemetry()):
        assert _fleet_session(port_fleet, port_core, backend, tmp_path) == want
    for mod in (scheduler, registry):
        monkeypatch.setattr(mod, "_obs_active", lambda: None)
    assert _fleet_session(port_fleet, port_core, backend, tmp_path) == want


# ---------------------------------------------------------------------------
# serving dispatch: serve.* spans and gauges (ReplicaDispatcher)
# ---------------------------------------------------------------------------


def _dispatch_session(dispatcher_cls, backend):
    """Two ``balance_fleet`` calls (the second on the warm session, a tenant
    admitted) and two served epochs through ``run_jobs``.  Returns what the
    dispatcher computed."""
    base = [4e-4, 2e-4, 8e-4, 3e-4]

    def replica_run(i, x):
        return x * base[i] + (max(x - 30, 0) * base[i] * 3.0)

    kw = {"device": "cpu"} if dispatcher_cls.__module__.startswith("repro_torch") else {}
    disp = dispatcher_cls(replica_run, 4, eps=0.15, clock=lambda: 0.0, **kw)
    out = [{nm: r.allocations for nm, r in disp.balance_fleet({"chat": 48}, backend=backend, min_units=1).items()}]
    out.append({nm: r.allocations
                for nm, r in disp.balance_fleet({"chat": 48, "embed": 96}, backend=backend, min_units=1).items()})
    for _ in range(2):
        ds = disp.fleet.rebalance()
        names = sorted(ds)
        T = disp.run_jobs(names, [ds[nm] for nm in names])
        disp.fleet.observe({nm: list(T[k]) for k, nm in enumerate(names)})
        out.append(ds)
    out.append([log.wall_cost for log in disp.logs])
    return out


def _dispatch_records(tel, backend):
    """``_fleet_records`` with the host-time values of the
    ``serve.split.*`` gauges set aside (their names and order stay)."""
    return [(kind, name, None if name.startswith("serve.split.") else value, attrs)
            for kind, name, value, attrs in _fleet_records(tel, backend)]


@pytest.mark.parametrize("backend", BACKENDS)
def test_dispatch_serve_telemetry_matches_the_reference(backend):
    """The dispatcher's ``serve.replica_busy`` spans (one per busy replica
    a served round, on ``replica:{i}`` tracks) and ``serve.split.*`` gauges
    (one set per ``balance_fleet``), among the fleet's own records: the
    same names, order, counts and non-time attributes as the reference's
    dispatcher under ``repro.obs``; nothing reaches a disabled sink, and a
    recording sink changes no result."""
    from repro.runtime.serve_loop import ReplicaDispatcher as RefDispatcher

    from repro_torch.runtime import ReplicaDispatcher

    ref_tel, port_tel = ref_obs.Telemetry(), obs.Telemetry()
    with ref_obs.use(ref_tel):
        want = _dispatch_session(RefDispatcher, "numpy")
    with obs.use(port_tel):
        got = _dispatch_session(ReplicaDispatcher, backend)
    assert got == want
    assert _dispatch_records(port_tel, backend) == _dispatch_records(ref_tel, backend)
    serve = [(e.kind, e.name) for e in port_tel.events if e.name.startswith("serve.")]
    assert serve.count(("gauge", "serve.split.serve_host_s")) == 2
    assert serve.count(("gauge", "serve.split.sched_host_s")) == 2
    busy = port_tel.spans("serve.replica_busy")
    assert busy and {e.attrs["track"] for e in busy} <= {f"replica:{i}" for i in range(4)}
    stub = _CountingDisabledSink()
    with obs.use(stub):
        assert _dispatch_session(ReplicaDispatcher, backend) == want
    assert stub.calls == 0
