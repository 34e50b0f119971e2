"""The fleet examples' twins held against the reference's scripts.

``examples_torch/{fleet_serve, fleet_pipeline_walkthrough,
obs_walkthrough, serve_trace_walkthrough}.py`` run with ``--device cpu``
beside ``examples/`` under ``JAX_PLATFORMS=cpu``: their standard outputs
must be equal line by line but for the parts masked here, each with its
reason:

* temporary paths (``fleet_serve``'s registry, ``obs``'s trace and
  flight-recorder dump);
* wall-clock figures (``fleet_pipeline``'s Part 2 ms per epoch and their
  ratio, ``obs``'s span wall totals);
* ``obs``'s dispatch counters: the reference's fleet runs on the host's
  numpy bank, which counts no device program and no restack, the twin's on
  the torch bank, which does (``fleet.restack`` is one more event and a
  counter; ``fleet.stats()`` and the report count 8 dispatches and 1
  restack).  The twin's session must count exactly what the reference's
  session counts on its own device bank, the jax fleet in float64, but
for its ``fleet.recompile.*`` counters: jit-cache growth has no meaning
on the torch fleet, which emits no such counter (``fleet/scheduler.py``).

``fleet_serve``'s ``device programs`` line is not masked: the torch fleet
counts what the reference's jax fleet counts.
"""

import jax
import numpy as np

from _example_parity import assert_same_lines, load_twin, run_pair

TEMP_PATH = "temporary path"
WALL = "wall clock"
DISPATCH = "dispatch counters: numpy bank on the reference's side, torch bank on the twin's"


def test_fleet_serve_twin_prints_the_reference_lines():
    ref, twin = run_pair("fleet_serve")
    assert_same_lines(ref, twin, [(r"profiles -> (\S+)$", TEMP_PATH)])


def test_fleet_serve_twin_warm_starts():
    got = load_twin("fleet_serve").main(device="cpu")
    assert all(got["claims"].values()) and got["profiles"] == 3


def test_fleet_pipeline_twin_prints_the_reference_lines():
    ref, twin = run_pair("fleet_pipeline_walkthrough")
    assert_same_lines(ref, twin, [
        (r"^      sync:(\s+[\d.]+) ms/epoch", WALL),
        (r"^ pipelined:(\s+[\d.]+) ms/epoch  \(([\d.]+)x", WALL),
    ])
    assert any("stale reads consumed: 10, misses (fell back to the fresh carry): 4, "
               "pre-dispatched partitions: 16" in line for line in twin)


def test_obs_twin_prints_the_reference_lines():
    ref, twin = run_pair("obs_walkthrough")
    assert_same_lines(ref, twin, [
        (r"^recorded (\d+) events$", DISPATCH),
        (r"^counters: (.*)$", DISPATCH),
        (r"^public stats \(same numbers, no telemetry needed\): (.*)$", DISPATCH),
        (r"^  device dispatches\s+(\d+)$", DISPATCH),
        (r"^  dispatches / round\s+(\S+)$", DISPATCH),
        (r"^  restacks\s+(\d+)$", DISPATCH),
        (r"^-> (\S+)/fleet_trace\.json", TEMP_PATH),
        (r"^-> (\S+)/quarantine\.flightrec\.json$", TEMP_PATH),
        (r"^    fleet\.rebalance(\s+[\d.]+) ms  x4$", WALL),
        (r"^    fleet\.observe(\s+[\d.]+) ms  x4$", WALL),
    ])


def test_obs_twin_counts_what_the_reference_device_fleet_counts():
    from repro import obs as ref_obs
    from repro.core import PiecewiseLinearFPM
    from repro.fleet import FleetScheduler, JobSpec

    got = load_twin("obs_walkthrough").main(device="cpu")
    p, q = 8, 3
    base = np.random.default_rng(0).uniform(1e-4, 4e-4, (q, p))
    with jax.enable_x64(True), ref_obs.use(ref_obs.Telemetry()) as tel:
        fleet = FleetScheduler(p, backend="jax")
        for j in range(q):
            warm = [PiecewiseLinearFPM.from_points([(1.0, 1.0 / base[j, i]), (1e6, 1.0 / base[j, i])])
                    for i in range(p)]
            fleet.admit(JobSpec(name=f"tenant{j}", n=800 + j, eps=0.05), models=warm)
        for _ in range(4):
            ds = fleet.rebalance()
            fleet.observe({f"tenant{j}": [x * base[j, i] if x > 0 else 0.0 for i, x in enumerate(ds[f"tenant{j}"])]
                           for j in range(q)})
    assert got["stats"] == fleet.stats() and fleet.stats()["device_dispatches"] == 8
    jit = lambda name: name.startswith("fleet.recompile.")  # noqa: E731
    assert got["events"] == sum(not jit(e.name) for e in tel.events)
    assert got["spans"] == sorted({e.name for e in tel.spans()})
    assert got["counters"] == {k: v for k, v in tel.counters.items() if not jit(k)}
    assert all(got["claims"].values()) and got["quarantined"] == 2


def test_serve_trace_twin_prints_the_reference_lines():
    ref, twin = run_pair("serve_trace_walkthrough")
    assert_same_lines(ref, twin)
    assert "epoch 20 (t= 40.0s) replica 2: QUARANTINE wall 1.168s" in twin
