"""The readers of the program's own spans (``bench/lib/program_spans.py``):
``None`` on an empty sink and on a program without a profiled sink, the
right number on a synthetic one, and in a traced run of each cell at the
CPU's small sizes a reading of each."""

import time

import pytest
import torch

from bench.lib import harness, loader
from repro_torch import obs

BENCH = loader.benchmark()
READERS = ["observe_ms.serve", "repartitions.serve", "partition_ms.serve", "prefill_host_ms.serve",
           "exec_round_ms.matmul"]


def _synthetic():
    """Three observes (one repartitioned, 2 ms, 4 ms and 6 ms), two
    partitions (10 and 30 ms), two generates (3 and 5 ms), and two executor
    rounds whose largest ``device_s`` are 5 and 7 ms."""
    tel = obs.Telemetry(clock=lambda: 0.0)
    for k, (ms, changed) in enumerate([(2, False), (4, True), (6, False)]):
        if changed:
            tel.counter("scheduler.repartition")
        tel.span_at("scheduler.observe", k, k + ms / 1e3, repartitioned=changed)
    for ms in (10, 30):
        tel.span_at("speedstore.partition", 0.0, ms / 1e3, n=96, backend="torch")
    for ms in (3, 5):
        tel.span_at("engine.generate", 0.0, ms / 1e3, batch=24, prompt_tokens=512, new_tokens=1)
    for rnd, device_s in ((0, [0.004, 0.005, 0.001]), (1, [0.007, 0.002, 0.006])):
        for i, s in enumerate(device_s):
            tel.span_at("executor.proc", 0.0, s + 1e-5, proc=i, units=10, round=rnd, device_s=s)
    return tel


WANT = {"observe_ms.serve": 4.0, "repartitions.serve": 100.0 / 3, "partition_ms.serve": 20.0,
        "prefill_host_ms.serve": 4.0, "exec_round_ms.matmul": 6.0}


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_none_on_an_empty_sink(name, monkeypatch):
    monkeypatch.setattr(obs, "profiled", lambda: obs.Telemetry())
    assert loader.metric_reader(name).read({}) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_none_for_a_program_without_the_profiled_sink(name, monkeypatch):
    monkeypatch.delattr(obs, "profiled")
    assert loader.metric_reader(name).read({}) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_a_synthetic_sink(name, monkeypatch):
    tel = _synthetic()
    monkeypatch.setattr(obs, "profiled", lambda: tel)
    assert loader.metric_reader(name).read({}) == pytest.approx(WANT[name], rel=1e-9)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_a_traced_small_run_reports_the_programs_spans(cell, small):
    """Each new metric of the cell is read from the traced window's spans,
    and an untraced run records none.  On the CPU the dispatch cell's cold
    balance may fill the window, so ``observe``'s two metrics are held to
    appear together, and the others always."""
    obs.profiled().clear()
    cfg = loader.workload(BENCH, cell)["config"]
    r, _ = harness.run_cell(BENCH, cell, 2**31 + 17, 1.0, True, torch.device("cpu"), time.perf_counter(), small[cfg])
    obs.profiled().clear()
    assert r["correct"], r["checks"]
    mine = {m["name"] for m in loader.metrics_of(BENCH, cell, "per_layer") if m["name"] in READERS}
    observe = {"observe_ms.serve", "repartitions.serve"}
    got = set(r["metrics"])
    assert mine - observe and mine - observe <= got, r["metrics"]
    assert not mine & observe or observe <= got or not observe & got, r["metrics"]
    harness.run_cell(BENCH, cell, 2**31 + 17, 0.5, False, torch.device("cpu"), time.perf_counter(), small[cfg])
    assert not obs.profiled().events
