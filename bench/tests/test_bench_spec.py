"""BENCHMARK.json against the contract it is written to, and every name in it
found as a file."""

import json
import re

import pytest

from bench.lib import loader

BENCH = loader.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
# keys that name a width, which `reduced` may never name
WIDTHS = re.compile(r"^(hidden_size|intermediate_size|.*_dim|.*_rank|head_.*|.*latent.*|.*state_size|.*projection.*"
                    r"|.*expansion.*|num_experts_per_tok)$")


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert (loader.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert BENCH["paths"] == ["bench"] and BENCH["command"] == ["python3", "bench/run.py"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_names_units_and_texts():
    entries = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for kind in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[kind]]
        assert len(set(names)) == len(names)
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for e in BENCH["workloads"] + BENCH["configs"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"] and "\t" not in e["why"]
    for c in BENCH["configs"]:
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) and not WIDTHS.search(k) for k in c["reduced"])


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_found_by_name(cell):
    w = loader.workload(BENCH, cell)
    cfg = loader.config(BENCH, w["config"])
    assert (loader.BENCH / "systems" / f"{cfg['system']}.py").is_file()
    assert loader.traffic(w["traffic"])
    assert (w["config"], w["traffic"]) not in [(x["config"], x["traffic"]) for x in BENCH["workloads"] if x is not w]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(loader.metric_reader(metric).read)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_reports_set_up_an_end_to_end_and_a_per_layer_metric(cell):
    e2e = [m["name"] for m in loader.metrics_of(BENCH, cell, "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert loader.metrics_of(BENCH, cell, "per_layer")


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_each_per_layer_metric_moves_what_its_cells_report(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    moved = next(x for x in BENCH["end_to_end"] if x["name"] == m["moves"])
    for cell in m["workloads"]:
        assert "workloads" not in moved or cell in moved["workloads"], (metric, cell)


def test_configs_files_and_layers():
    for c in BENCH["configs"]:
        assert c["file"].startswith("bench/configs/")
        data = json.loads((loader.ROOT / c["file"]).read_text())
        assert data["source"] == c["source"] and "assumed" in data and "limits" in data
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"], []).append(m["name"])
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    assert {"serving dispatch", "kernels", "device", "model"} <= set(layers)
    perf = (loader.ROOT / "PERF.md").read_text()
    for layer in layers:
        assert layer in perf, layer


def test_roofline_and_mfu_names():
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
        if "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_run_seconds_fit_the_check_with_24_cells():
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
