"""Each cell at the CPU tests' small sizes on the card: the kernels' routes
there, the CUDA-event clocks and the trace's reading; and each cell at its
own size with the control (the plain reference in fp8) in the program's
place, which the run's own check has to fail.  Marked ``cuda``; it skips
without a card (run on the card with ``-m cuda``)."""

import time

import pytest

from bench.lib import harness, loader
from bench.tests import controls

BENCH = loader.benchmark()


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_small_cell_on_the_card(cell, trace, small, cuda_device):
    cfg = loader.workload(BENCH, cell)["config"]
    r, _ = harness.run_cell(BENCH, cell, 2**31 + 5, 1.0, bool(trace), cuda_device, time.perf_counter(), small[cfg])
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["metrics"]
    if trace:
        assert r["device"]["busy_s"] > 0 and r["breakdown"]["device_ops"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_control_fails_the_check_at_the_cells_size(cell, cuda_device):
    out = controls.readings(cell, 2**31 + 23, 5.0, cuda_device, control=True)
    assert out["program_correct"] and not out["control_correct"], out
