"""The multi-tenant fleet on the card: the reference's fleet gates with the
stacked ``[q, p, k]`` carry in float64 on the CUDA device.

Marked ``cuda``: each test skips where there is no CUDA device.  This file
imports no JAX and nothing of the reference, so it runs on the machine with
the card:

    python -m pytest -q -m cuda tests/test_torch_fleet_cuda.py

The gates are ``chip_smoke.py``'s (its ``fleet`` phase, part (a)), copies of
``benchmarks/fleet_scale.py``'s ``parity_gate``, ``hier_parity_gate`` and
``bucket_gate``: the torch fleet equals eight independent numpy
``Scheduler.autotune`` loops and the numpy fleet bit for bit and launches
the reference's count of device solves; one group equals the flat fleet
and four groups come within 1.05x of its makespan; a bucketed fleet equals
an unbucketed one with the reference's restack count.
"""

import importlib.util
import pathlib

import pytest
import torch

pytestmark = pytest.mark.cuda

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("gate", ["fleet_parity_gate", "fleet_hier_gate", "fleet_bucket_gate"])
def test_fleet_gate_on_the_card(smoke, gate):
    row = getattr(smoke, gate)("cuda")
    assert all(row["checks"].values()), row
