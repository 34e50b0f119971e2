"""The serving dispatch on the card: ``chip_smoke.py``'s ``dispatch`` part (a).

Marked ``cuda``: each test skips where there is no CUDA device.  This file
imports no JAX and nothing of the reference, so it runs on the machine with
the card:

    python -m pytest -q -m cuda tests/test_torch_dispatch_cuda.py

``dispatch_parity_gate("cuda")`` runs ``ReplicaDispatcher`` on host-simulated
replicas with its bank on the card beside the numpy backend on the host, in
float64: ``balance`` on the reference's serving demo, ``balance_fleet`` in
sync and at pipeline depth 0 and 1 (bit-identical; a repeated call keeps
the session, restacks nothing and captures no new CUDA graph), and the
straggler case of ``tests/test_serve_trace.py`` (REPROFILE on the decayed
replica within the detector's patience and on no other, before and after
a resize).
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


def test_dispatch_parity_gate_on_the_card(smoke):
    row = smoke.dispatch_parity_gate("cuda")
    assert all(row["checks"].values()), row
    assert row["depth1"]["graphs"] > 0  # the pipelined partitions replayed as CUDA graphs


def test_dispatcher_defaults_to_the_card(smoke):
    from repro_torch.runtime import ReplicaDispatcher

    disp = ReplicaDispatcher(lambda i, x: x * (i + 1.0), 3)
    res = disp.balance(30, min_units=1)
    assert sum(res.allocations) == 30
    assert disp.scheduler.backend == "torch"
    assert disp.scheduler.store.device_bank(snapshot=False).device.type == "cuda"
    disp.balance_fleet({"a": 30})
    assert disp.fleet.backend == "torch" and disp.fleet._device.type == "cuda"
