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
an unbucketed one with the reference's restack count.  Part (d)'s
``pipeline_parity_gate`` runs the parity case with ``pipeline=True`` at
depth 0 and 1 (bit-identical to sync, the reference's counts, every
pre-dispatched partition queued under sync debug mode ``"error"``), and
the deferred partition is held against the sync one on the card.
"""

import importlib.util
import pathlib

import numpy as np
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


@pytest.mark.parametrize(
    "gate", ["fleet_parity_gate", "fleet_hier_gate", "fleet_bucket_gate", "fleet_pipeline_gate"]
)
def test_fleet_gate_on_the_card(smoke, gate):
    row = getattr(smoke, gate)("cuda")
    assert all(row["checks"].values()), row


@pytest.mark.parametrize("completion", ["auto", "threshold", "greedy"])
def test_deferred_partition_reads_nothing_on_the_card(smoke, completion):
    """The deferred partition on a stacked float64 bank on the card: queued
    under sync debug mode ``"error"`` (a device-to-host read inside it
    raises), then fetched — allocations and ``t*`` equal the sync call's,
    also after a fold leaves the lanes' monotonicity unknown on the host."""
    from repro_torch.core import TorchModelBank, fetch_partition

    _, warm = smoke.fleet_make_tenants(6, 200, seed=5)
    stacked = TorchModelBank.stack([TorchModelBank.from_models(m, device="cuda") for m in warm])
    ns = np.array([100 * 200 + 7 * j for j in range(6)])
    ns[5] = 0
    mu = np.array([1, 0, 3, 1, 0, 0])
    caps = np.full((6, 200), 10**6, dtype=np.int64)
    caps[1] = ns[1] // 200 + 2
    rng = np.random.default_rng(5)
    folded = stacked.fold_in(rng.uniform(16.0, 1e5, (6, 200)), rng.uniform(1e5, 1e6, (6, 200)), donate=False)
    for bank in (stacked, folded):
        kw = dict(caps=caps, min_units=mu, completion=completion, with_t=True)
        want = bank.partition_units(ns, **kw)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            deferred = bank.partition_units(ns, defer=True, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        got = fetch_partition(deferred)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_graph_replay_equals_the_eager_deferred_program(smoke, monkeypatch):
    """The deferred program replayed as a CUDA graph (from a shape's second
    call) equals the eager deferred program and the sync program, call
    after call on changing inputs, and queues no read (sync debug mode
    ``"error"``, which does raise on a read here)."""
    from repro_torch.core import TorchModelBank, fetch_partition
    from repro_torch.core import modelbank_torch as mbt

    assert smoke.sync_debug_catches_a_read()
    _, warm = smoke.fleet_make_tenants(4, 300, seed=6)
    bank = TorchModelBank.stack([TorchModelBank.from_models(m, device="cuda") for m in warm])
    rng = np.random.default_rng(6)
    monkeypatch.setattr(mbt, "_graphs", type(mbt._graphs)())
    for call in range(4):
        ns = np.array([50 * 300 + int(v) for v in rng.integers(0, 5000, 4)])
        kw = dict(min_units=1, completion="auto", with_t=True)
        want = bank.partition_units(ns, **kw)
        monkeypatch.setattr(mbt, "GRAPH_DEFERRED", False)
        eager = fetch_partition(bank.partition_units(ns, defer=True, **kw))
        monkeypatch.setattr(mbt, "GRAPH_DEFERRED", True)
        torch.cuda.set_sync_debug_mode("error")
        try:
            deferred = bank.partition_units(ns, defer=True, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        got = fetch_partition(deferred)
        for a, b in ((got, want), (eager, want)):
            assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]), call
        # the observations move the carry (new values, same shape)
        x = np.asarray(got[0], dtype=np.float64)
        bank = bank.fold_in(np.maximum(x, 1.0), np.maximum(x, 1.0) * rng.uniform(1e5, 2e5, x.shape), donate=False)
    assert any(g.graph is not None for g in mbt._graphs.values())  # some calls replayed
