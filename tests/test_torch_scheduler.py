"""The port's Scheduler held against the reference's, round for round.

``repro_torch``'s ``Scheduler(backend="torch", device="cpu")`` (device bank
in float64 on the host) and its host backends run the same loops, on the
same simulator and the same seeded numpy noise, as the reference's numpy
Scheduler.  Contract: allocations, iteration counts and every round's
distribution are equal; times to ``rel=1e-12`` where they come from the
golden file, exactly where both sides compute them.
"""

import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.core import Scheduler as RefScheduler
from repro.core import SimulatedExecutor as RefSimulatedExecutor
from repro.core import make_hcl_time_fns as ref_make_hcl_time_fns
from repro.core.fpm import PiecewiseLinearFPM as RefFPM

from repro_torch.core import (
    CallableExecutor,
    PiecewiseLinearFPM,
    Policy,
    Scheduler,
    SimulatedExecutor,
    make_hcl_time_fns,
)

GOLDEN = json.loads((pathlib.Path(__file__).parent / "golden" / "dfpa_hcl.json").read_text())


def _row_fns(tfns, n):
    return [(lambda tf: lambda r: tf(r * n))(tf) for tf in tfns]


def _port(backend):
    return Scheduler(backend=backend, device="cpu")


# ---------------------------------------------------------------------------
# autotune: the paper's loop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_autotune_reproduces_golden_trace(backend):
    n = GOLDEN["n"]
    _, tfns = make_hcl_time_fns(n)
    res = _port(backend).autotune(
        SimulatedExecutor(time_fns=_row_fns(tfns, n)), n, GOLDEN["eps"],
        min_units=GOLDEN["min_units"],
    )
    assert res.backend == backend
    assert res.iterations == GOLDEN["iterations"]
    assert res.converged == GOLDEN["converged"]
    assert res.allocations == GOLDEN["final_d"]
    assert [m.num_points for m in res.diagnostics["models"]] == GOLDEN["points_per_proc"]
    history = res.diagnostics["history"]
    assert len(history) == len(GOLDEN["rounds"])
    for (d, times), want in zip(history, GOLDEN["rounds"]):
        assert d == want["d"]
        assert times == pytest.approx(want["times"], rel=1e-12)
    assert res.imbalance == pytest.approx(GOLDEN["imbalance"], rel=1e-12)


@pytest.mark.parametrize(
    "n,eps,min_units,noise,seed",
    [(5120, 0.025, 1, 0.0, 0), (4096, 0.10, 1, 0.02, 7), (3000, 0.05, 0, 0.0, 0)],
)
def test_autotune_matches_reference_numpy_backend(n, eps, min_units, noise, seed):
    def run(sched, make_fns, make_ex):
        _, tfns = make_fns(n)
        ex = make_ex(
            time_fns=_row_fns(tfns, n), noise=noise,
            rng=np.random.default_rng(seed) if noise else None,
        )
        return sched.autotune(ex, n, eps, min_units=min_units, max_iter=40)

    want = run(RefScheduler(backend="numpy"), ref_make_hcl_time_fns, RefSimulatedExecutor)
    for backend in ("torch", "numpy", "scalar"):
        got = run(_port(backend), make_hcl_time_fns, SimulatedExecutor)
        assert got.allocations == want.allocations
        assert got.iterations == want.iterations and got.converged == want.converged
        assert got.diagnostics["history"] == want.diagnostics["history"]
        assert got.diagnostics["probes_used"] == want.diagnostics["probes_used"]
        assert got.imbalance == want.imbalance


def test_partition_matches_reference():
    rng = np.random.default_rng(3)
    rows = []
    for _ in range(6):
        k = int(rng.integers(2, 7))
        rows.append(list(zip(np.sort(rng.uniform(1.0, 1e4, k)).tolist(), rng.uniform(0.5, 500.0, k).tolist())))
    n, caps, mu = 1234, [400, 500, 300, 600, 200, 400], 2
    want = RefScheduler.from_models([RefFPM.from_points(r) for r in rows], backend="numpy").partition(n, caps, mu)
    got = Scheduler.from_models(
        [PiecewiseLinearFPM.from_points(r) for r in rows], device="cpu"
    ).partition(n, caps, mu)
    assert got.backend == "torch"
    assert got.allocations == want.allocations
    assert got.t_star == want.t_star and got.times == want.times
    assert got.imbalance == want.imbalance


# ---------------------------------------------------------------------------
# observe and state: a checkpoint of either package continues in the port
# ---------------------------------------------------------------------------


SPEEDS = [4.0, 3.0, 1.5, 2.0]


def _drive_rounds(sched, rounds):
    ds = []
    for _ in range(rounds):
        sched.observe([d / s if d > 0 else 0.0 for d, s in zip(sched.d, SPEEDS)])
        ds.append(list(sched.d))
    return ds


def _session(cls, backend, **kw):
    return cls(
        n_units=64, num_groups=4, eps=0.03, min_units=1, smooth=0.7,
        caps=[40, 40, 40, 40], backend=backend, **kw,
    )


def test_observe_matches_reference():
    ref = _session(RefScheduler, "numpy")
    port = _session(Scheduler, "torch", device="cpu")
    assert _drive_rounds(port, 12) == _drive_rounds(ref, 12)
    assert port.rebalances == ref.rebalances and port._ema == ref._ema


@pytest.mark.parametrize("ref_backend", ["numpy", "jax"])
def test_reference_state_continues_bit_identically(ref_backend):
    with jax.enable_x64(True):
        ref = _session(RefScheduler, ref_backend)
        _drive_rounds(ref, 4)
        state = json.loads(json.dumps(ref.state_dict()))  # as written to disk
        want = _drive_rounds(ref, 3)
    port = Scheduler.from_state(state, device="cpu")
    assert port.backend == ("torch" if ref_backend == "jax" else "numpy")
    assert port.d == state["d"] and port.caps == state["caps"]
    assert _drive_rounds(port, 3) == want
    on_bank = Scheduler.from_state(state, device="cpu", backend="torch")
    assert _drive_rounds(on_bank, 3) == want


def test_port_state_roundtrip_bit_identical():
    sched = _session(Scheduler, "torch", device="cpu")
    _drive_rounds(sched, 4)
    restored = Scheduler.from_state(sched.state_dict(), device="cpu")
    assert restored.backend == "torch" and restored._ema == sched._ema
    assert _drive_rounds(restored, 3) == _drive_rounds(sched, 3)


# ---------------------------------------------------------------------------
# The device is explicit; later slices are refused, not faked
# ---------------------------------------------------------------------------


def test_torch_backend_default_device_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs a machine without one")
    with pytest.raises(RuntimeError, match="cuda"):
        Scheduler(backend="torch")
    with pytest.raises(RuntimeError, match="cuda"):
        Scheduler(num_groups=4)
    with pytest.raises(RuntimeError, match="cuda"):
        CallableExecutor([lambda d: None])


def test_later_slices_raise_not_implemented():
    # the grid slice is ported: Scheduler(grid=...) constructs and partitions
    grid = [[lambda mb, nb: 1.0 + mb] * 2] * 2
    sched = Scheduler(grid=grid, policy=Policy.GRID2D, device="cpu")
    assert sched.grid is grid and sched.policy is Policy.GRID2D
    part = sched.partition_grid(8, 8, eps=0.5)
    assert sum(part.col_widths) == 8 and all(sum(r) == 8 for r in part.row_heights)
    # so is the two-level path: groups= constructs and round-trips
    assert Scheduler(groups=[0, 0, 1], device="cpu").groups == [0, 0, 1]
    state = _session(Scheduler, "numpy").state_dict()
    state["groups"] = [0, 0, 1, 1]
    assert Scheduler.from_state(state, device="cpu").groups == [0, 0, 1, 1]
    # the reference's multi-device sharding has no counterpart on one card
    state["sharding"] = "shard_map"
    with pytest.raises(NotImplementedError, match="single card"):
        Scheduler.from_state(state, device="cpu")


def test_callable_executor_warms_up_once_and_times_each_processor():
    calls = []
    ex = CallableExecutor([lambda d, i=i: calls.append((i, d)) for i in range(3)], device="cpu")
    times = ex.run([2, 0, 1])
    assert calls == [(0, 2), (2, 1), (0, 2), (2, 1)]  # warm-ups, then the timed round
    assert times[1] == 0.0 and times[0] > 0.0 and times[2] > 0.0
    calls.clear()
    ex.run([1, 1, 1])
    assert calls == [(1, 1), (0, 1), (1, 1), (2, 1)]  # only processor 1 was cold
    assert len(ex.logs) == 2 and ex.logs[0].wall_cost == max(times)


def test_autotune_drives_matmul_update_panels():
    """The paper's application on the host: processor i repeats a
    matmul_update on its row panel r_i times, timed by CallableExecutor.
    Host timings at this size are noise, so only the loop's bookkeeping is
    asserted here; the card's run of the same loop asserts convergence."""
    from repro_torch.kernels import matmul_update

    repeats, n, unit = [1, 2, 3], 48, 4
    g = torch.Generator().manual_seed(0)
    a = torch.randn(n * unit, 64, generator=g)
    b = torch.randn(64, 64, generator=g)
    c = torch.zeros(n * unit, 64)

    def panel(i):
        def fn(d):
            for _ in range(repeats[i]):
                matmul_update(c[: d * unit], a[: d * unit], b, bm=unit, bn=64, bk=64)
        return fn

    ex = CallableExecutor([panel(i) for i in range(3)], device="cpu")
    res = _port("torch").autotune(ex, n, eps=0.5, min_units=1, max_iter=10)
    assert sum(res.allocations) == n and min(res.allocations) >= 1
    assert len(ex.logs) == res.iterations == len(res.diagnostics["history"])
    assert ex.warmed == {0, 1, 2}


def test_speedstore_protocol_matches_numpy_store():
    from repro.core import SpeedStore as RefSpeedStore

    from repro_torch.core import SpeedStore

    rng = np.random.default_rng(12)
    rows = [list(zip(np.sort(rng.uniform(1, 1e3, 4)).tolist(), rng.uniform(1, 50, 4).tolist())) for _ in range(5)]
    ref = RefSpeedStore.from_models([RefFPM.from_points(r) for r in rows], backend="numpy")
    dev = SpeedStore.from_models([PiecewiseLinearFPM.from_points(r) for r in rows], backend="torch", device="cpu")
    x = rng.uniform(0, 2e3, 5)
    assert dev.speeds(x).tolist() == ref.speeds(x).tolist()
    assert dev.times(x).tolist() == ref.times(x).tolist()
    assert dev.alloc_at_time(3.0, [500] * 5).tolist() == ref.alloc_at_time(3.0, [500] * 5).tolist()
    assert dev.partition_continuous(800.0) == ref.partition_continuous(800.0)
    assert dev.partition(800, min_units=2) == ref.partition(800, min_units=2)
    for store in (dev, ref):
        store.fold_in([100.0] * 5, [7.0] * 5, [True, False, True, False, True])
    assert dev.num_points == ref.num_points and dev.fold_generation == 1
    assert dev.device_bank().to_bank().counts.tolist() == ref.bank().counts.tolist()
    assert dev.imbalance_estimate([160] * 5) == ref.imbalance_estimate([160] * 5)
    dev.reset_row(0, [(100.0, 7.0)])
    ref.reset_row(0, [(100.0, 7.0)])
    assert dev.partition_units(800) == ref.partition_units(800)
    back = SpeedStore.from_state(dev.state_dict(), device="cpu")
    assert back.backend == "torch" and back.partition_units(800) == dev.partition_units(800)


def test_batched_simulator_and_app_time_match_reference():
    from repro.core import BatchedSimulatedExecutor as RefBatched
    from repro.core import make_hcl_time_fn_batch as ref_batch_fns
    from repro.core import matmul_app_time_1d as ref_app_time

    from repro_torch.core import BatchedSimulatedExecutor, make_hcl_time_fn_batch, matmul_app_time_1d

    n = 4096
    specs, tfb = make_hcl_time_fn_batch(n)
    _, ref_tfb = ref_batch_fns(n)
    x = np.arange(len(specs), dtype=np.float64) * 300.0
    assert tfb(x).tolist() == ref_tfb(x).tolist()
    got = _port("torch").autotune(BatchedSimulatedExecutor(tfb, len(specs)), n, 0.05, min_units=1)
    want = RefScheduler(backend="numpy").autotune(RefBatched(ref_tfb, len(specs)), n, 0.05, min_units=1)
    assert got.diagnostics["history"] == want.diagnostics["history"]
    _, tfns = make_hcl_time_fns(n)
    _, ref_tfns = ref_make_hcl_time_fns(n)
    assert matmul_app_time_1d(tfns, got.allocations, n) == ref_app_time(ref_tfns, got.allocations, n)


def test_analytic_models_sample_and_bank_like_reference():
    from repro.core import AnalyticModel as RefAnalytic
    from repro.core import SpeedStore as RefSpeedStore

    from repro_torch.core import AnalyticModel, SpeedStore

    fns = [lambda x, k=k: x / (k + 1.0) + 0.001 * x * x for k in range(4)]
    ref = RefSpeedStore.from_models(
        [RefAnalytic(f) for f in fns], backend="numpy", analytic_tol=0.01, analytic_hi=2000.0
    )
    dev = SpeedStore.from_models(
        [AnalyticModel(f) for f in fns], backend="torch", analytic_tol=0.01, analytic_hi=2000.0,
        device="cpu",
    )
    assert dev.backend == "torch" and dev.state_dict()["points"] == ref.state_dict()["points"]
    assert dev.partition(1500, min_units=1) == ref.partition(1500, min_units=1)
    scalar = SpeedStore.from_models([AnalyticModel(f) for f in fns], backend="torch", device="cpu")
    assert scalar.backend == "scalar"  # no piecewise form: the exact scalar path
