"""The port's serving dispatch held against the reference's.

``repro_torch.runtime.ReplicaDispatcher`` (``balance`` through the
``Scheduler`` facade, ``balance_fleet`` through ``FleetScheduler``, the
``run``/``run_jobs`` logs), the deprecated ``BalanceController`` /
``elastic_rebalance`` shims and ``core.executor.TraceExecutor2D`` run the
cases of ``tests/test_runtime.py``, ``tests/test_system.py``,
``tests/test_obs.py``, ``tests/test_serve_trace.py`` and
``tests/test_fleet_pipeline.py`` beside the reference's classes on the same
inputs.  The port runs on ``device="cpu"``, its ``"torch"`` backend in
float64 and its ``"numpy"`` one; the oracle is the reference's numpy
backend, and the tolerance is zero: allocations, iterations, histories,
models and logs are equal bit for bit.  The reference's jax fleet, scoped
with ``jax.enable_x64(True)``, fixes the restack counts the torch fleet
must reach.  ``chip_smoke.py``'s ``dispatch_parity_gate`` (the ``dispatch``
phase's part (a)) runs here on the host as well.
"""

import importlib.util
import pathlib
import warnings

import jax
import numpy as np
import pytest

from repro.core.executor import FleetRoundLog as RefFleetRoundLog
from repro.core.executor import TraceExecutor2D as RefTrace
from repro.fleet import FleetScheduler as RefFleet
from repro.fleet import JobSpec as RefJobSpec
from repro.fleet import ProfileRegistry as RefRegistry
from repro.runtime.balance import BalanceController as RefController
from repro.runtime.elastic import elastic_rebalance as ref_elastic
from repro.runtime.serve_loop import ReplicaDispatcher as RefDispatcher
from repro.runtime.straggler import StragglerAction as RefAction

from repro_torch.core import Policy, Scheduler
from repro_torch.core import modelbank_torch as mbt
from repro_torch.core.executor import FleetRoundLog, RoundLog, TraceExecutor2D
from repro_torch.fleet import FleetScheduler, JobSpec, ProfileRegistry
from repro_torch.runtime import (
    BalanceController,
    GroupTimer,
    ReplicaDispatcher,
    StragglerAction,
    StragglerDetector,
    elastic_rebalance,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
BACKENDS = ["numpy", "torch"]


@pytest.fixture(autouse=True)
def _quiet_shims():
    """The shims warn on every legacy call (``test_shims_warn`` checks it)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        yield


def _points(models):
    return [m.as_points() for m in models]


def _same_controller(port, ref):
    assert port.d == ref.d
    assert _points(port.models) == _points(ref.models)
    assert (port.rebalances, port.steps_observed) == (ref.rebalances, ref.steps_observed)
    assert port._ema == ref._ema


def _controllers(backend, **kw):
    return (
        BalanceController(backend=backend, device="cpu", **kw),
        RefController(**kw),
    )


def _simulate(ctrl, speeds, steps=30):
    """Feed the controller synthetic per-group times t = d / speed."""
    changes = 0
    for _ in range(steps):
        times = [d / s if d > 0 else 0.0 for d, s in zip(ctrl.d, speeds)]
        changes += bool(ctrl.observe(times))
    return changes


# ---------------------------------------------------------------------------
# BalanceController / elastic_rebalance (tests/test_runtime.py's cases)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
def test_balance_controller_converges_to_speed_ratio(backend):
    speeds = [1.0, 2.0, 3.0, 2.0]
    pair = _controllers(backend, n_units=64, num_groups=4, eps=0.08, smooth=1.0)
    for ctrl in pair:
        _simulate(ctrl, speeds)
        want = [64 * s / sum(speeds) for s in speeds]
        for d, w in zip(ctrl.d, want):
            assert abs(d - w) <= 2, (ctrl.d, want)
        times = [d / s for d, s in zip(ctrl.d, speeds)]
        assert (max(times) - min(times)) / min(times) <= 0.15
    _same_controller(*pair)


@pytest.mark.parametrize("backend", BACKENDS)
def test_balance_controller_no_rebalance_when_even(backend):
    pair = _controllers(backend, n_units=32, num_groups=4, eps=0.1)
    for ctrl in pair:
        assert not ctrl.observe([1.0, 1.0, 1.0, 1.0])
        assert ctrl.rebalances == 0
    _same_controller(*pair)


@pytest.mark.parametrize("backend", BACKENDS)
def test_balance_controller_state_roundtrip(backend):
    port, ref = _controllers(backend, n_units=32, num_groups=2, eps=0.1, smooth=1.0)
    for ctrl in (port, ref):
        ctrl.observe([2.0, 1.0])
    back = BalanceController.from_state(port.state_dict(), eps=0.1, device="cpu")
    ref_back = RefController.from_state(ref.state_dict(), eps=0.1)
    assert back.backend == backend
    assert back.d == port.d
    assert _points(back.models) == _points(port.models)
    _same_controller(back, ref_back)
    # a reference checkpoint resumes in the port, and the next step agrees
    resumed = BalanceController.from_state(ref.state_dict(), eps=0.1, device="cpu")
    _same_controller(resumed, ref_back)
    for ctrl in (back, ref_back, resumed):
        ctrl.observe([d / s for d, s in zip(ctrl.d, (1.0, 3.0))])
    _same_controller(back, ref_back)
    _same_controller(resumed, ref_back)


@pytest.mark.parametrize("backend", BACKENDS)
def test_balance_adapts_to_speed_change(backend):
    """A group slowing down mid-run gets units taken away."""
    pair = _controllers(backend, n_units=60, num_groups=3, eps=0.05, smooth=1.0)
    for ctrl in pair:
        _simulate(ctrl, [2.0, 2.0, 2.0], steps=5)
        d_before = list(ctrl.d)
        _simulate(ctrl, [2.0, 2.0, 0.5], steps=30)
        assert ctrl.d[2] < d_before[2]
    _same_controller(*pair)


@pytest.mark.parametrize("backend", BACKENDS)
def test_straggler_reprofile_clears_model(backend):
    pair = _controllers(backend, n_units=40, num_groups=2, eps=0.05, smooth=1.0)
    for ctrl in pair:
        ctrl.observe([2.0, 1.0])
        ctrl.observe([d / 2.0 for d in ctrl.d])
    port, ref = pair
    pts_before = port.models[0].num_points
    StragglerDetector().reprofile(port, 0)
    from repro.runtime.straggler import StragglerDetector as RefDetector

    RefDetector().reprofile(ref, 0)
    assert port.models[0].num_points <= pts_before
    _same_controller(port, ref)
    if backend == "torch":
        assert port._device_bank is None  # the carry is rebuilt lazily


@pytest.mark.parametrize("backend", BACKENDS)
def test_elastic_leave_redistributes_all_units(backend):
    pair = _controllers(backend, n_units=60, num_groups=3, eps=0.05, smooth=1.0)
    new = []
    for ctrl, elastic in zip(pair, (elastic_rebalance, ref_elastic)):
        _simulate(ctrl, [1.0, 2.0, 3.0], steps=20)
        out = elastic(ctrl, surviving=[0, 1])
        assert out.num_groups == 2
        assert sum(out.d) == 60
        assert out.models[0].num_points == ctrl.models[0].num_points  # warm start
        new.append(out)
    assert isinstance(new[0], BalanceController) and new[0].backend == backend
    _same_controller(*new)


@pytest.mark.parametrize("backend", BACKENDS)
def test_elastic_join_gets_optimistic_estimate(backend):
    pair = _controllers(backend, n_units=60, num_groups=2, eps=0.05, smooth=1.0)
    new = []
    for ctrl, elastic in zip(pair, (elastic_rebalance, ref_elastic)):
        _simulate(ctrl, [1.0, 3.0], steps=20)
        out = elastic(ctrl, surviving=[0, 1], joined=1)
        assert out.num_groups == 3
        assert sum(out.d) == 60
        assert out.models[2].num_points == 1  # donor point
        assert out.d[2] > 0  # newcomer not starved
        new.append(out)
    _same_controller(*new)


@pytest.mark.parametrize("backend", BACKENDS)
def test_elastic_then_converges_quickly(backend):
    pair = _controllers(backend, n_units=60, num_groups=3, eps=0.08, smooth=1.0)
    new, changes = [], []
    for ctrl, elastic in zip(pair, (elastic_rebalance, ref_elastic)):
        _simulate(ctrl, [1.0, 2.0, 3.0], steps=20)
        out = elastic(ctrl, surviving=[0, 2])
        changes.append(_simulate(out, [1.0, 3.0], steps=6))
        times = [d / s for d, s in zip(out.d, [1.0, 3.0])]
        assert (max(times) - min(times)) / min(times) <= 0.25
        new.append(out)
    assert changes[0] == changes[1]
    _same_controller(*new)


def test_shims_warn_and_expose_the_torch_carry():
    """The legacy entry points warn once per call, pointing at the facade;
    on the torch backend ``device_bank()`` is the ``TorchModelBank``
    snapshot and ``_device_bank`` the store's carry."""
    ctrl = BalanceController(n_units=32, num_groups=2, eps=0.1, smooth=1.0, backend="torch", device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        for call in (lambda: ctrl.observe([2.0, 1.0]), ctrl.bank, ctrl.device_bank,
                     lambda: elastic_rebalance(ctrl, [0, 1])):
            with pytest.raises(DeprecationWarning, match="deprecated; use"):
                call()
    snap = ctrl.device_bank()
    assert isinstance(snap, mbt.TorchModelBank) and snap.device.type == "cpu"
    assert ctrl._device_bank is ctrl._sched.store._tbank
    assert snap is not ctrl._device_bank  # a snapshot, not the carry
    assert _points(snap.to_bank().to_models()) == _points(ctrl.models)
    timer = GroupTimer()
    timer.start()
    assert timer.stop() >= 0.0


def test_torch_shim_defaults_to_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs a machine without one")
    with pytest.raises(RuntimeError, match="cuda"):
        BalanceController(n_units=8, num_groups=2, backend="torch")
    assert BalanceController(n_units=8, num_groups=2).backend == "numpy"  # the host default
    with pytest.raises(RuntimeError, match="cuda"):
        ReplicaDispatcher(lambda i, x: float(x), 2).balance(8)


# ---------------------------------------------------------------------------
# run / run_jobs accounting, t_wall (tests/test_runtime.py, tests/test_obs.py)
# ---------------------------------------------------------------------------


def _log_fields(log):
    return {k: v for k, v in log.__dict__.items() if k != "t_wall"}


def test_run_jobs_logs_one_time_sliced_round():
    speeds = [2.0, 4.0]
    logs = []
    for cls in (ReplicaDispatcher, RefDispatcher):
        disp = cls(replica_run=lambda i, x: float(x) / speeds[i], num_replicas=2)
        T = disp.run_jobs(["a", "b"], [[4, 12], [6, 0]])
        assert [[float(v) for v in row] for row in T] == [[2.0, 3.0], [3.0, 0.0]]
        assert len(disp.logs) == 1
        log = disp.logs[0]
        assert isinstance(log, (FleetRoundLog, RefFleetRoundLog))
        assert log.names == ["a", "b"]
        assert log.D == [[4, 12], [6, 0]]
        assert log.times == [[2.0, 3.0], [3.0, 0.0]]
        assert log.proc_busy == [5.0, 3.0]
        assert log.wall_cost == 5.0
        logs.append(log)
    assert isinstance(logs[0], FleetRoundLog)
    assert _log_fields(logs[0]) == _log_fields(logs[1])


def test_serving_log_t_wall_monotonic_from_injected_clock():
    base = [4e-4, 2e-4, 8e-4, 3e-4]

    def replica_run(i, x):
        return x * base[i] if x > 0 else 0.0

    out = []
    for cls, kw in ((ReplicaDispatcher, {"device": "cpu"}), (RefDispatcher, {})):
        ticks = iter(np.arange(100.0, 200.0, 0.5))
        disp = cls(replica_run, 4, eps=0.15, clock=lambda: float(next(ticks)), **kw)
        disp.balance(96)
        assert disp.logs, "balance() appended no rounds"
        stamps = [log.t_wall for log in disp.logs]
        assert all(b > a for a, b in zip(stamps, stamps[1:]))
        assert stamps[0] >= 100.0  # came from the injected clock
        a = disp.logs[0]
        b = type(a)(**{**a.__dict__, "t_wall": -1.0})
        assert a == b  # t_wall is excluded from equality
        out.append(disp.logs)
    port, ref = out
    assert all(isinstance(log, RoundLog) for log in port)
    assert [_log_fields(a) for a in port] == [_log_fields(b) for b in ref]
    assert [a.t_wall for a in port] == [b.t_wall for b in ref]


# ---------------------------------------------------------------------------
# balance (tests/test_system.py) and the CLI demo
# ---------------------------------------------------------------------------


def _dispatcher(replica_run, p, eps, backend):
    """A port dispatcher on the CPU whose ``balance`` runs the ``backend``
    store: ``"torch"`` is the one it builds itself."""
    disp = ReplicaDispatcher(replica_run, p, eps=eps, device="cpu")
    if backend == "numpy":
        disp.scheduler = Scheduler(policy=Policy.DFPA, eps=eps, backend="numpy", device="cpu")
    return disp


def _same_partition(got, want):
    assert got.allocations == want.allocations
    assert got.iterations == want.iterations
    assert got.converged == want.converged
    assert got.imbalance == want.imbalance
    assert got.diagnostics["history"] == want.diagnostics["history"]


@pytest.mark.parametrize("backend", BACKENDS)
def test_serving_dispatch_balances(backend):
    rng = np.random.default_rng(1)
    base = rng.uniform(1e-4, 5e-4, 4)

    def replica_run(i, x):
        t = x * base[i]
        if x > 24:
            t += (x - 24) * base[i] * 5.0  # spill knee
        return t

    disp = _dispatcher(replica_run, 4, 0.1, backend)
    res = disp.balance(64)
    assert disp.scheduler.backend == backend
    assert sum(res.d) == 64
    assert res.imbalance <= 0.1 or not res.converged
    times = [replica_run(i, d) for i, d in enumerate(res.d)]
    even = max(replica_run(i, 16) for i in range(4))
    assert max(times) <= even  # never worse than the even split
    ref = RefDispatcher(replica_run, 4, eps=0.1)
    _same_partition(res, ref.balance(64))
    assert [_log_fields(a) for a in disp.logs] == [_log_fields(b) for b in ref.logs]


def _reference_demo_run(p, chunks):
    """src/repro/launch/serve.py's demo replicas, as written there."""
    rng = np.random.default_rng(0)
    base = rng.uniform(2e-4, 8e-4, p)
    caps = rng.integers(chunks // 2, chunks, p)

    def replica_run(i, x):
        t = x * base[i]
        if x > caps[i]:
            t += (x - caps[i]) * base[i] * 4.0
        return t

    return replica_run


@pytest.mark.parametrize("p, chunks", [(4, 64), (8, 96), (3, 48)])
def test_demo_replica_run_is_the_reference_demo(p, chunks):
    from repro_torch.launch.serve import demo_replica_run

    got, want = demo_replica_run(p, chunks), _reference_demo_run(p, chunks)
    assert [got(i, x) for i in range(p) for x in range(2 * chunks + 1)] == [
        want(i, x) for i in range(p) for x in range(2 * chunks + 1)
    ]


def test_cli_replicas_prints_the_reference_dispatch_line(capsys):
    from repro_torch.launch import serve

    serve.main(["--smoke", "--device", "cpu", "--replicas", "4", "--chunks", "64"])
    got = capsys.readouterr().out.strip().splitlines()[-1]

    res = RefDispatcher(_reference_demo_run(4, 64), 4, eps=0.1).balance(64)
    want = (
        f"DFPA dispatch over 4 replicas: d={res.allocations} "
        f"iters={res.iterations} imb={res.imbalance:.3f} converged={res.converged}"
    )
    assert got == want


# ---------------------------------------------------------------------------
# balance_fleet (tests/test_serve_trace.py, tests/test_fleet_pipeline.py)
# ---------------------------------------------------------------------------


def _serve_epoch(disp, tenants, speeds):
    """One steady serving epoch: rebalance -> simulate -> scan -> fold."""
    fleet = disp.fleet
    ds = fleet.rebalance(dict(tenants))
    times = {
        name: [d / s if d > 0 else 0.0 for d, s in zip(dvec, speeds)]
        for name, dvec in ds.items()
    }
    acts = fleet.straggler_actions(times)  # scan BEFORE fold
    fleet.observe(times)
    return ds, [a.value for a in acts]


def _decay_until(disp, tenants, base_speeds, lane, action, max_epochs=10):
    """Throttle ``lane`` x0.5 per epoch until ``action`` fires; returns
    (epochs taken, other lanes any action fired on, the epochs' records)."""
    others, seen = set(), []
    for k in range(max_epochs):
        speeds = list(base_speeds)
        speeds[lane] = base_speeds[lane] * 0.5 ** (k + 1)
        ds, acts = _serve_epoch(disp, tenants, speeds)
        seen.append((ds, acts))
        others |= {i for i, a in enumerate(acts) if a != "none" and i != lane}
        if acts[lane] == action.value:
            return k + 1, others, seen
    return None, others, seen


def _straggler_session(cls, kw):
    tenants = {"t": 400}
    speeds = [8.0, 8.0, 4.0, 4.0]
    fkw = dict(reserve_knots=16, quantize=0.05, min_units=1, max_iter=12, **kw)
    disp = cls(replica_run=lambda i, x: 0.0, num_replicas=4, eps=0.08,
               **({"device": "cpu"} if cls is ReplicaDispatcher else {}))
    disp.replica_run = lambda i, x: x / speeds[i]
    action = StragglerAction if cls is ReplicaDispatcher else RefAction
    record = [{k: r.allocations for k, r in disp.balance_fleet(tenants, **fkw).items()}]
    for _ in range(3):
        ds, acts = _serve_epoch(disp, tenants, speeds)
        assert acts == ["none"] * 4
        record.append((ds, acts))
    n, others, seen = _decay_until(disp, tenants, speeds, 2, action.REPROFILE)
    assert n is not None and n <= disp.fleet.detector.patience
    assert others == set()
    record += seen
    old = disp.fleet
    survivors = [0, 1, 3]
    speeds3 = [speeds[i] for i in survivors]
    disp.num_replicas = 3
    disp.replica_run = lambda i, x: x / speeds3[i]
    record.append({k: r.allocations for k, r in disp.balance_fleet(tenants, **fkw).items()})
    assert disp.fleet is not old
    disp.fleet.detector = old.detector.remap(survivors)
    n, others, seen = _decay_until(disp, tenants, speeds3, 2, action.REPROFILE)
    assert n is not None and n <= disp.fleet.detector.patience
    assert others == set()
    return record + seen


@pytest.mark.parametrize("backend", BACKENDS)
def test_straggler_reaction_right_replica_before_and_after_resize(backend):
    got = _straggler_session(ReplicaDispatcher, {"backend": backend})
    want = _straggler_session(RefDispatcher, {"backend": "numpy"})
    assert got == want


def _warm_kw():
    return dict(
        device_classes=["c0", "c1", "c2"],
        workloads={"a": "wa", "b": "wb"},
        reserve_knots=16,
        quantize=0.05,
        min_units=1,
        max_iter=10,
    )


def _warm_session(cls, backend, registry_cls, **extra):
    speeds = [4.0, 2.0, 1.0]
    tenants = {"a": 300, "b": 120}
    kw = {**_warm_kw(), "backend": backend, **extra}
    dkw = {"device": "cpu"} if cls is ReplicaDispatcher else {}
    disp = cls(replica_run=lambda i, x: x / speeds[i], num_replicas=3, eps=0.08, **dkw)
    first = disp.balance_fleet(tenants, registry=registry_cls(), **kw)
    fleet0, restacks0 = disp.fleet, disp.fleet.restacks
    warm = disp.balance_fleet(tenants, registry=registry_cls(), **kw)
    assert disp.fleet is fleet0
    reg = registry_cls()
    disp.fleet.save_profiles(reg)
    disp2 = cls(replica_run=lambda i, x: x / speeds[i], num_replicas=3, eps=0.08, **dkw)
    fresh = disp2.balance_fleet(tenants, registry=reg, **kw)
    assert disp2.fleet is not fleet0
    for name in tenants:
        assert warm[name].allocations == fresh[name].allocations
    out = {name: (first[name].allocations, warm[name].allocations, warm[name].iterations,
                  warm[name].diagnostics["history"]) for name in tenants}
    return out, restacks0, disp.fleet.restacks


@pytest.mark.parametrize("backend", BACKENDS)
def test_balance_fleet_warm_reuse_parity_and_no_restack(backend):
    """A repeated ``balance_fleet`` keeps the session, restacks nothing and
    equals a fresh session warm-started from the registry; both equal the
    reference's numpy fleet bit for bit, and the torch fleet restacks as
    often as the reference's jax fleet."""
    keys0 = set(mbt._graphs)
    got, r0, r1 = _warm_session(ReplicaDispatcher, backend, ProfileRegistry)
    want, _, _ = _warm_session(RefDispatcher, "numpy", RefRegistry)
    assert got == want
    assert r1 == r0
    assert set(mbt._graphs) == keys0  # the host runs no CUDA graph
    if backend == "torch":
        with jax.enable_x64(True):
            _, j0, j1 = _warm_session(RefDispatcher, "jax", RefRegistry)
        assert (r0, r1) == (j0, j1)


@pytest.mark.parametrize("backend", BACKENDS)
def test_balance_fleet_admit_retire_rides_warm_session(backend):
    speeds = [4.0, 2.0, 1.0]
    out = []
    for cls, b, kw in ((ReplicaDispatcher, backend, {"device": "cpu"}), (RefDispatcher, "numpy", {})):
        fkw = dict(backend=b, reserve_knots=16, min_units=1, max_iter=10)
        disp = cls(replica_run=lambda i, x: x / speeds[i], num_replicas=3, eps=0.08, **kw)
        rec = [disp.balance_fleet({"a": 300}, **fkw)]
        fleet0 = disp.fleet
        res = disp.balance_fleet({"a": 300, "b": 120}, **fkw)
        assert disp.fleet is fleet0
        assert set(res) == {"a", "b"} and set(fleet0.jobs) == {"a", "b"}
        rec.append(res)
        rec.append(disp.balance_fleet({"b": 120}, **fkw))
        assert disp.fleet is fleet0 and set(fleet0.jobs) == {"b"}
        disp.num_replicas = 2
        disp.replica_run = lambda i, x: x / speeds[i]
        rec.append(disp.balance_fleet({"b": 120}, **fkw))
        assert disp.fleet is not fleet0
        out.append([{k: (r.allocations, r.iterations, r.diagnostics["history"]) for k, r in res.items()}
                    for res in rec])
    assert out[0] == out[1]


def _pipeline_case():
    base = [4e-4, 2e-4, 8e-4, 3e-4]

    def replica_run(i, x):
        t = x * base[i]
        if x > 30:
            t += (x - 30) * base[i] * 3.0
        return t

    return replica_run, {"chat": 48, "embed": 96}


def _summary(res):
    return {nm: (r.allocations, r.iterations, r.diagnostics["history"]) for nm, r in res.items()}


@pytest.mark.parametrize("backend", BACKENDS)
def test_balance_fleet_pipeline_threading_and_warm_toggle(backend):
    replica_run, tenants = _pipeline_case()
    sync = ReplicaDispatcher(replica_run, 4, eps=0.15, device="cpu")
    res_s = sync.balance_fleet(tenants, backend=backend, min_units=1)
    disp = ReplicaDispatcher(replica_run, 4, eps=0.15, device="cpu")
    res_p = disp.balance_fleet(tenants, backend=backend, min_units=1, pipeline=True, pipeline_depth=0)
    assert disp.fleet.pipeline and disp.fleet.pipeline_depth == 0
    assert _summary(res_p) == _summary(res_s)
    res_off = disp.balance_fleet(tenants, backend=backend, min_units=1)
    assert disp.fleet.pipeline is False
    assert disp.fleet._predispatched is None
    assert disp.fleet._stacked_stale is None
    for nm in tenants:
        assert sum(res_off[nm].allocations) == tenants[nm]
    res_d1 = disp.balance_fleet(tenants, backend=backend, min_units=1, pipeline=True, pipeline_depth=1)
    for nm in tenants:
        assert sum(res_d1[nm].allocations) == tenants[nm]

    # the same calls through the reference's numpy fleet, bit for bit
    ref_s = RefDispatcher(replica_run, 4, eps=0.15).balance_fleet(tenants, backend="numpy", min_units=1)
    ref = RefDispatcher(replica_run, 4, eps=0.15)
    want = [ref.balance_fleet(tenants, backend="numpy", min_units=1, pipeline=True, pipeline_depth=0),
            ref.balance_fleet(tenants, backend="numpy", min_units=1),
            ref.balance_fleet(tenants, backend="numpy", min_units=1, pipeline=True, pipeline_depth=1)]
    assert _summary(res_s) == _summary(ref_s)
    assert [_summary(r) for r in (res_p, res_off, res_d1)] == [_summary(r) for r in want]
    assert disp.fleet.stale_reads == ref.fleet.stale_reads
    assert disp.fleet.speculative_misses == ref.fleet.speculative_misses


def test_balance_fleet_rejects_a_bad_toggle():
    replica_run, tenants = _pipeline_case()
    disp = ReplicaDispatcher(replica_run, 4, eps=0.15, device="cpu")
    disp.balance_fleet(tenants, backend="scalar", min_units=1)
    with pytest.raises(ValueError, match=r'\("numpy" or "torch"\)'):
        disp.balance_fleet(tenants, backend="scalar", min_units=1, pipeline=True)
    disp = ReplicaDispatcher(replica_run, 4, eps=0.15, device="cpu")
    disp.balance_fleet(tenants, backend="numpy", min_units=1)
    with pytest.raises(ValueError, match="pipeline_depth must be 0 or 1"):
        disp.balance_fleet(tenants, backend="numpy", min_units=1, pipeline=True, pipeline_depth=2)


# ---------------------------------------------------------------------------
# TraceExecutor2D
# ---------------------------------------------------------------------------


def _trace_fn(X, t):
    """Speeds that drift with the trace clock, processor 2 throttled after
    t = 3."""
    speeds = np.array([4.0, 2.0, 3.0, 1.5]) * (1.0 + 0.1 * np.sin(t))
    if t > 3.0:
        speeds = speeds * np.array([1.0, 1.0, 0.4, 1.0])
    return X / speeds + 0.002 * X**1.2


@pytest.mark.parametrize("backend", ["scalar"] + BACKENDS)
def test_trace_executor_2d_matches_the_reference(backend):
    """The same trace function, clock and seed give the same
    ``FleetRoundLog`` s (and, driving a fleet, the same partitions)."""
    runs = []
    for ex_cls, fleet_cls, spec_cls, kw in (
        (TraceExecutor2D, FleetScheduler, JobSpec, {"backend": backend, "device": "cpu"}),
        (RefTrace, RefFleet, RefJobSpec, {"backend": "scalar" if backend == "scalar" else "numpy"}),
    ):
        ex = ex_cls(_trace_fn, p=4, noise=0.03, rng=np.random.default_rng(7), alpha=1e-3, beta=1e-4)
        fleet = fleet_cls(4, **kw)
        for nm, n in (("a", 200), ("b", 90)):
            fleet.admit(spec_cls(name=nm, n=n, eps=0.05, min_units=1, max_iter=8))
        res = fleet.run(ex)
        epochs = []
        for e in range(5):
            ex.now = float(e) + 0.5
            ds = fleet.rebalance()
            names = sorted(ds)
            T = ex.run_jobs(names, [ds[nm] for nm in names])
            fleet.observe({nm: list(T[k]) for k, nm in enumerate(names)})
            epochs.append(ds)
        single = ex.run([10, 20, 0, 5])
        assert ex.round_cost(single) == max(single) + 1e-3 + 4e-4
        runs.append((_summary(res), epochs, single, [_log_fields(log) for log in ex.logs], ex.total_cost))
        assert all(isinstance(log, (FleetRoundLog, RefFleetRoundLog)) for log in ex.logs)
        assert all(log.wall_cost == max(log.proc_busy) + 1e-3 + 4e-4 for log in ex.logs)
    assert runs[0] == runs[1]


# ---------------------------------------------------------------------------
# chip_smoke.py's dispatch part (a), on the host
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_dispatch_parity_gate_on_the_host(smoke):
    row = smoke.dispatch_parity_gate("cpu")
    assert all(row["checks"].values()), row


def test_chip_smoke_tenant_dispatcher_routes_each_tenant(smoke):
    """Part (c)'s dispatcher serves each tenant's cells with that tenant's
    replicas and logs one time-sliced round, as ``run_jobs`` does."""
    calls = []

    def runner(name, scale):
        def run(i, x):
            calls.append((name, i, x))
            return scale * x / (i + 1)
        return run

    disp = smoke.TenantDispatcher(
        {"chat": runner("chat", 1.0), "summarize": runner("summarize", 4.0)}, 3, device="cpu"
    )
    T = disp.run_jobs(["chat", "summarize"], [[3, 0, 6], [1, 2, 0]])
    assert calls == [("chat", 0, 3), ("chat", 2, 6), ("summarize", 0, 1), ("summarize", 1, 2)]
    np.testing.assert_array_equal(T, [[3.0, 0.0, 2.0], [4.0, 4.0, 0.0]])
    assert disp.logs[-1].wall_cost == 7.0
