"""The port's multi-tenant fleet held against the reference's, bit for bit.

``repro_torch.fleet.FleetScheduler`` on its ``"numpy"`` and ``"torch"``
backends (the torch carry on the CPU in float64; ``"scalar"`` where the
reference tests it) against the reference's ``repro.fleet.FleetScheduler``
on its numpy backend and against q independent port ``Scheduler.autotune``
loops.  The cases are ``tests/test_fleet.py``'s sync cases, from the same
seeds; that file does not collect on this toolchain (its module imports
``jax.experimental.enable_x64``).  The reference's jax fleet runs here too,
scoped with ``jax.enable_x64(True)``: it fixes the counts the torch backend
must reach (``device_dispatches``, ``restacks``), including the constants
``chip_smoke.py``'s ``fleet`` phase holds on the card.

Contract (tolerance zero): allocations, times, histories, iterations,
convergence verdicts, imbalances, bench costs and folded estimates equal;
``device_dispatches`` as the reference counts it (0 on the host backends).
"""

import importlib.util
import json
import pathlib

import jax
import numpy as np
import pytest

from _hyp import given, settings, st

import repro.fleet as ref_fleet
from repro.core import BatchedSimulatedExecutor2D as RefExecutor2D
from repro.core import PiecewiseLinearFPM as RefFPM
from repro.core.energy import energy_model as ref_energy_model

from repro_torch.core import (
    BatchedSimulatedExecutor2D,
    PiecewiseLinearFPM,
    Policy,
    Scheduler,
    SimulatedExecutor,
    SpeedStore,
    TorchModelBank,
)
from repro_torch.core.energy import energy_model
from repro_torch.core.partition import _partition_units_bank
from repro_torch.core.scheduler import _even
from repro_torch.fleet import FleetScheduler, JobSpec, ProfileRegistry

ROOT = pathlib.Path(__file__).resolve().parents[1]
BACKENDS = ["numpy", "torch"]


def _port_fleet(p, backend, **kw):
    return FleetScheduler(p, backend=backend, device="cpu", **kw)


def _ref_fleet(p, **kw):
    return ref_fleet.FleetScheduler(p, backend="numpy", **kw)


def _port_sched(p, backend):
    return Scheduler(SpeedStore.empty(p, backend=backend, device="cpu"), backend=backend, device="cpu")


# ---------------------------------------------------------------------------
# Ground-truth fleets (tests/test_fleet.py's): per-(job, proc) time functions
# ---------------------------------------------------------------------------


def _knee_params(rng, q, p):
    base = rng.uniform(1e-4, 2e-3, (q, p))
    knee = rng.uniform(5.0, 80.0, (q, p))
    return base, knee


def _knee_time(base, knee, x):
    t = x * base
    return t + np.where(x > knee, (x - knee) * base * 4.0, 0.0)


def _scalar_fns(base, knee, j):
    return [
        (lambda b, k: lambda x: float(_knee_time(b, k, float(x))))(base[j, i], knee[j, i])
        for i in range(base.shape[1])
    ]


def _batch_fn(base, knee):
    def fn(X):
        return _knee_time(base, knee, X)

    return fn


def _dip_fns(p, K=30.0):
    """Adversarial job: time DROPS 10x past K, so its bank turns
    non-monotone and its lane must demote to the exact completion."""
    a = np.asarray([1e-3 * (2.0**i) for i in range(p)])
    scalar = [
        (lambda ai: lambda x: float(ai * x if x < K else 0.1 * ai * x))(a[i])
        for i in range(p)
    ]

    def batch_row(x_row):
        return np.where(x_row < K, a * x_row, 0.1 * a * x_row)

    return scalar, batch_row


def _random_fleet_case(rng):
    p = int(rng.integers(2, 7))
    q = int(rng.integers(1, 5))
    base, knee = _knee_params(rng, q, p)
    jobs = []
    for j in range(q):
        n = int(rng.integers(max(2 * p, 8), 60 * p))
        min_units = int(rng.integers(0, 2))
        caps = None
        if rng.random() < 0.4:
            lo = max(1, min_units)
            caps = [lo + int(f * n) for f in rng.uniform(0.6, 1.0, p)]
        jobs.append(dict(n=n, eps=float(rng.uniform(0.02, 0.25)), caps=caps,
                         min_units=min_units, max_iter=int(rng.integers(3, 12))))
    return dict(p=p, q=q, base=base, knee=knee, jobs=jobs)


# ---------------------------------------------------------------------------
# The parity checker
# ---------------------------------------------------------------------------


def _round_costs(ex) -> float:
    """The executor's round costs added one by one in round order, as a
    fleet job accumulates them (``ex.total_cost`` uses ``sum()``, whose
    compensated float summation rounds differently since Python 3.12)."""
    cost = 0.0
    for log in ex.logs:
        cost += log.wall_cost
    return cost


def _independent_results(case, backend):
    """q separate port Scheduler.autotune sessions."""
    p, base, knee = case["p"], case["base"], case["knee"]
    out = []
    for j, kw in enumerate(case["jobs"]):
        ex = SimulatedExecutor(time_fns=_scalar_fns(base, knee, j))
        sched = _port_sched(p, backend)
        res = sched.autotune(ex, kw["n"], kw["eps"], max_iter=kw["max_iter"], caps=kw["caps"],
                             min_units=kw["min_units"])
        out.append(dict(res=res, cost=_round_costs(ex), points=[m.as_points() for m in sched.store.models]))
    return out


def _run_fleet(fleet, spec_cls, ex_cls, case):
    p, q = case["p"], case["q"]
    for j, kw in enumerate(case["jobs"]):
        fleet.admit(spec_cls(name=str(j), **kw))
    ex = ex_cls(time_fn_batch_2d=_batch_fn(case["base"], case["knee"]), p=p, q=q,
                job_names=[str(j) for j in range(q)])
    return fleet.run(ex)


def _summary(fleet, results, q):
    out = []
    for j in range(q):
        r = results[str(j)]
        out.append((r.allocations, r.times, r.iterations, r.converged, r.imbalance,
                    r.diagnostics["history"], r.diagnostics["probes_used"], fleet.bench_cost(str(j)),
                    [m.as_points() for m in fleet.models(str(j))]))
    return out


def _check_fleet_parity(case, backend):
    q = case["q"]
    fleet = _port_fleet(case["p"], backend)
    results = _run_fleet(fleet, JobSpec, BatchedSimulatedExecutor2D, case)
    ref = _ref_fleet(case["p"])
    ref_results = _run_fleet(ref, ref_fleet.JobSpec, RefExecutor2D, case)
    assert _summary(fleet, results, q) == _summary(ref, ref_results, q)
    for j, want in enumerate(_independent_results(case, backend)):
        got, res = results[str(j)], want["res"]
        assert (got.allocations, got.times, got.iterations, got.converged, got.imbalance) == (
            res.allocations, res.times, res.iterations, res.converged, res.imbalance)
        assert got.diagnostics["history"] == res.diagnostics["history"]
        assert fleet.bench_cost(str(j)) == want["cost"]
        assert [m.as_points() for m in fleet.models(str(j))] == want["points"]
    assert fleet.rounds == ref.rounds
    if backend == "torch":
        # one stacked partition + one fold per round, whatever q is
        assert fleet.device_dispatches <= 2 * fleet.rounds
        assert all(r.backend == "torch" for r in results.values())
    else:
        assert fleet.device_dispatches == ref.device_dispatches == 0
    return fleet


def _ref_jax_stats(case):
    """The reference's jax fleet on ``case`` in float64: its counters."""
    with jax.enable_x64(True):
        ref = ref_fleet.FleetScheduler(case["p"], backend="jax")
        _run_fleet(ref, ref_fleet.JobSpec, RefExecutor2D, case)
        return ref.stats()


# ---------------------------------------------------------------------------
# Deterministic parity + the dispatch count
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
def test_fleet_parity_three_jobs(backend):
    case = _random_fleet_case(np.random.default_rng(100))
    fleet = _check_fleet_parity(case, backend)
    if backend == "torch":
        assert fleet.stats() == _ref_jax_stats(case)


@pytest.mark.parametrize("backend", BACKENDS)
def test_fleet_parity_five_cases(backend):
    rng = np.random.default_rng(101)
    for _ in range(5):
        _check_fleet_parity(_random_fleet_case(rng), backend)


def test_fleet_parity_scalar_backend():
    rng = np.random.default_rng(105)
    for _ in range(3):
        case = _random_fleet_case(rng)
        fleet = _port_fleet(case["p"], "scalar")
        results = _run_fleet(fleet, JobSpec, BatchedSimulatedExecutor2D, case)
        ref = ref_fleet.FleetScheduler(case["p"], backend="scalar")
        ref_results = _run_fleet(ref, ref_fleet.JobSpec, RefExecutor2D, case)
        assert _summary(fleet, results, case["q"]) == _summary(ref, ref_results, case["q"])


def test_partition_grid_scalar_backend_still_works():
    from repro_torch.core import HCL_SPECS, speed_fn_2d

    specs = HCL_SPECS[:4]
    grid = [[speed_fn_2d(specs[i * 2 + j]) for j in range(2)] for i in range(2)]
    part = Scheduler(grid=grid, policy=Policy.GRID2D, backend="scalar").partition_grid(64, 64, eps=0.2)
    assert sum(part.col_widths) == 64
    assert all(sum(rows) == 64 for rows in part.row_heights)


@pytest.mark.parametrize("backend", BACKENDS)
def test_fleet_parity_smoke_fuzz(backend):
    """Tier-1 smoke: 6 random fleets through the full parity checker."""
    rng = np.random.default_rng(102)
    for _ in range(6):
        _check_fleet_parity(_random_fleet_case(rng), backend)


@pytest.mark.slow
@pytest.mark.parametrize("backend,seed", [("numpy", 103), ("torch", 104)])
def test_fleet_parity_fuzz_lane(backend, seed):
    rng = np.random.default_rng(seed)
    for _ in range(200):
        _check_fleet_parity(_random_fleet_case(rng), backend)


@st.composite
def _fleet_cases(draw):
    p = draw(st.integers(min_value=2, max_value=5))
    q = draw(st.integers(min_value=1, max_value=3))
    floats = dict(allow_nan=False, allow_infinity=False)
    base = np.asarray(draw(st.lists(st.lists(st.floats(min_value=1e-4, max_value=2e-3, **floats),
                                             min_size=p, max_size=p), min_size=q, max_size=q)))
    knee = np.asarray(draw(st.lists(st.lists(st.floats(min_value=5.0, max_value=80.0, **floats),
                                             min_size=p, max_size=p), min_size=q, max_size=q)))
    jobs = [
        dict(n=draw(st.integers(min_value=max(2 * p, 8), max_value=60 * p)),
             eps=draw(st.floats(min_value=0.02, max_value=0.25)), caps=None,
             min_units=draw(st.integers(min_value=0, max_value=1)),
             max_iter=draw(st.integers(min_value=3, max_value=10)))
        for _ in range(q)
    ]
    return dict(p=p, q=q, base=base, knee=knee, jobs=jobs)


@pytest.mark.slow
@given(case=_fleet_cases())
@settings(max_examples=200, deadline=None)
def test_fleet_parity_fuzz_hypothesis(case):
    _check_fleet_parity(case, "torch")


# ---------------------------------------------------------------------------
# Mid-flight admit / retire, resize, rebalance
# ---------------------------------------------------------------------------


def _assert_independent(want, got, fleet, name):
    res = want["res"]
    assert got.allocations == res.allocations and got.times == res.times
    assert got.diagnostics["history"] == res.diagnostics["history"]
    assert fleet.bench_cost(name) == want["cost"]
    assert [m.as_points() for m in fleet.models(name)] == want["points"]


@pytest.mark.parametrize("backend", BACKENDS)
def test_admit_mid_flight_matches_independent(backend):
    rng = np.random.default_rng(200)
    p, q = 4, 3
    base, knee = _knee_params(rng, q, p)
    jobs = [dict(n=40 + 30 * j, eps=0.05, caps=None, min_units=1, max_iter=8) for j in range(q)]
    case = dict(p=p, q=q, base=base, knee=knee, jobs=jobs)
    indep = _independent_results(case, backend)
    fleet = _port_fleet(p, backend)
    ex = BatchedSimulatedExecutor2D(time_fn_batch_2d=_batch_fn(base, knee), p=p, q=q,
                                    job_names=[str(j) for j in range(q)])
    fleet.admit(JobSpec(name="0", **jobs[0]))
    fleet.step(ex)
    fleet.step(ex)
    fleet.admit(JobSpec(name="1", **jobs[1]))  # mid-flight; restack next round
    fleet.step(ex)
    fleet.admit(JobSpec(name="2", **jobs[2]))
    results = fleet.run(ex)
    for j in range(q):
        _assert_independent(indep[j], results[str(j)], fleet, str(j))
    if backend == "torch":
        assert fleet.restacks == 3


@pytest.mark.parametrize("backend", BACKENDS)
def test_retire_mid_flight_prefix_and_survivors(backend):
    rng = np.random.default_rng(201)
    p, q = 4, 3
    base, knee = _knee_params(rng, q, p)
    jobs = [dict(n=50 + 40 * j, eps=1e-6, caps=None, min_units=1, max_iter=9) for j in range(q)]
    indep = _independent_results(dict(p=p, q=q, base=base, knee=knee, jobs=jobs), backend)
    fleet = _port_fleet(p, backend)
    for j in range(q):
        fleet.admit(JobSpec(name=str(j), **jobs[j]))
    ex = BatchedSimulatedExecutor2D(time_fn_batch_2d=_batch_fn(base, knee), p=p, q=q,
                                    job_names=[str(j) for j in range(q)])
    for _ in range(3):
        fleet.step(ex)
    retired = fleet.retire("1")
    assert "1" not in fleet.jobs
    results = fleet.run(ex)
    full = indep[1]["res"].diagnostics["history"]
    got = retired.diagnostics["history"]
    assert got == full[: len(got)] and 0 < len(got) <= 3
    for j in (0, 2):
        _assert_independent(indep[j], results[str(j)], fleet, str(j))


@pytest.mark.parametrize("backend", BACKENDS)
def test_resize_equals_warm_readmission(backend):
    rng = np.random.default_rng(202)
    p = 4
    base, knee = _knee_params(rng, 1, p)
    ex = BatchedSimulatedExecutor2D(time_fn_batch_2d=_batch_fn(base, knee), p=p, q=1, job_names=["a"])
    fleet = _port_fleet(p, backend)
    fleet.admit(JobSpec(name="a", n=60, eps=0.03, min_units=1, max_iter=4))
    fleet.run(ex)
    snapshot = [PiecewiseLinearFPM.from_points(m.as_points()) for m in fleet.models("a")]
    fleet.resize("a", n=100)
    res_resized = fleet.run(ex)["a"]
    fleet2 = _port_fleet(p, backend)
    fleet2.admit(JobSpec(name="a", n=100, eps=0.03, min_units=1, max_iter=4), models=snapshot)
    res_fresh = fleet2.run(ex)["a"]
    assert res_resized.allocations == res_fresh.allocations
    assert res_resized.diagnostics["history"] == res_fresh.diagnostics["history"]
    assert sum(res_resized.allocations) == 100
    # the reference's fleet walks the same resize
    ref = _ref_fleet(p)
    ref.admit(ref_fleet.JobSpec(name="a", n=60, eps=0.03, min_units=1, max_iter=4))
    ref_ex = RefExecutor2D(time_fn_batch_2d=_batch_fn(base, knee), p=p, q=1, job_names=["a"])
    ref.run(ref_ex)
    ref.resize("a", n=100)
    assert ref.run(ref_ex)["a"].diagnostics["history"] == res_resized.diagnostics["history"]


@pytest.mark.parametrize("backend", BACKENDS)
def test_rebalance_drops_stale_result_and_reports_live_view(backend):
    rng = np.random.default_rng(203)
    p = 4
    base, knee = _knee_params(rng, 1, p)
    ex = BatchedSimulatedExecutor2D(time_fn_batch_2d=_batch_fn(base, knee), p=p, q=1, job_names=["a"])
    fleet = _port_fleet(p, backend)
    fleet.admit(JobSpec(name="a", n=60, eps=0.3, min_units=1, max_iter=6))
    fleet.run(ex)
    assert fleet.result("a").converged
    d_new = fleet.rebalance({"a": 120})["a"]
    assert sum(d_new) == 120
    snap = fleet.snapshot("a")
    assert snap.allocations == d_new and sum(snap.allocations) == 120
    with pytest.raises(ValueError, match="not finished"):
        fleet.result("a")
    ref = _ref_fleet(p)
    ref.admit(ref_fleet.JobSpec(name="a", n=60, eps=0.3, min_units=1, max_iter=6))
    ref.run(RefExecutor2D(time_fn_batch_2d=_batch_fn(base, knee), p=p, q=1, job_names=["a"]))
    assert ref.rebalance({"a": 120})["a"] == d_new


# ---------------------------------------------------------------------------
# Adversarial non-monotone job: demotes only its own lane
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
def test_adversarial_job_demotes_only_its_own_lane(backend, monkeypatch):
    rng = np.random.default_rng(300)
    p, q = 4, 3
    base, knee = _knee_params(rng, q, p)
    dip_scalar, dip_row = _dip_fns(p)

    def batch(X):
        T = _knee_time(base, knee, X)
        T[1] = dip_row(X[1])
        return T

    masks = []
    real = TorchModelBank.partition_units

    def spy(self, *args, **kw):
        if kw.get("completion_lanes") is not None:
            masks.append(np.array(kw["completion_lanes"]))
        return real(self, *args, **kw)

    monkeypatch.setattr(TorchModelBank, "partition_units", spy)
    indep = []
    for j in range(q):
        ex1 = SimulatedExecutor(time_fns=dip_scalar if j == 1 else _scalar_fns(base, knee, j))
        sched = _port_sched(p, backend)
        res = sched.autotune(ex1, 90, 0.02, max_iter=6, min_units=1)
        indep.append(dict(res=res, cost=_round_costs(ex1), points=[m.as_points() for m in sched.store.models]))
    masks.clear()
    fleet = _port_fleet(p, backend)
    ref = _ref_fleet(p)
    for fl, spec in ((fleet, JobSpec), (ref, ref_fleet.JobSpec)):
        for j in range(q):
            fl.admit(spec(name=str(j), n=90, eps=0.02, min_units=1, max_iter=6))
    names = [str(j) for j in range(q)]
    results = fleet.run(BatchedSimulatedExecutor2D(time_fn_batch_2d=batch, p=p, q=q, job_names=names))
    ref_results = ref.run(RefExecutor2D(time_fn_batch_2d=batch, p=p, q=q, job_names=names))
    for j in range(q):
        _assert_independent(indep[j], results[str(j)], fleet, str(j))
    assert _summary(fleet, results, q) == _summary(ref, ref_results, q)
    assert fleet._jobs["1"].bank().is_monotone() is False
    assert fleet._jobs["0"].bank().is_monotone() is True
    assert fleet._jobs["2"].bank().is_monotone() is True
    if backend == "torch":
        # at least one stacked call ran with a mixed per-lane mask
        assert any(m.shape == (q,) and not m[1] and m[0] and m[2] for m in masks)


# ---------------------------------------------------------------------------
# Per-job knobs, validation, refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
def test_mixed_caps_and_min_units_respected(backend):
    rng = np.random.default_rng(400)
    p = 5
    base, knee = _knee_params(rng, 2, p)
    caps = [8, 40, 40, 40, 40]
    out = []
    for fl, spec, ex_cls in ((_port_fleet(p, backend), JobSpec, BatchedSimulatedExecutor2D),
                             (_ref_fleet(p), ref_fleet.JobSpec, RefExecutor2D)):
        fl.admit(spec(name="capped", n=60, eps=0.05, caps=caps, min_units=1))
        fl.admit(spec(name="free", n=95, eps=0.05, min_units=2))
        res = fl.run(ex_cls(time_fn_batch_2d=_batch_fn(base, knee), p=p, q=2, job_names=["capped", "free"]))
        out.append({k: (r.allocations, r.diagnostics["history"]) for k, r in res.items()})
    assert out[0] == out[1]
    d_c, d_f = out[0]["capped"][0], out[0]["free"][0]
    assert sum(d_c) == 60 and all(1 <= v <= c for v, c in zip(d_c, caps))
    assert sum(d_f) == 95 and all(v >= 2 for v in d_f)


def test_admit_validation_mirrors_autotune():
    fleet = _port_fleet(4, "numpy")
    with pytest.raises(ValueError, match="n >= p"):
        fleet.admit(JobSpec(name="a", n=3))
    with pytest.raises(ValueError, match="eps"):
        fleet.admit(JobSpec(name="a", n=8, eps=0.0))
    with pytest.raises(ValueError, match="min_units"):
        fleet.admit(JobSpec(name="a", n=8, caps=[1, 8, 8, 8], min_units=2))
    with pytest.raises(ValueError, match="warm_start_d"):
        fleet.admit(JobSpec(name="a", n=8, warm_start_d=[1, 1, 1]))
    fleet.admit(JobSpec(name="a", n=8))
    with pytest.raises(ValueError, match="already admitted"):
        fleet.admit(JobSpec(name="a", n=12))
    with pytest.raises(ValueError, match="completion"):
        fleet.admit(JobSpec(name="b", n=8, completion="fast"))


def test_pipeline_raises_naming_item_7b():
    """The reference's ``test_pipeline_validation`` (the pipeline is
    ported, so nothing raises for item 7b any more): a scalar fleet and
    depth 2 raise, and both banked backends build a depth-1 pipeline."""
    with pytest.raises(ValueError, match="banked backend"):
        _port_fleet(4, "scalar", pipeline=True)
    with pytest.raises(ValueError, match="pipeline_depth"):
        _port_fleet(4, "numpy", pipeline=True, pipeline_depth=2)
    # pipeline_depth is validated whether or not the pipeline is on
    with pytest.raises(ValueError, match="pipeline_depth"):
        _port_fleet(4, "numpy", pipeline_depth=2)
    for backend in BACKENDS:
        fl = _port_fleet(4, backend, pipeline=True)
        assert fl.pipeline and fl.pipeline_depth == 1
        assert fl.stats()["predispatches"] == fl.stats()["stale_reads"] == 0


def test_refusals_and_device_default():
    import torch

    with pytest.raises(ValueError, match="unknown backend"):
        FleetScheduler(4, backend="jax")
    with pytest.raises(NotImplementedError, match="single card"):
        _port_fleet(4, "torch", groups=[0, 0, 1, 1], sharding="shard_map")
    with pytest.raises(ValueError, match="unknown sharding"):
        _port_fleet(4, "torch", sharding="mesh")
    with pytest.raises(NotImplementedError, match="compiles no device program"):
        _port_fleet(4, "torch", compilation_cache_dir="/nonexistent")
    with pytest.raises(ValueError, match="banked backend"):
        _port_fleet(4, "scalar", groups=[0, 0, 1, 1])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            FleetScheduler(4)
    # the host backends never touch a device
    assert FleetScheduler(4, backend="numpy").backend == "numpy"
    assert _port_fleet(4, "torch")._device == torch.device("cpu")


# ---------------------------------------------------------------------------
# Profile registry: warm-start round-trip + corruption fallbacks
# ---------------------------------------------------------------------------

CLASSES = ["cpu", "cpu", "gpu", "gpu"]


def _class_fns():
    """Same-class processors share EXACT time fns, so class-keyed profile
    merging is lossless and the round-trip can be bit-identical."""
    per_class = {"cpu": (9e-4, 25.0), "gpu": (3e-4, 70.0)}
    a = np.asarray([[per_class[c][0] for c in CLASSES]])
    k = np.asarray([[per_class[c][1] for c in CLASSES]])
    return a, k


@pytest.mark.parametrize("backend", BACKENDS)
def test_registry_roundtrip_reproduces_donor_allocations(backend, tmp_path):
    a, k = _class_fns()
    p = 4
    reg = ProfileRegistry()
    donor = _port_fleet(p, backend, registry=reg, device_classes=CLASSES)
    donor.admit(JobSpec(name="donor", n=80, eps=1e-9, min_units=1, max_iter=4, workload="matmul"))
    donor.run(BatchedSimulatedExecutor2D(time_fn_batch_2d=_batch_fn(a, k), p=p, q=1, job_names=["donor"]))
    want = Scheduler(
        SpeedStore.from_models([PiecewiseLinearFPM.from_points(m.as_points()) for m in donor.models("donor")],
                               backend=backend, device="cpu"),
        backend=backend, device="cpu",
    ).partition(80, min_units=1).allocations
    donor.save_profiles()
    path = tmp_path / "profiles.json"
    reg.save(str(path))
    reg2 = ProfileRegistry.load(str(path))
    fleet2 = _port_fleet(p, backend, registry=reg2, device_classes=CLASSES)
    fleet2.admit(JobSpec(name="fresh", n=80, eps=1e-9, min_units=1, max_iter=1, workload="matmul"))
    fleet2.run(BatchedSimulatedExecutor2D(time_fn_batch_2d=_batch_fn(a, k), p=p, q=1, job_names=["fresh"]))
    first_d = fleet2._jobs["fresh"].history[0][0]
    assert first_d == want  # NOT the even split: warm start engaged
    assert first_d != _even(80, p)
    # the reference's registry reads the port's file the same way
    assert ref_fleet.ProfileRegistry.load(str(path)).state_dict() == reg2.state_dict()


def test_registry_missing_workload_starts_cold():
    a, k = _class_fns()
    reg = ProfileRegistry()
    reg.record("cpu", "other-workload", [(10.0, 5.0)])
    fleet = _port_fleet(4, "torch", registry=reg, device_classes=CLASSES)
    fleet.admit(JobSpec(name="j", n=80, eps=0.05, min_units=1, max_iter=2, workload="matmul"))
    fleet.run(BatchedSimulatedExecutor2D(time_fn_batch_2d=_batch_fn(a, k), p=4, q=1, job_names=["j"]))
    assert fleet._jobs["j"].history[0][0] == _even(80, 4)


def test_registry_missing_file_warns_and_starts_cold(tmp_path):
    with pytest.warns(UserWarning, match="not found"):
        reg = ProfileRegistry.load(str(tmp_path / "nope.json"))
    assert len(reg) == 0


def test_registry_corrupt_json_warns_and_starts_cold(tmp_path):
    path = tmp_path / "broken.json"
    path.write_text("{ this is not json")
    with pytest.warns(UserWarning, match="unreadable"):
        reg = ProfileRegistry.load(str(path))
    assert len(reg) == 0
    path.write_text(json.dumps({"version": 1, "entries": "nope"}))
    with pytest.warns(UserWarning, match="malformed"):
        reg = ProfileRegistry.load(str(path))
    assert len(reg) == 0


def test_registry_malformed_entry_skipped_with_warning(tmp_path):
    path = tmp_path / "mixed.json"
    path.write_text(json.dumps({"version": 1, "entries": [
        {"device_class": "cpu", "workload": "w", "points": [[10.0, 5.0], [20.0, 4.0]]},
        {"device_class": "gpu", "workload": "w", "points": [[-3.0, 5.0]]},  # non-positive x
        {"device_class": "tpu", "workload": "w", "points": [[30.0, "bad"]]},
    ]}))
    with pytest.warns(UserWarning, match="malformed"):
        reg = ProfileRegistry.load(str(path))
    assert reg.get("cpu", "w") == [(10.0, 5.0), (20.0, 4.0)]
    assert ("gpu", "w") not in reg and ("tpu", "w") not in reg
    models = reg.warm_models(["cpu", "gpu"], "w")
    assert models[0].num_points == 2 and models[1].num_points == 0


def test_registry_merge_keeps_freshest_on_duplicate_x():
    reg = ProfileRegistry()
    reg.record("cpu", "w", [(10.0, 5.0), (20.0, 4.0)])
    reg.record("cpu", "w", [(10.0, 6.0), (30.0, 3.0)])
    assert reg.get("cpu", "w") == [(10.0, 6.0), (20.0, 4.0), (30.0, 3.0)]


# ---------------------------------------------------------------------------
# Energy: the power-capped repartition, registry energy entries
# ---------------------------------------------------------------------------


def _energy_fixtures(p, seed, fpm=PiecewiseLinearFPM, emodel=energy_model):
    """Heterogeneous speed + affine energy models (fast rows power-hungry)."""
    rng = np.random.default_rng(seed)
    xs = [1.0, 10.0, 50.0, 200.0, 800.0]
    speed = [
        fpm.from_points([(x, float(1.0 + 2.0 * rng.random()) * (1.0 + 0.1 * (i % 3))) for x in xs])
        for i in range(p)
    ]
    energy = [emodel([(x, 3.0 * (i + 1) + float(0.1 + rng.random()) * x) for x in xs]) for i in range(p)]
    return speed, energy


def _ref_energy_fixtures(p, seed):
    return _energy_fixtures(p, seed, RefFPM, ref_energy_model)


def _fleet_round_energy(fleet, name, d):
    e = fleet._jobs[name].ebank().time(np.asarray(d, dtype=np.float64))
    return float(e.sum())


def _priced(fl, fixtures, ns, spec=JobSpec):
    for j, n in enumerate(ns):
        sm, em = fixtures(5, 10 + j)
        fl.admit(spec(str(j), n), models=sm, energy_models=em)
    return fl


@pytest.mark.parametrize("backend", BACKENDS)
def test_power_cap_binds_and_fits_budget(backend):
    p = 5
    free = _priced(_port_fleet(p, backend), _energy_fixtures, (300, 500))
    ds0 = free.rebalance()
    e_free = sum(_fleet_round_energy(free, nm, d) for nm, d in ds0.items())
    e_floor = 0.0
    for nm, job in free._jobs.items():
        de, _ = _partition_units_bank(job.ebank(), job.spec.n, [int(c) for c in job.icaps], min_units=0)
        e_floor += _fleet_round_energy(free, nm, de)
    assert e_floor < e_free  # non-degenerate: the cap can bind
    cap = 0.5 * (e_floor + e_free)
    capped = _priced(_port_fleet(p, backend, power_cap=cap), _energy_fixtures, (300, 500))
    ds1 = capped.rebalance()
    e_capped = sum(_fleet_round_energy(capped, nm, d) for nm, d in ds1.items())
    assert e_capped <= cap + 1e-9
    assert e_free > cap
    for nm, d in ds1.items():
        assert sum(d) == capped._jobs[nm].spec.n
    ref = _priced(_ref_fleet(p, power_cap=cap), _ref_energy_fixtures, (300, 500), ref_fleet.JobSpec)
    assert ref.rebalance() == ds1


@pytest.mark.parametrize("backend", BACKENDS)
def test_power_cap_none_is_bit_identical(backend):
    p = 4
    sm, em = _energy_fixtures(p, seed=3)
    a, b = _port_fleet(p, backend), _port_fleet(p, backend, power_cap=None)
    for fl in (a, b):
        fl.admit(JobSpec("t", 200), models=sm, energy_models=em)
    assert a.rebalance() == b.rebalance()


@pytest.mark.parametrize("backend", BACKENDS)
def test_power_cap_unpriced_jobs_run_time_optimal(backend):
    p = 4
    sm, _ = _energy_fixtures(p, seed=7)
    free = _port_fleet(p, backend)
    free.admit(JobSpec("u", 240), models=sm)
    want = free.rebalance()["u"]
    capped = _port_fleet(p, backend, power_cap=1e-6)
    capped.admit(JobSpec("u", 240), models=sm)
    assert capped.rebalance()["u"] == want


@pytest.mark.parametrize("backend", BACKENDS)
def test_power_cap_infeasible_degrades_to_energy_optimal(backend):
    p = 4
    sm, em = _energy_fixtures(p, seed=9)
    fl = _port_fleet(p, backend, power_cap=1e-9)
    fl.admit(JobSpec("t", 200), models=sm, energy_models=em)
    d = fl.rebalance()["t"]
    job = fl._jobs["t"]
    de, _ = _partition_units_bank(job.ebank(), 200, [int(c) for c in job.icaps], min_units=0)
    assert d == [int(v) for v in de]


def test_registry_energy_entries_roundtrip(tmp_path):
    p = 4
    classes = ["cpu", "cpu", "gpu", "gpu"]
    xs = [1.0, 10.0, 100.0]
    per_class = {"cpu": (5.0, 0.9), "gpu": (20.0, 0.3)}
    em = [energy_model([(x, per_class[c][0] + per_class[c][1] * x) for x in xs]) for c in classes]
    sm, _ = _energy_fixtures(p, seed=1)
    reg = ProfileRegistry()
    fl = _port_fleet(p, "numpy", registry=reg, device_classes=classes)
    fl.admit(JobSpec("d", 100, workload="decode"), models=sm, energy_models=em)
    fl.rebalance()
    fl.retire("d")
    path = tmp_path / "profiles.json"
    reg.save(str(path))
    reg2 = ProfileRegistry.load(str(path))
    warm = reg2.warm_energy_models(classes, "decode")
    assert warm is not None and len(warm) == p
    assert warm[0].as_points() == em[0].as_points()
    fl2 = _port_fleet(p, "torch", registry=reg2, device_classes=classes)
    fl2.admit(JobSpec("d2", 100, workload="decode"), models=sm)
    assert fl2._jobs["d2"].energy_models is not None
    assert reg2.warm_energy_models(["cpu", "tpu"], "decode") is None
    state = reg2.state_dict()
    state.pop("energy_entries")
    assert ProfileRegistry.from_state(state).warm_energy_models(classes, "decode") is None


# ---------------------------------------------------------------------------
# Lane buckets, hierarchical jobs, the serving cycle
# ---------------------------------------------------------------------------


def test_lane_buckets_bit_parity_and_restacks():
    """Bucketed fleets serve bit-identical allocations to unbucketed ones;
    the q = 3 stack pads to 4 lanes, and the restacks are the reference
    jax fleet's."""
    p = 5

    def mk(make, spec, fixtures, buckets):
        fl = make(p, reserve_knots=16, lane_buckets=buckets)
        for j in range(3):
            fl.admit(spec(f"j{j}", 150 + 40 * j), models=fixtures(p, 30 + j)[0])
        return fl

    def drive(fl, spec, fixtures):
        out = [fl.rebalance()]
        fl.observe({"j0": [0.1 * (i + 1) for i in range(p)]})
        out.append(fl.rebalance())
        fl.admit(spec("j3", 400), models=fixtures(p, 33)[0])
        out.append(fl.rebalance())
        fl.observe({"j3": [0.1 * (i + 1) for i in range(p)]})
        out.append(fl.rebalance())
        return out

    port = lambda p, **kw: _port_fleet(p, "torch", **kw)  # noqa: E731
    plain, bucketed = (mk(port, JobSpec, _energy_fixtures, b) for b in (False, True))
    got_plain = drive(plain, JobSpec, _energy_fixtures)
    assert int(bucketed._ensure_stack().counts.shape[0]) == 4 and len(bucketed.jobs) == 3
    got = drive(bucketed, JobSpec, _energy_fixtures)
    assert got == got_plain and sum(got[-1]["j3"]) == 400
    with jax.enable_x64(True):
        ref_make = lambda p, **kw: ref_fleet.FleetScheduler(p, backend="jax", **kw)  # noqa: E731
        ref = mk(ref_make, ref_fleet.JobSpec, _ref_energy_fixtures, True)
        assert drive(ref, ref_fleet.JobSpec, _ref_energy_fixtures) == got
        assert bucketed.stats() == ref.stats()


def test_lane_buckets_full_autotune_parity():
    rng = np.random.default_rng(500)
    p, q = 4, 3  # q=3 pads to 4: one dead lane in every solve
    base, knee = _knee_params(rng, q, p)
    jobs = [dict(n=50 + 30 * j, eps=0.05, min_units=1, max_iter=6) for j in range(q)]
    out = []
    for buckets in (False, True):
        fleet = _port_fleet(p, "torch", lane_buckets=buckets)
        for j in range(q):
            fleet.admit(JobSpec(name=str(j), **jobs[j]))
        res = fleet.run(BatchedSimulatedExecutor2D(time_fn_batch_2d=_batch_fn(base, knee), p=p, q=q,
                                                   job_names=[str(j) for j in range(q)]))
        out.append(_summary(fleet, res, q))
    assert out[0] == out[1]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("groups", [[0] * 6, [0, 0, 1, 1, 2, 2], [0, 1, 0, 1, 2, 2]])
def test_hierarchical_fleet_matches_reference(backend, groups, monkeypatch):
    """A ``groups=`` fleet routes every repartition through the two-level
    solve; its rounds equal the reference's numpy hierarchical fleet, and
    on the torch backend ``device_dispatches`` counts one per job's
    two-level solve and one per fold, as the reference's jax fleet does."""
    from repro_torch.core import Hierarchy

    calls = {"hier": 0, "fold": 0}
    for cls, name, key in ((Hierarchy, "partition_units", "hier"), (TorchModelBank, "fold_in", "fold")):
        def spy(self, *a, _real=getattr(cls, name), _key=key, **kw):
            calls[_key] += 1
            return _real(self, *a, **kw)
        monkeypatch.setattr(cls, name, spy)
    rng = np.random.default_rng(600)
    p, q = 6, 3
    base, knee = _knee_params(rng, q, p)
    case = dict(p=p, q=q, base=base, knee=knee,
                jobs=[dict(n=60 + 25 * j, eps=0.03, min_units=1, max_iter=6) for j in range(q)])
    fleet = _port_fleet(p, backend, groups=groups)
    results = _run_fleet(fleet, JobSpec, BatchedSimulatedExecutor2D, case)
    ref = _ref_fleet(p, groups=groups)
    ref_results = _run_fleet(ref, ref_fleet.JobSpec, RefExecutor2D, case)
    assert _summary(fleet, results, q) == _summary(ref, ref_results, q)
    assert calls["hier"] > 0
    if backend == "torch":
        assert fleet.device_dispatches == calls["hier"] + calls["fold"] and calls["fold"] == fleet.rounds
    else:
        assert fleet.device_dispatches == calls["fold"] == 0


def _serving_cycle(make, spec, fixtures, quantize):
    """rebalance -> straggler_actions -> observe epochs with replica 2
    slowing 2x more every epoch, then a reprofile and a retire."""
    p = 5
    fl = make(p, quantize=quantize)
    for j in range(2):
        fl.admit(spec(f"s{j}", 200 + 50 * j), models=fixtures(p, 40 + j)[0])
    out = []
    slow = 1.0
    for _ in range(7):
        ds = fl.rebalance()
        slow *= 2.0
        times = {nm: [0.01 * (i + 1) * d[i] * (slow if i == 2 else 1.0) for i in range(p)]
                 for nm, d in ds.items()}
        acts = [a.value for a in fl.straggler_actions(times)]
        fl.observe(times)
        out.append((ds, acts))
    fl.reprofile_replica(0)
    fl.observe({nm: [0.02 * (i + 1) * d for i, d in enumerate(fl.distribution(nm))] for nm in fl.jobs})
    out.append((fl.rebalance(), [m.as_points() for m in fl.models("s0")]))
    fl.retire("s1", save_profile=False)
    out.append((fl.rebalance(), fl.stats()["rounds"]))
    return out


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("quantize", [0.0, 0.05])
def test_serving_cycle_and_straggler_actions_match_reference(backend, quantize):
    got = _serving_cycle(lambda p, **kw: _port_fleet(p, backend, **kw), JobSpec, _energy_fixtures, quantize)
    want = _serving_cycle(lambda p, **kw: _ref_fleet(p, **kw), ref_fleet.JobSpec, _ref_energy_fixtures, quantize)
    assert got == want
    assert any("reprofile" in acts for _, acts in got[:7])


# ---------------------------------------------------------------------------
# Checkpoints: state_dict round-trip, the reference's state
# ---------------------------------------------------------------------------


def _checkpoint_case():
    rng = np.random.default_rng(700)
    p, q = 4, 3
    base, knee = _knee_params(rng, q, p)
    jobs = [dict(n=50 + 40 * j, eps=1e-6 if j else 0.05, min_units=1, max_iter=9) for j in range(q)]
    return p, q, base, knee, jobs


def _results(fleet, res, q):
    return [(res[str(j)].allocations, res[str(j)].diagnostics["history"], fleet.bench_cost(str(j)),
             [m.as_points() for m in fleet.models(str(j))]) for j in range(q)]


@pytest.mark.parametrize("backend", BACKENDS)
def test_state_roundtrip_continues_bit_identically(backend):
    p, q, base, knee, jobs = _checkpoint_case()
    names = [str(j) for j in range(q)]

    def ex():
        return BatchedSimulatedExecutor2D(time_fn_batch_2d=_batch_fn(base, knee), p=p, q=q, job_names=names)

    donor = _port_fleet(p, backend)
    for j in range(q):
        donor.admit(JobSpec(name=str(j), **jobs[j]))
    for _ in range(3):
        donor.step(ex())
    state = json.loads(json.dumps(donor.state_dict()))
    assert state["version"] == 1 and state["config"]["backend"] == backend
    restored = FleetScheduler.from_state(state, device="cpu")
    assert restored.backend == backend and restored.rounds == donor.rounds
    want = donor.run(ex())
    got = restored.run(ex())
    assert _results(restored, got, q) == _results(donor, want, q)
    # a checkpoint moves between backends
    other = FleetScheduler.from_state(state, device="cpu", backend="numpy" if backend == "torch" else "torch")
    assert _results(other, other.run(ex()), q) == _results(donor, want, q)


@pytest.mark.parametrize("ref_backend", ["numpy", "jax"])
def test_reference_state_resumes_in_the_port(ref_backend):
    """A reference fleet checkpointed mid-flight (its ``"jax"`` backend
    restores as ``"torch"``) continues in the port exactly as it continues
    in the reference."""
    p, q, base, knee, jobs = _checkpoint_case()
    names = [str(j) for j in range(q)]
    with jax.enable_x64(True):
        ref = ref_fleet.FleetScheduler(p, backend=ref_backend)
        for j in range(q):
            ref.admit(ref_fleet.JobSpec(name=str(j), **jobs[j]))
        ref_ex = RefExecutor2D(time_fn_batch_2d=_batch_fn(base, knee), p=p, q=q, job_names=names)
        for _ in range(3):
            ref.step(ref_ex)
        state = json.loads(json.dumps(ref.state_dict()))
        want = ref.run(ref_ex)
        want = _results(ref, want, q)
    port = FleetScheduler.from_state(state, device="cpu")
    assert port.backend == ("torch" if ref_backend == "jax" else "numpy")
    got = port.run(BatchedSimulatedExecutor2D(time_fn_batch_2d=_batch_fn(base, knee), p=p, q=q, job_names=names))
    assert _results(port, got, q) == want


def test_reference_state_refusals():
    """``sharding`` is refused; a pipelined reference fleet checkpointed
    mid-flight resumes pipelined in the port and continues as the reference
    does."""
    from repro_torch.core.convert import fleet_state_from_reference

    state = _ref_fleet(4).state_dict()
    assert fleet_state_from_reference(state)["config"]["backend"] == "numpy"
    bad = json.loads(json.dumps(state))
    bad["config"]["sharding"] = "shard_map"
    with pytest.raises(NotImplementedError, match="single card"):
        FleetScheduler.from_state(bad, device="cpu")
    with pytest.raises(ValueError, match="version"):
        fleet_state_from_reference({**state, "version": 2})

    p, q, base, knee, jobs = _checkpoint_case()
    names = [str(j) for j in range(q)]
    with jax.enable_x64(True):
        ref = ref_fleet.FleetScheduler(p, backend="jax", pipeline=True, pipeline_depth=1)
        for j in range(q):
            ref.admit(ref_fleet.JobSpec(name=str(j), **jobs[j]))
        ref_ex = RefExecutor2D(time_fn_batch_2d=_batch_fn(base, knee), p=p, q=q, job_names=names)
        for _ in range(3):
            ref.step(ref_ex)
        state = json.loads(json.dumps(ref.state_dict()))
        want = _results(ref, ref.run(ref_ex), q)
    port = FleetScheduler.from_state(state, device="cpu")
    assert port.backend == "torch" and port.pipeline and port.pipeline_depth == 1
    got = port.run(BatchedSimulatedExecutor2D(time_fn_batch_2d=_batch_fn(base, knee), p=p, q=q, job_names=names))
    assert _results(port, got, q) == want
    assert port.state_dict()["config"]["pipeline"] is True


def test_drain_and_stats_keys():
    p, q, base, knee, jobs = _checkpoint_case()
    fleet = _port_fleet(p, "torch")
    for j in range(q):
        fleet.admit(JobSpec(name=str(j), **jobs[j]))
    fleet.step(BatchedSimulatedExecutor2D(time_fn_batch_2d=_batch_fn(base, knee), p=p, q=q,
                                          job_names=[str(j) for j in range(q)]))
    assert all(fleet._jobs[nm].pending_obs for nm in fleet.jobs)
    fleet.drain()
    assert not any(fleet._jobs[nm].pending_obs for nm in fleet.jobs)
    assert set(fleet.stats()) == set(_ref_fleet(p).stats())
    assert fleet.stats()["device_dispatches"] == 1  # the first round only folds


# ---------------------------------------------------------------------------
# chip_smoke.py's fleet gates: the numbers it holds on the card
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_pins_are_the_reference_counts(smoke):
    """``FLEET_PARITY_DISPATCHES`` and ``FLEET_BUCKET_RESTACKS`` are what the
    reference's jax fleet counts on the same fixtures."""
    q, p, seed = (smoke.FLEET_PARITY[k] for k in ("q", "p", "seed"))
    batch_fn, _, ns = smoke.fleet_knee_case(q, p, seed)
    names = [f"t{j}" for j in range(q)]
    with jax.enable_x64(True):
        ref = ref_fleet.FleetScheduler(p, backend="jax")
        for nm, n in zip(names, ns):
            ref.admit(ref_fleet.JobSpec(name=nm, n=n, eps=smoke.FLEET_EPS, min_units=1,
                                        max_iter=smoke.FLEET_MAX_ITER))
        ref.run(RefExecutor2D(time_fn_batch_2d=batch_fn, p=p, q=q, job_names=names))
        assert ref.device_dispatches == smoke.FLEET_PARITY_DISPATCHES

        p = smoke.FLEET_BUCKET["p"]
        _, warm = smoke.fleet_make_tenants(4, p, seed=smoke.FLEET_BUCKET["seed"])
        ns = [100 * p + 7 * j for j in range(4)]
        fl = ref_fleet.FleetScheduler(p, backend="jax", reserve_knots=16, lane_buckets=True)
        for j in range(3):
            fl.admit(ref_fleet.JobSpec(name=f"t{j}", n=ns[j], eps=1e-12, min_units=1),
                     models=[RefFPM.from_points(m.as_points()) for m in warm[j]])
        fl.rebalance()
        fl.observe({"t0": [0.1 * (i + 1) for i in range(p)]})
        fl.rebalance()
        fl.admit(ref_fleet.JobSpec(name="t3", n=ns[3], eps=1e-12, min_units=1),
                 models=[RefFPM.from_points(m.as_points()) for m in warm[3]])
        fl.rebalance()
        fl.observe({"t3": [0.1 * (i + 1) for i in range(p)]})
        assert fl.restacks == smoke.FLEET_BUCKET_RESTACKS


@pytest.mark.parametrize("gate", ["fleet_parity_gate", "fleet_hier_gate", "fleet_bucket_gate"])
def test_chip_smoke_fleet_gates_hold_on_the_host(smoke, gate):
    """The ``fleet`` phase's part (a), with the carry on the CPU."""
    row = getattr(smoke, gate)("cpu")
    assert all(row["checks"].values()), row
