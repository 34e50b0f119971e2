"""The port's pipelined fleet rounds held against the reference's.

``repro_torch.fleet.FleetScheduler(pipeline=True)`` on its ``"numpy"`` and
``"torch"`` backends (the torch carry on the CPU in float64) runs the cases
of ``tests/test_fleet_pipeline.py`` (which does not collect on this
toolchain: its module imports ``jax.experimental.enable_x64``), from the
same seeds.  Two oracles:

* the reference's numpy fleet with ``pipeline=True`` fixes the numerics and
  the speculation counters (``stale_reads``, ``speculative_misses``) of
  both port backends' flat rounds, and of the two-level route;
* the reference's jax fleet with ``pipeline=True``, scoped with
  ``jax.enable_x64(True)``, fixes the counters the torch backend must reach
  on the card (``predispatches``, ``device_dispatches``) and its
  speculation counters where they differ from the numpy fleet's (the
  serving cycle).

The contract (tolerance zero): depth 0 is bit-identical to sync; depth 1
converges to sync's allocations within 2 extra rounds and is bit-identical
on deterministic replays; staleness never passes one generation.  The
deferred partition (``TorchModelBank.partition_units(defer=True)``) reads
nothing back before ``fetch_partition`` and equals the sync program bit
for bit.  Fuzz lanes of 200 cases run under the ``slow`` marker, with
small tier-1 smokes.
"""

import itertools
import json

import jax
import numpy as np
import pytest
import torch

import repro.fleet as ref_fleet
from repro.core import BatchedSimulatedExecutor2D as RefExecutor2D
from repro.core import DelayedBatchedExecutor as RefDelayedExecutor
from repro.core import PiecewiseLinearFPM as RefFPM
from repro.core.energy import energy_model as ref_energy_model

from repro_torch.core import (
    BatchedSimulatedExecutor2D,
    DelayedBatchedExecutor,
    ModelBank,
    PiecewiseLinearFPM,
    SpeedStore,
    TorchModelBank,
    fetch_partition,
)
from repro_torch.core import modelbank_torch as mbt
from repro_torch.core.energy import energy_model
from repro_torch.fleet import FleetScheduler, JobSpec

BACKENDS = ["numpy", "torch"]
SPEC_COUNTERS = ("stale_reads", "speculative_misses")
DEVICE_COUNTERS = ("predispatches", "device_dispatches")


# ---------------------------------------------------------------------------
# Case builders (tests/test_fleet.py's and tests/test_fleet_pipeline.py's)
# ---------------------------------------------------------------------------


def _knee_params(rng, q, p):
    base = rng.uniform(1e-4, 2e-3, (q, p))
    knee = rng.uniform(5.0, 80.0, (q, p))
    return base, knee


def _knee_time(base, knee, x):
    t = x * base
    return t + np.where(x > knee, (x - knee) * base * 4.0, 0.0)


def _batch_fn(base, knee):
    def fn(X):
        return _knee_time(base, knee, X)

    return fn


def _random_fleet_case(rng):
    p = int(rng.integers(2, 7))
    q = int(rng.integers(1, 5))
    base, knee = _knee_params(rng, q, p)
    jobs = []
    for _ in range(q):
        n = int(rng.integers(max(2 * p, 8), 60 * p))
        min_units = int(rng.integers(0, 2))
        caps = None
        if rng.random() < 0.4:
            lo = max(1, min_units)
            caps = [lo + int(f * n) for f in rng.uniform(0.6, 1.0, p)]
        jobs.append(dict(n=n, eps=float(rng.uniform(0.02, 0.25)), caps=caps,
                         min_units=min_units, max_iter=int(rng.integers(3, 12))))
    return dict(p=p, q=q, base=base, knee=knee, jobs=jobs)


def _converging_case(rng):
    """Like ``_random_fleet_case`` but with head-room to converge: moderate
    eps, generous max_iter, no caps."""
    p = int(rng.integers(2, 7))
    q = int(rng.integers(1, 5))
    base, knee = _knee_params(rng, q, p)
    jobs = [
        dict(n=int(rng.integers(max(2 * p, 8), 60 * p)), eps=float(rng.uniform(0.06, 0.25)),
             caps=None, min_units=1, max_iter=24)
        for _ in range(q)
    ]
    return dict(p=p, q=q, base=base, knee=knee, jobs=jobs)


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


# ---------------------------------------------------------------------------
# Both packages behind one interface
# ---------------------------------------------------------------------------


class _Pkg:
    def __init__(self, fleet, spec, ex, delayed, fpm, emodel):
        self.fleet, self.spec, self.ex, self.delayed = fleet, spec, ex, delayed
        self.fpm, self.emodel = fpm, emodel


PORT = _Pkg(lambda p, **kw: FleetScheduler(p, device="cpu", **kw), JobSpec,
            BatchedSimulatedExecutor2D, DelayedBatchedExecutor, PiecewiseLinearFPM, energy_model)
REF = _Pkg(ref_fleet.FleetScheduler, ref_fleet.JobSpec, RefExecutor2D, RefDelayedExecutor,
           RefFPM, ref_energy_model)


def _ref_backend(backend):
    """The reference fleet that fixes the port backend's counters."""
    return "jax" if backend == "torch" else "numpy"


def _mk_fleet(pkg, case, backend, **kw):
    fleet = pkg.fleet(case["p"], backend=backend, **kw)
    for j, spec in enumerate(case["jobs"]):
        fleet.admit(pkg.spec(name=str(j), **spec))
    return fleet


def _mk_ex(pkg, case):
    return pkg.ex(time_fn_batch_2d=_batch_fn(case["base"], case["knee"]), p=case["p"], q=case["q"],
                  job_names=[str(j) for j in range(case["q"])])


def _run_case(pkg, case, backend, **kw):
    with jax.enable_x64(True):
        fleet = _mk_fleet(pkg, case, backend, **kw)
        return fleet, fleet.run(_mk_ex(pkg, case))


def _session(fleet, results, q):
    """Everything a fleet session decided, per job: allocations, times,
    iterations, verdicts, histories, bench costs and folded estimates."""
    out = []
    for j in range(q):
        r = results[str(j)]
        out.append((r.allocations, r.times, r.iterations, r.converged, r.imbalance,
                    r.diagnostics["history"], fleet.bench_cost(str(j)),
                    [m.as_points() for m in fleet.models(str(j))]))
    return out


def _counts(fleet, keys):
    return {k: fleet.stats()[k] for k in keys}


def _check_against_reference(case, backend, fleet, results, jax_counts=True, **kw):
    """The port's pipelined session equals the reference numpy fleet's
    (numerics; its speculation counters on the flat route) and, on the
    torch backend, reaches the reference jax fleet's device counters."""
    ref, ref_res = _run_case(REF, case, "numpy", **kw)
    assert _session(fleet, results, case["q"]) == _session(ref, ref_res, case["q"])
    assert _counts(fleet, SPEC_COUNTERS) == _counts(ref, SPEC_COUNTERS)
    if backend == "torch" and jax_counts:
        rj, _ = _run_case(REF, case, "jax", **kw)
        assert _counts(fleet, DEVICE_COUNTERS + SPEC_COUNTERS) == _counts(rj, DEVICE_COUNTERS + SPEC_COUNTERS)


def _check_depth0_identity(case, backend, jax_counts=True):
    fs, rs = _run_case(PORT, case, backend)
    fp, rp = _run_case(PORT, case, backend, pipeline=True, pipeline_depth=0)
    assert _session(fp, rp, case["q"]) == _session(fs, rs, case["q"])
    assert fp.stale_reads == 0  # depth 0 never reads the stale generation
    _check_against_reference(case, backend, fp, rp, jax_counts, pipeline=True, pipeline_depth=0)


def _check_bounded_staleness(case, backend, jax_counts=True):
    """Depth 1: sync's allocations within <= 2 extra rounds; a deterministic
    replay is bit-identical (every speculation misses)."""
    fs, rs = _run_case(PORT, case, backend)
    fp, rp = _run_case(PORT, case, backend, pipeline=True, pipeline_depth=1)
    for j in range(case["q"]):
        name = str(j)
        assert rp[name].allocations == rs[name].allocations
        assert rp[name].converged == rs[name].converged
        assert sum(rp[name].allocations) == case["jobs"][j]["n"]
    assert _session(fp, rp, case["q"]) == _session(fs, rs, case["q"])
    assert fp.rounds <= fs.rounds + 2
    if fp.rounds >= 4:  # long enough for the stale generation to exist
        assert fp.stale_reads + fp.speculative_misses > 0
    _check_against_reference(case, backend, fp, rp, jax_counts, pipeline=True, pipeline_depth=1)


# ---------------------------------------------------------------------------
# depth 0 == sync, depth 1 bounded, bit for bit against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
def test_depth0_bit_identical_to_sync_smoke(backend):
    rng = np.random.default_rng(900 if backend == "torch" else 901)
    for k in range(4):
        _check_depth0_identity(_random_fleet_case(rng), backend, jax_counts=k < 2)


@pytest.mark.parametrize("backend", BACKENDS)
def test_bounded_staleness_smoke(backend):
    rng = np.random.default_rng(910 if backend == "torch" else 911)
    for k in range(4):
        _check_bounded_staleness(_converging_case(rng), backend, jax_counts=k < 2)


@pytest.mark.slow
@pytest.mark.parametrize("backend,seed", [("numpy", 902), ("torch", 903)])
def test_depth0_bit_identity_fuzz_lane(backend, seed):
    rng = np.random.default_rng(seed)
    for k in range(200):
        _check_depth0_identity(_random_fleet_case(rng), backend, jax_counts=k % 20 == 0)


@pytest.mark.slow
@pytest.mark.parametrize("backend,seed", [("numpy", 912), ("torch", 913)])
def test_bounded_staleness_fuzz_lane(backend, seed):
    rng = np.random.default_rng(seed)
    for k in range(200):
        _check_bounded_staleness(_converging_case(rng), backend, jax_counts=k % 20 == 0)


def test_staleness_bound_never_exceeds_one_generation():
    """The carry a pipelined repartition may read is never more than ONE
    fold generation behind the newest, after every round, and the
    speculative machinery (pre-dispatch + validation) ran."""
    case = _converging_case(np.random.default_rng(914))
    fleet = _mk_fleet(PORT, case, "torch", pipeline=True, pipeline_depth=1)
    ex = _mk_ex(PORT, case)
    gaps = []
    for _ in range(10):
        if not fleet.active_jobs:
            break
        fleet.step(ex)
        if fleet._stacked_stale is not None:
            gaps.append(fleet._stacked.generation - fleet._stacked_stale.generation)
    assert gaps and all(0 <= g <= 1 for g in gaps)
    assert fleet.stale_reads + fleet.speculative_misses > 0
    assert fleet.predispatches > 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_speedstore_fold_generation_counter(backend):
    store = SpeedStore.empty(3, backend=backend, device="cpu")
    assert store.fold_generation == 0
    store.fold_in([4, 5, 6], [0.1, 0.2, 0.3])
    assert store.fold_generation == 1
    store.fold_in([8, 9, 10], [0.2, 0.3, 0.4])
    assert store.fold_generation == 2


# ---------------------------------------------------------------------------
# Genuine stale acceptance: the rounds where speculation wins
# ---------------------------------------------------------------------------


def _serving_session(pkg, backend, pipeline):
    p = 5
    kw = dict(pipeline=True, pipeline_depth=1) if pipeline else {}
    fl = pkg.fleet(p, backend=backend, **kw)
    for j, n in enumerate((300, 500)):
        sm, _ = _energy_fixtures(p, 20 + j, pkg.fpm, pkg.emodel)
        fl.admit(pkg.spec(str(j), n), models=sm)
    epoch = {"0": [0.2 * (i + 1) for i in range(p)]}
    first = fl.rebalance()
    fl.observe(epoch)
    second = fl.rebalance()
    if pipeline:
        fl.drain()
    third = fl.rebalance()
    return fl, [first, second, third]


@pytest.mark.parametrize("backend", BACKENDS)
def test_serving_rebalance_cycle_accepts_stale_read(backend):
    """The serving epoch (observe -> rebalance on preloaded estimates):
    the torch fleet consumes the pre-dispatched stale partition as the
    reference's jax fleet does (the numpy fleets, whose unobserved tenant
    has no snapshot, partition fresh); a drained fresh rebalance equals the
    sync fleet's post-fold answer."""
    sync, ds_sync = _serving_session(PORT, backend, False)
    pipe, ds_pipe = _serving_session(PORT, backend, True)
    with jax.enable_x64(True):
        ref, ds_ref = _serving_session(REF, _ref_backend(backend), True)
    assert ds_pipe == ds_ref
    assert _counts(pipe, SPEC_COUNTERS + DEVICE_COUNTERS) == _counts(ref, SPEC_COUNTERS + DEVICE_COUNTERS)
    assert ds_pipe[0] == ds_sync[0] and ds_pipe[2] == ds_sync[1]
    assert pipe.stale_reads == (1 if backend == "torch" else 0)
    for nm, d in ds_pipe[1].items():
        assert sum(d) == pipe._jobs[nm].spec.n


@pytest.mark.parametrize("backend", BACKENDS)
def test_resize_after_convergence_accepts_stale_and_reconverges(backend):
    """A fleet-wide resize clears every seen set, so the next round's
    speculative partition is consumable; the re-run converges from
    one-generation-old estimates within eps, as in the reference."""
    rng = np.random.default_rng(915)
    p, q = 4, 2
    base, knee = _knee_params(rng, q, p)

    def session(pkg, backend):
        ex = pkg.ex(time_fn_batch_2d=_batch_fn(base, knee), p=p, q=q, job_names=[str(j) for j in range(q)])
        fleet = pkg.fleet(p, backend=backend, pipeline=True, pipeline_depth=1)
        for j in range(q):
            fleet.admit(pkg.spec(name=str(j), n=60 + 40 * j, eps=0.15, min_units=1, max_iter=20))
        fleet.run(ex)
        fleet.resize("0", n=77)
        fleet.resize("1", n=131)
        pre = fleet.stale_reads
        res = fleet.run(ex)
        return fleet, pre, {k: (v.allocations, v.converged, v.diagnostics["history"]) for k, v in res.items()}

    fleet, pre, res = session(PORT, backend)
    with jax.enable_x64(True):
        ref, _, ref_res = session(REF, _ref_backend(backend))
    assert fleet.stale_reads > pre
    assert sum(res["0"][0]) == 77 and sum(res["1"][0]) == 131
    assert res["0"][1] and res["1"][1]
    assert res == ref_res
    assert _counts(fleet, SPEC_COUNTERS + DEVICE_COUNTERS) == _counts(ref, SPEC_COUNTERS + DEVICE_COUNTERS)


# ---------------------------------------------------------------------------
# Deterministic interleaving enumeration (the fold_ready_hook seam)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
def test_every_fold_vs_partition_interleaving_reaches_sync_fixed_point(backend):
    """Every schedule in {fold-first, partition-first}^4 produces sync's
    results bit for bit within <= 2 extra rounds, with the reference's
    counters for the same schedule."""
    case = _converging_case(np.random.default_rng(920))
    R = 4
    fs, rs = _run_case(PORT, case, backend)
    for schedule in itertools.product([False, True], repeat=R):
        runs = []
        for pkg, bk in ((PORT, backend), (REF, "numpy")):
            with jax.enable_x64(True):
                fleet = _mk_fleet(pkg, case, bk, pipeline=True, pipeline_depth=1)
                fleet.fold_ready_hook = lambda s=schedule, f=fleet: s[min(f.rounds, R - 1)]
                runs.append((fleet, fleet.run(_mk_ex(pkg, case))))
        (fleet, rp), (ref, _) = runs
        assert _session(fleet, rp, case["q"]) == _session(fs, rs, case["q"]), schedule
        assert fleet.rounds <= fs.rounds + 2, schedule
        assert _counts(fleet, SPEC_COUNTERS) == _counts(ref, SPEC_COUNTERS), schedule
        assert fleet.predispatches == 0  # the seam disables the pre-dispatch
        if all(schedule):
            assert fleet.stale_reads == 0 and fleet.speculative_misses == 0


# ---------------------------------------------------------------------------
# Mid-flight admit / retire / resize under the pipeline
# ---------------------------------------------------------------------------


def _membership_script(pkg, backend, depth, eps, max_iter, **kw):
    rng = np.random.default_rng(930 if depth == 0 else 931)
    p, q = 4, 3
    base, knee = _knee_params(rng, q, p)
    specs = [pkg.spec(name=str(j), n=40 + 30 * j, eps=eps, min_units=1, max_iter=max_iter) for j in range(q)]
    ex = pkg.ex(time_fn_batch_2d=_batch_fn(base, knee), p=p, q=q, job_names=[str(j) for j in range(q)])
    with jax.enable_x64(True):
        fleet = pkg.fleet(p, backend=backend, **kw)
        fleet.admit(specs[0])
        fleet.step(ex)
        fleet.step(ex)
        fleet.admit(specs[1])  # restack: the pipeline must discard its work
        fleet.step(ex)
        fleet.admit(specs[2])
        fleet.step(ex)
        retired = fleet.retire("1")
        fleet.resize("0", n=specs[0].n + 17)
        results = fleet.run(ex)
    view = {nm: (results[nm].allocations, results[nm].times, results[nm].converged,
                 results[nm].diagnostics["history"], fleet.bench_cost(nm)) for nm in ("0", "2")}
    return fleet, retired, view


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("depth", [0, 1])
def test_pipeline_membership_changes_match_sync_and_reference(backend, depth):
    """Staggered admits, a retire and a resize: depth 0 is bit-identical to
    sync; depth 1's deterministic replay is too (every speculation misses),
    and the pre-dispatched partition is never served across a restack.
    Counters equal the reference's on the same script."""
    eps, max_iter = (0.05, 8) if depth == 0 else (0.1, 20)
    _, ret_s, sync = _membership_script(PORT, backend, depth, eps, max_iter)
    fleet, ret_p, pipe = _membership_script(PORT, backend, depth, eps, max_iter,
                                            pipeline=True, pipeline_depth=depth)
    ref, ret_r, _ = _membership_script(REF, _ref_backend(backend), depth, eps, max_iter,
                                       pipeline=True, pipeline_depth=depth)
    assert pipe == sync
    assert ret_p.allocations == ret_s.allocations
    assert ret_p.diagnostics["history"] == ret_s.diagnostics["history"]
    assert 0 < len(ret_p.diagnostics["history"]) <= 4
    assert sum(pipe["0"][0]) == 40 + 17 and sum(pipe["2"][0]) == 100
    keys = SPEC_COUNTERS + (DEVICE_COUNTERS if backend == "torch" else ())
    assert _counts(fleet, keys) == _counts(ref, keys)
    if depth == 1:
        assert fleet.stale_reads == 0 and fleet.speculative_misses > 0
    assert (fleet.predispatches > 0) == (backend == "torch")


# ---------------------------------------------------------------------------
# state_dict round-trip while a round is in flight
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend,pipeline", [("torch", False), ("torch", True), ("numpy", True)])
def test_state_dict_roundtrip_mid_flight(backend, pipeline):
    """Checkpointing with work in flight (a pending fold generation, a
    pre-dispatched partition) drains the pipeline and serializes a state
    whose restore continues bit-identically to the donor."""
    case = _converging_case(np.random.default_rng(940))
    kw = dict(pipeline=True, pipeline_depth=1) if pipeline else {}
    donor = _mk_fleet(PORT, case, backend, **kw)
    ex = _mk_ex(PORT, case)
    for _ in range(3):
        donor.step(ex)
    if pipeline and backend == "torch":
        assert donor._predispatched is not None  # genuinely mid-pipeline
    state = json.loads(json.dumps(donor.state_dict()))  # JSON-safe
    assert state["config"]["pipeline"] == bool(pipeline)
    assert donor._predispatched is None and donor._stacked_stale is None
    restored = FleetScheduler.from_state(state, device="cpu")
    assert restored.pipeline == bool(pipeline)
    res_a = donor.run(ex)
    res_b = restored.run(_mk_ex(PORT, case))
    for j in range(case["q"]):
        name = str(j)
        assert res_a[name].allocations == res_b[name].allocations
        assert res_a[name].diagnostics["history"] == res_b[name].diagnostics["history"]
        assert res_a[name].converged == res_b[name].converged


# ---------------------------------------------------------------------------
# quantize= x lane_buckets=True x pipeline composed
# ---------------------------------------------------------------------------


def _quantized_case():
    rng = np.random.default_rng(951)
    p, q = 4, 3
    base, knee = _knee_params(rng, q, p)
    return dict(p=p, q=q, base=base, knee=knee,
                jobs=[dict(n=50 + 30 * j, eps=0.05, caps=None, min_units=1, max_iter=6) for j in range(q)])


def test_quantize_lane_buckets_pipeline_composed():
    """Quantized folds + padded buckets + a depth-0 pipeline stay
    bit-identical to the plain quantized sync fleet, and the masked dummy
    lane's rows stay untouched through every double-buffered fold."""
    case = _quantized_case()
    q = case["q"]
    fs, rs = _run_case(PORT, case, "torch", quantize=0.05)
    fleet = _mk_fleet(PORT, case, "torch", quantize=0.05, lane_buckets=True, pipeline=True, pipeline_depth=0)
    stacked = fleet._ensure_stack()
    snap = [t[q:].clone() for t in (stacked.counts, stacked.xs, stacked.ss)]
    rp = fleet.run(_mk_ex(PORT, case))
    assert int(fleet._stacked.counts.shape[0]) == 4
    assert torch.equal(fleet._stacked.counts[q:], snap[0])
    kv = int(snap[0].max())
    assert torch.equal(fleet._stacked.xs[q:, :, :kv], snap[1][..., :kv])
    assert torch.equal(fleet._stacked.ss[q:, :, :kv], snap[2][..., :kv])
    assert _session(fleet, rp, q) == _session(fs, rs, q)
    assert fleet.predispatches > 0
    _check_against_reference(case, "torch", fleet, rp, quantize=0.05, lane_buckets=True,
                             pipeline=True, pipeline_depth=0)


# ---------------------------------------------------------------------------
# Power cap + hierarchy routes under the pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
def test_pipeline_power_cap_reads_consistent_generation(backend):
    """A power cap forces every priced repartition onto the newest carry:
    the capped pipeline fleet matches the capped sync fleet bit for bit and
    never counts a stale read."""
    p = 5

    def build(pkg, bk, pipeline):
        kw = dict(pipeline=True, pipeline_depth=1) if pipeline else {}
        fl = pkg.fleet(p, backend=bk, power_cap=50.0, **kw)
        for j, n in enumerate((300, 500)):
            sm, em = _energy_fixtures(p, 10 + j, pkg.fpm, pkg.emodel)
            fl.admit(pkg.spec(str(j), n), models=sm, energy_models=em)
        return fl

    def cycle(fl):
        first = fl.rebalance()
        fl.observe({"0": [0.1 * (i + 1) for i in range(p)]})
        return [first, fl.rebalance()]

    sync, pipe = build(PORT, backend, False), build(PORT, backend, True)
    assert cycle(sync) == cycle(pipe)
    with jax.enable_x64(True):
        ref = build(REF, _ref_backend(backend), True)
        cycle(ref)
    assert pipe.stale_reads == 0 and pipe.predispatches == 0
    assert _counts(pipe, SPEC_COUNTERS + DEVICE_COUNTERS) == _counts(ref, SPEC_COUNTERS + DEVICE_COUNTERS)


class _FleetExec:
    def __init__(self, p, seed=3):
        r = np.random.default_rng(seed)
        self.base = r.uniform(5.0, 50.0, size=p)
        self.bend = r.uniform(50, 400, size=p)
        self.num_procs = p

    def run_jobs(self, names, D):
        D = np.asarray(D, dtype=np.float64)
        s = self.base * (1.0 + 0.3 * np.minimum(D, self.bend) / self.bend)
        return np.where(D > 0, D / s, 0.0)


@pytest.mark.parametrize("backend", BACKENDS)
def test_pipeline_hier_route_matches_sync(backend):
    """The two-level route reads per-job host snapshots: depth 0 and depth
    1 (every speculation misses) equal sync, and the counters equal the
    reference numpy fleet's on the same rounds."""
    p = 8
    groups = [i % 2 for i in range(p)]

    def run(pkg, bk, **kw):
        with jax.enable_x64(True):
            fs = pkg.fleet(p, backend=bk, groups=groups, **kw)
            fs.admit(pkg.spec(name="a", n=500, eps=0.05, max_iter=8))
            fs.admit(pkg.spec(name="b", n=700, eps=0.05, max_iter=8))
            res = fs.run(_FleetExec(p), max_rounds=10)
        return fs, {k: (v.allocations, v.diagnostics["history"]) for k, v in res.items()}

    _, sync = run(PORT, backend)
    _, d0 = run(PORT, backend, pipeline=True, pipeline_depth=0)
    f1, d1 = run(PORT, backend, pipeline=True, pipeline_depth=1)
    r1, ref1 = run(REF, "numpy", pipeline=True, pipeline_depth=1)
    assert sync == d0 == d1 == ref1
    assert _counts(f1, SPEC_COUNTERS) == _counts(r1, SPEC_COUNTERS)
    assert f1.speculative_misses > 0 and f1.predispatches == 0


# ---------------------------------------------------------------------------
# DelayedBatchedExecutor: the reproducible async double
# ---------------------------------------------------------------------------


def test_delayed_executor_preserves_times_and_fleet_parity():
    case = _converging_case(np.random.default_rng(960))
    lat = {str(j): 0.5 * j for j in range(case["q"])}
    fs, rs = _run_case(PORT, case, "torch", pipeline=True, pipeline_depth=1)
    fleet = _mk_fleet(PORT, case, "torch", pipeline=True, pipeline_depth=1)
    wrapped = DelayedBatchedExecutor(inner=_mk_ex(PORT, case), lane_latency=lat, seed=7)
    rw = fleet.run(wrapped)
    ref_wrapped = RefDelayedExecutor(inner=_mk_ex(REF, case), lane_latency=lat, seed=7)
    ref = _mk_fleet(REF, case, "numpy", pipeline=True, pipeline_depth=1)
    ref_res = ref.run(ref_wrapped)
    for j in range(case["q"]):
        name = str(j)
        assert rw[name].allocations == rs[name].allocations
        assert rw[name].times == rs[name].times
        assert rw[name].diagnostics["history"] == rs[name].diagnostics["history"]
    # the wrapper has no alpha/beta of its own, in either package
    assert _session(fleet, rw, case["q"]) == _session(ref, ref_res, case["q"])
    assert wrapped.completions == ref_wrapped.completions
    assert len(wrapped.completions) > 0 and wrapped.clock == ref_wrapped.clock > 0.0


def test_delayed_executor_seeded_reproducibility_and_straggler_order():
    rng = np.random.default_rng(961)
    p, q = 4, 3
    base, knee = _knee_params(rng, q, p)
    names = [str(j) for j in range(q)]

    def mk(pkg, seed, lat):
        inner = pkg.ex(time_fn_batch_2d=_batch_fn(base, knee), p=p, q=q, job_names=names)
        return pkg.delayed(inner=inner, lane_latency=lat, seed=seed)

    D = [[10, 12, 8, 5]] * q
    straggler = {"0": 0.0, "1": 10.0, "2": 0.0}
    a, b, r = mk(PORT, 0, straggler), mk(PORT, 0, straggler), mk(REF, 0, straggler)
    Ta = np.asarray(a.run_jobs(names, D))
    Tb = np.asarray(b.run_jobs(names, D))
    Tr = np.asarray(r.run_jobs(names, D))
    bare = BatchedSimulatedExecutor2D(time_fn_batch_2d=_batch_fn(base, knee), p=p, q=q, job_names=names)
    assert np.array_equal(Ta, np.asarray(bare.run_jobs(names, D))) and np.array_equal(Ta, Tr)
    assert a.completions == b.completions == r.completions
    assert a.completions[-1][1] == "1"  # straggler observed last
    assert a.clock == a.completions[-1][0]
    # equal latencies: the seeded permutation still fixes the tie-break order
    c, d, e = mk(PORT, 5, None), mk(PORT, 5, None), mk(REF, 5, None)
    for ex in (c, d, e):
        ex.run_jobs(names, [[3, 3, 3, 3]] * q)
    assert c.completions == d.completions == e.completions
    assert a.run([4, 4, 4, 4]) == r.run([4, 4, 4, 4]) and a.completions[-1][1] == "job"


# ---------------------------------------------------------------------------
# The deferred partition: queued on the device, read back only when fetched
# ---------------------------------------------------------------------------


def _rows(rng, p, monotone):
    rows = []
    for _ in range(p):
        xs = np.unique(rng.uniform(1.0, 1e4, int(rng.integers(1, 7))))
        if monotone:
            ss = np.sort(rng.uniform(0.5, 500.0, len(xs)))[::-1]
        else:
            ss = rng.uniform(0.5, 500.0, len(xs))
        rows.append(list(zip(xs.tolist(), ss.tolist())))
    return rows


def _bank(rows):
    return TorchModelBank.from_bank(
        ModelBank.from_models([PiecewiseLinearFPM.from_points(r) for r in rows]), device="cpu")


def _stacked_case(seed):
    """A stacked bank mixing monotone and non-monotone lanes, with per-lane
    n (one lane n = 0), min_units (overshooting on some lanes) and caps
    (tight on some lanes, 0 on a row of another)."""
    rng = np.random.default_rng(seed)
    p, q = int(rng.integers(3, 9)), 4
    stacked = TorchModelBank.stack([_bank(_rows(rng, p, j % 2 == 0)) for j in range(q)])
    ns = np.array([int(rng.integers(2 * p, 2000)) for _ in range(q)])
    ns[1], ns[3] = 4 * p, 0  # lane 1: 3 units a row pushes slow rows up
    mu = np.array([0, 3, 1, 0])
    caps = np.full((q, p), 10**6, dtype=np.int64)
    caps[2] = np.maximum(mu[2], (ns[2] // p) + 2)  # tight: the caps bind
    caps[0, 0] = 0  # a zero-cap row
    return stacked, ns, mu, caps


def _both(stacked, ns, **kw):
    """``(sync, deferred)`` outcomes: results, or the exception raised."""
    out = []
    for defer in (False, True):
        try:
            r = stacked.partition_units(ns, defer=defer, **kw)
            out.append(fetch_partition(r) if defer else r)
        except (ValueError, RuntimeError) as exc:
            out.append((type(exc), str(exc)))
    return out


def _same(a, b):
    if isinstance(a, tuple) and isinstance(a[0], type):
        return a == b
    if isinstance(a, tuple):
        return all(np.array_equal(x, y) for x, y in zip(a, b))
    return np.array_equal(a, b)


@pytest.fixture
def no_readback(monkeypatch):
    """Patch every device-to-host read of a tensor to raise while the
    ``with`` block runs."""
    import contextlib

    def boom(*_a, **_k):
        raise AssertionError("a device-to-host read inside the deferred partition")

    @contextlib.contextmanager
    def guard():
        with monkeypatch.context() as m:
            for name in ("__bool__", "__int__", "__float__", "__index__", "item", "tolist", "cpu", "numpy"):
                m.setattr(torch.Tensor, name, boom)
            yield

    return guard


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("completion", ["auto", "threshold", "greedy"])
def test_deferred_partition_reads_nothing_and_equals_sync(seed, completion, no_readback):
    """On a stacked CPU bank — monotone and non-monotone lanes, a
    ``min_units`` overshoot, tight caps, a zero-cap row, an n = 0 lane, and
    a carry after ``fold_in`` whose monotone flags are unknown — the
    deferred call makes no read before ``fetch_partition``, and its
    allocations and ``t*`` equal the sync call's bit for bit."""
    stacked, ns, mu, caps = _stacked_case(seed)
    kw = dict(caps=caps, min_units=mu, completion=completion, with_t=True)
    want = stacked.partition_units(ns, **kw)
    with no_readback():
        deferred = stacked.partition_units(ns, defer=True, **kw)
    assert _same(fetch_partition(deferred), want)
    # after a fold the host no longer knows the lanes' monotonicity: the
    # "auto" routing is computed on the device
    q, p = caps.shape
    rng = np.random.default_rng(seed)
    folded = stacked.fold_in(rng.uniform(1.0, 1e4, (q, p)), rng.uniform(0.5, 500.0, (q, p)), donate=False)
    assert folded.monotone is None and folded.monotone_cols is None
    lanes, auto = np.array([True, False, False, True]), np.array([False, True, True, False])
    with no_readback():
        deferred = folded.partition_units(ns, defer=True, completion_lanes=lanes, auto_lanes=auto, **kw)
    got = fetch_partition(deferred)
    want = folded.partition_units(ns, completion_lanes=lanes, auto_lanes=auto, **kw)
    assert _same(got, want)
    assert _same(got, folded.partition_units(
        ns, completion_lanes=np.where(auto, folded.monotone_lanes(), lanes), **kw))


def test_deferred_partition_raises_what_sync_raises(no_readback):
    """Infeasible inputs raise the sync call's errors: host checks at the
    call, the integer completion's and an empty FPM's at the fetch."""
    stacked, ns, mu, caps = _stacked_case(3)
    q, p = caps.shape
    for kw in (
        dict(caps=np.ones((q, p), dtype=np.int64)),  # sum(caps) < n
        dict(min_units=np.array([ns[0], 0, 0, 0])),  # min_units * p > n
        dict(caps=np.full((q, p), 2, dtype=np.int64), min_units=mu),  # cap < min_units
    ):
        sync, deferred = _both(stacked, ns, **kw)
        assert isinstance(sync, tuple) and sync == deferred
    empty = TorchModelBank.stack([_bank([[(1.0, 1.0)]] * p), _bank([[(2.0, 3.0)]] * p)])
    empty = empty.fold_in(np.ones((2, p)), np.ones((2, p)), donate=False)
    empty.counts[1, 0] = 0  # an empty row the host mirror does not know of
    empty.empty_rows = None
    with no_readback():
        deferred = empty.partition_units([5 * p, 5 * p], defer=True)
    with pytest.raises(ValueError, match="empty FPM"):
        fetch_partition(deferred)
    with pytest.raises(ValueError, match="empty FPM"):
        empty.partition_units([5 * p, 5 * p])


@pytest.mark.parametrize("seed", range(40))
def test_greedy_leftover_stays_within_the_host_bound(seed, monkeypatch):
    """The proof in ``_partition_units_fixed``: after the floor and the
    take-back, the leftover the greedy completes is at most the number of
    rows with positive caps — observed on the sync program over random
    banks, ``min_units`` overshoots, zero-cap rows and tight caps."""
    seen = []
    real = mbt._complete_greedy

    def spy(xs, ss, counts, caps_i, d, rem, leftover):
        seen.append((int(leftover.max()), int((caps_i > 0).sum(dim=-1).max())))
        return real(xs, ss, counts, caps_i, d, rem, leftover)

    monkeypatch.setattr(mbt, "_complete_greedy", spy)
    stacked, ns, mu, caps = _stacked_case(100 + seed)
    for completion in ("greedy", "threshold"):
        stacked.partition_units(ns, caps=caps, min_units=mu, completion=completion)
    assert seen and all(0 <= left <= bound for left, bound in seen)
    assert any(left > 0 for left, _ in seen)


def test_deferred_tripwire_raises_when_the_bound_is_broken(monkeypatch):
    """``fetch_partition`` refuses a deferred result whose completion left
    units unplaced (here: the greedy bound forced to 0)."""
    stacked, ns, mu, caps = _stacked_case(5)
    real = mbt._partition_units_fixed

    def short(*args):
        return real(*args[:-1], 0)

    monkeypatch.setattr(mbt, "_partition_units_fixed", short)
    with pytest.raises(RuntimeError, match="unplaced"):
        fetch_partition(stacked.partition_units(ns, caps=caps, min_units=mu, completion="greedy", defer=True))


# ---------------------------------------------------------------------------
# chip_smoke.py's part (d): the numbers it holds on the card
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke():
    import importlib.util
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_pipeline_pins_are_the_reference_counts(smoke):
    """``FLEET_PIPELINE_DEPTH0`` / ``FLEET_PIPELINE_DEPTH1`` are what the
    reference's jax fleet counts on ``parity_gate``'s case under the
    pipeline."""
    q, p, seed = (smoke.FLEET_PARITY[k] for k in ("q", "p", "seed"))
    batch_fn, _, ns = smoke.fleet_knee_case(q, p, seed)
    names = [f"t{j}" for j in range(q)]
    for depth, pins in ((0, smoke.FLEET_PIPELINE_DEPTH0), (1, smoke.FLEET_PIPELINE_DEPTH1)):
        with jax.enable_x64(True):
            ref = ref_fleet.FleetScheduler(p, backend="jax", pipeline=True, pipeline_depth=depth)
            for nm, n in zip(names, ns):
                ref.admit(ref_fleet.JobSpec(name=nm, n=n, eps=smoke.FLEET_EPS, min_units=1,
                                            max_iter=smoke.FLEET_MAX_ITER))
            ref.run(RefExecutor2D(time_fn_batch_2d=batch_fn, p=p, q=q, job_names=names))
        assert {k: ref.stats()[k] for k in pins} == pins


def test_chip_smoke_pipeline_gate_holds_on_the_host(smoke):
    """Part (d)'s parity gate, with the carry on the CPU."""
    row = smoke.fleet_pipeline_gate("cpu")
    assert all(row["checks"].values()), row
