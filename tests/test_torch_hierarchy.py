"""The port's two-level partitioner held against the reference's.

``repro_torch.core.hierarchy.Hierarchy`` on both backends (``"numpy"`` on
the host, ``"torch"`` with the device bank in float64 on the CPU) against
the reference's numpy ``Hierarchy`` on the same banks.  The cases are
``tests/test_hierarchy.py``'s, drawn from the same seeds; that file does
not collect on this toolchain (its module imports
``jax.experimental.enable_x64``), so its numpy-lane cases are copied here.

Contract:

* allocations and ``t_outer`` are bit-identical to the reference's numpy
  path on both backends, and so is the aggregate group bank (the torch
  backend evaluates it on the device);
* a single group is bit-identical to the flat partition;
* multiple groups stay within 1.12x the flat makespan on monotone banks
  (the reference's fuzz tolerance);
* validation raises the flat paths' messages;
* ``Scheduler(groups=...)`` routes ``partition`` and ``observe`` through
  the hierarchy while the rounds of ``autotune`` repartition flat, as the
  reference's do, and a reference state with groups continues in the
  port.
"""

import numpy as np
import pytest
import torch

from repro.core import Scheduler as RefScheduler
from repro.core import SimulatedExecutor as RefSimulatedExecutor
from repro.core import SpeedStore as RefSpeedStore
from repro.core.fpm import PiecewiseLinearFPM as RefFPM
from repro.core.hierarchy import Hierarchy as RefHierarchy
from repro.core.modelbank import ModelBank as RefBank
from repro.core.modelbank import aggregate_groups as ref_aggregate_groups

from repro_torch.core import (
    Hierarchy,
    ModelBank,
    Policy,
    Scheduler,
    SimulatedExecutor,
    SpeedStore,
    TorchModelBank,
    aggregate_groups,
)
from repro_torch.core.modelbank_torch import np_order_sum, ragged_order_sum
from repro_torch.core.partition import _partition_units_bank

BACKENDS = ("numpy", "torch")


# ---------------------------------------------------------------------------
# Random banks (tests/test_hierarchy.py's generators) and the makespan oracle
# ---------------------------------------------------------------------------


def _random_points(rng, p, kmax=5, monotone=True):
    """Per-row random piecewise models; ``monotone=True`` draws increasing
    knot times, else free speeds."""
    pts = []
    for _ in range(p):
        k = int(rng.integers(1, kmax + 1))
        xs = np.unique(np.round(rng.uniform(1.0, 200.0, k), 3))
        if monotone:
            ts = np.sort(rng.uniform(0.1, 10.0, len(xs)))
            ss = xs / ts
        else:
            ss = rng.uniform(0.5, 20.0, len(xs))
        pts.append((list(xs), list(ss)))
    return pts


def _banks(pts):
    return ModelBank.from_point_lists(pts), RefBank.from_point_lists(pts)


def _makespan(bank, d):
    d = np.asarray(d, dtype=np.float64)
    t = bank.time(np.maximum(d, 1.0))
    return float(np.max(np.where(d > 0, t, 0.0)))


def _random_case(rng, p_hi=40):
    p = int(rng.integers(2, p_hi))
    g = int(rng.integers(1, min(p, 8) + 1))
    groups = rng.integers(0, g, size=p).tolist()
    pts = _random_points(rng, p, monotone=bool(rng.random() < 0.7))
    n = int(rng.integers(30 * p, 120 * p))
    min_units = int(rng.integers(0, 2))
    caps = None
    if rng.random() < 0.35:
        lo = max(1, min_units)
        caps = [lo + int(f * n) for f in rng.uniform(0.6, 1.0, p)]
    return dict(pts=pts, groups=groups, n=n, min_units=min_units, caps=caps)


def _hier(bank, groups, backend, **kw):
    return Hierarchy.from_bank(bank, groups, backend=backend, device="cpu", **kw)


def _check_against_reference(case, tol=0.12):
    """Both port backends against the reference's numpy hierarchy: the
    same allocations and t_outer, bit for bit; then the reference's own
    structural and makespan checks."""
    bank, ref_bank = _banks(case["pts"])
    groups, n, mu, caps = case["groups"], case["n"], case["min_units"], case["caps"]
    want, t_want = RefHierarchy.from_bank(ref_bank, groups).partition_units(
        n, caps, min_units=mu, with_t=True
    )
    d_flat, _ = _partition_units_bank(bank, n, caps if caps is not None else [n] * bank.p, min_units=mu)
    icaps = caps if caps is not None else [n] * bank.p
    for backend in BACKENDS:
        got, t_got = _hier(bank, groups, backend).partition_units(n, caps, min_units=mu, with_t=True)
        assert got == want, backend
        assert t_got == t_want, backend
        assert sum(got) == n
        assert all(0 <= v <= c for v, c in zip(got, icaps))
        assert all(v >= mu for v in got)
    if bank.is_monotone():
        assert _makespan(bank, want) <= _makespan(bank, d_flat) * (1.0 + tol) + 1e-12
    if len(set(groups)) == 1:
        assert want == [int(v) for v in d_flat]
    return want


# ---------------------------------------------------------------------------
# Parity with the reference
# ---------------------------------------------------------------------------


def test_hier_smoke_fuzz_matches_reference():
    rng = np.random.default_rng(201)
    for _ in range(25):
        _check_against_reference(_random_case(rng))


@pytest.mark.slow
def test_hier_fuzz_lane_matches_reference():
    rng = np.random.default_rng(210)
    for _ in range(200):
        _check_against_reference(_random_case(rng))


@pytest.mark.parametrize("backend", BACKENDS)
def test_single_group_bit_identical_to_flat(backend):
    rng = np.random.default_rng(203)
    bank, _ = _banks(_random_points(rng, 23))
    n = 907
    d_flat, _ = _partition_units_bank(bank, n, [n] * bank.p, min_units=0)
    d_dev = TorchModelBank.from_bank(bank, device="cpu").partition_units(n)
    assert [int(v) for v in d_dev] == [int(v) for v in d_flat]
    assert _hier(bank, [0] * bank.p, backend).partition_units(n) == [int(v) for v in d_flat]


def test_nonmonotone_group_demotes_only_itself():
    """One group's time function drops past a knee (its observed speed
    jumps): auto equals the exact greedy completion, and the torch
    per-group routing equals numpy's, while the monotone group keeps the
    threshold completion."""
    rng = np.random.default_rng(206)
    good = _random_points(rng, 12, monotone=True)
    bad = [([10.0, 50.0, 60.0], [s, s, 10.0 * s]) for s in rng.uniform(2.0, 8.0, 6)]
    bank, ref_bank = _banks(good + bad)
    assert bank.is_monotone() is False
    groups = [0] * len(good) + [1] * len(bad)
    assert [_hier(bank, groups, "numpy").sub_banks[i].is_monotone() for i in (0, 1)] == [True, False]
    n = 1500
    d_auto_np = _hier(bank, groups, "numpy").partition_units(n)
    d_greedy_np = _hier(bank, groups, "numpy").partition_units(n, completion="greedy")
    d_auto_t = _hier(bank, groups, "torch").partition_units(n)
    d_greedy_t = _hier(bank, groups, "torch").partition_units(n, completion="greedy")
    assert d_auto_np == d_greedy_np == d_auto_t == d_greedy_t
    assert d_auto_np == RefHierarchy.from_bank(ref_bank, groups).partition_units(n)
    assert sum(d_auto_np) == n


def _agg_cases():
    rng = np.random.default_rng(209)
    for _ in range(6):
        p = int(rng.integers(8, 60))
        g = int(rng.integers(1, 6))
        pts = _random_points(rng, p, monotone=bool(rng.random() < 0.7))
        groups = rng.integers(0, g, size=p).tolist()
        n = int(rng.integers(30 * p, 120 * p))
        caps = [1 + int(f * n) for f in rng.uniform(0.3, 1.0, p)] if rng.random() < 0.5 else None
        yield pts, groups, n, caps


def test_aggregate_bank_matches_reference():
    """The group bank: the port's host ``aggregate_groups`` and the torch
    hierarchy's device aggregation both equal the reference's, array for
    array."""
    for pts, groups, n, caps in _agg_cases():
        bank, ref_bank = _banks(pts)
        caps_f = np.full(bank.p, float(n)) if caps is None else np.asarray(caps, dtype=np.float64)
        gbank, gcaps, members = aggregate_groups(bank, groups, caps_f)
        want, want_caps, want_members = ref_aggregate_groups(ref_bank, groups, caps_f)
        for name in ("xs", "ss", "counts"):
            np.testing.assert_array_equal(getattr(gbank, name), getattr(want, name))
        np.testing.assert_array_equal(gcaps, want_caps)
        assert all(np.array_equal(a, b) for a, b in zip(members, want_members))

        ref_h = RefHierarchy.from_bank(ref_bank, groups)
        ref_h.partition_units(n, caps)
        (ref_gbank,) = ref_h._agg_cache.values()
        for backend in BACKENDS:
            h = _hier(bank, groups, backend)
            h.partition_units(n, caps)
            (got,) = h._agg_cache.values()
            for name in ("xs", "ss", "counts"):
                np.testing.assert_array_equal(getattr(got, name), getattr(ref_gbank, name), err_msg=backend)


def test_aggregate_falls_back_to_the_host_above_budget(monkeypatch):
    """Past the device budget (or on float32 blocks) the torch hierarchy
    aggregates on the host and still gives the same group bank."""
    import repro_torch.core.hierarchy as hier_mod

    pts, groups, n, caps = next(_agg_cases())
    bank, _ = _banks(pts)
    want = _hier(bank, groups, "numpy")
    want.partition_units(n, caps)
    monkeypatch.setattr(hier_mod, "_AGG_DEVICE_MAX_BYTES", 0)
    h = _hier(bank, groups, "torch")
    caps_f = np.full(bank.p, np.inf) if caps is None else np.asarray(caps, dtype=np.float64)
    assert h._aggregate_pts_device(caps_f) is None
    assert h.partition_units(n, caps) == want.partition_units(n, caps)
    for a, b in zip(h._agg_cache.values(), want._agg_cache.values()):
        np.testing.assert_array_equal(a.xs, b.xs)
        np.testing.assert_array_equal(a.ss, b.ss)


def test_ragged_order_sum_is_numpy_sum_of_each_unpadded_row():
    """The inner solve's float sums: each lane summed over its own length
    in numpy's order equals ``np.sum`` of the unpadded row, where the sum
    of the zero-padded row does not (the tree depends on the length)."""
    rng = np.random.default_rng(216)
    lens = [1, 7, 150, 200, 257, 300]
    x = np.zeros((len(lens), 300))
    for i, v in enumerate(lens):
        x[i, :v] = rng.standard_normal(v) * np.exp(rng.uniform(0.0, 30.0, v))
    want = np.array([np.sum(x[i, :v]) for i, v in enumerate(lens)])
    got = ragged_order_sum(lens, "cpu")(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.any(np_order_sum(torch.from_numpy(x)).numpy() != want)
    assert ragged_order_sum([300] * 3, "cpu") is np_order_sum


def test_ragged_groups_sum_in_each_groups_own_order():
    """Groups of different sizes share one stacked inner program; each
    group's float sums run over its own rows only, so the torch inner
    solves equal the numpy per-group solves on groups of 1, 7 and 300."""
    rng = np.random.default_rng(214)
    pts = _random_points(rng, 308, monotone=True)
    bank, ref_bank = _banks(pts)
    groups = [0] + [1] * 7 + [2] * 300
    n = 40 * 308
    want = RefHierarchy.from_bank(ref_bank, groups).partition_units(n)
    assert _hier(bank, groups, "torch").partition_units(n) == want
    assert _hier(bank, groups, "numpy").partition_units(n) == want


# ---------------------------------------------------------------------------
# Validation, shape, device
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
def test_error_parity_with_flat(backend):
    rng = np.random.default_rng(207)
    bank, _ = _banks(_random_points(rng, 8))
    h = _hier(bank, [0, 0, 1, 1, 2, 2, 3, 3], backend)
    with pytest.raises(ValueError, match="unknown completion mode"):
        h.partition_units(10, completion="bogus")
    with pytest.raises(ValueError, match="n must be non-negative"):
        h.partition_units(-1)
    with pytest.raises(ValueError, match=r"infeasible: sum\(caps\)"):
        h.partition_units(100, [2] * 8)
    with pytest.raises(ValueError, match="min_units=3 infeasible"):
        h.partition_units(10, min_units=3)
    assert h.partition_units(0) == [0] * 8
    # empty FPM row with a positive cap, same message as the flat bank path
    empty = ModelBank.from_point_lists([([1.0], [1.0])] * 4)
    empty.counts = np.array([1, 1, 0, 1])
    with pytest.raises(ValueError, match="empty FPM"):
        _hier(empty, [0, 0, 1, 1], backend).partition_units(4)
    with pytest.raises(ValueError, match="groups must be a length-p"):
        _hier(bank, [0, 1], backend)
    with pytest.raises(ValueError, match="unknown hierarchy backend"):
        Hierarchy.from_bank(bank, [0] * 8, backend="scalar")


def test_max_shard_elems_counts_every_block():
    rng = np.random.default_rng(205)
    banks = [ModelBank.from_point_lists(_random_points(rng, 5, kmax=3)) for _ in range(8)]
    k = max(int(b.xs.shape[1]) for b in banks)
    for backend in BACKENDS:
        h = Hierarchy.from_group_banks(banks, backend=backend, device="cpu")
        assert h.p == 40 and h.g == 8
        assert h.max_shard_elems() == 2 * 8 * 5 * k


def test_from_group_banks_matches_from_bank():
    rng = np.random.default_rng(215)
    parts = [_random_points(rng, p) for p in (4, 9, 6)]
    flat = ModelBank.from_point_lists([r for part in parts for r in part])
    groups = [gi for gi, part in enumerate(parts) for _ in part]
    n = 40 * flat.p
    want = _hier(flat, groups, "numpy").partition_units(n)
    for backend in BACKENDS:
        h = Hierarchy.from_group_banks(
            [ModelBank.from_point_lists(part) for part in parts], backend=backend, device="cpu"
        )
        assert h.partition_units(n) == want


def test_torch_backend_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs a machine without one")
    bank, _ = _banks(_random_points(np.random.default_rng(0), 4))
    with pytest.raises(RuntimeError, match="cuda"):
        Hierarchy.from_bank(bank, [0, 0, 1, 1], backend="torch")


# ---------------------------------------------------------------------------
# Scheduler routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
def test_scheduler_hier_routing(backend):
    rng = np.random.default_rng(208)
    pts = _random_points(rng, 16)
    bank, ref_bank = _banks(pts)
    n = 800

    def store():
        return SpeedStore.from_bank(bank, device="cpu") if backend == "numpy" else SpeedStore(
            None, "torch", tbank=TorchModelBank.from_bank(bank, device="cpu"), device="cpu"
        )

    flat = Scheduler(store(), backend=backend, device="cpu").partition(n)
    hier1 = Scheduler(store(), policy=Policy.HIER, groups=[0] * 16, backend=backend, device="cpu").partition(n)
    assert hier1.allocations == flat.allocations
    groups4 = [i % 4 for i in range(16)]
    hier4 = Scheduler(store(), groups=groups4, backend=backend, device="cpu").partition(n)
    want = RefScheduler(RefSpeedStore.from_bank(ref_bank), groups=groups4).partition(n)
    assert hier4.allocations == want.allocations
    assert hier4.t_star == want.t_star
    assert sum(hier4.allocations) == n
    assert _makespan(bank, hier4.allocations) <= _makespan(bank, flat.allocations) * 1.05

    with pytest.raises(ValueError, match="policy=HIER requires a groups="):
        Scheduler(store(), policy=Policy.HIER, backend=backend, device="cpu")

    s = Scheduler(store(), groups=groups4, backend=backend, device="cpu")
    st = s.state_dict()
    assert st["groups"] == groups4
    s2 = Scheduler.from_state(st, device="cpu")
    assert s2.partition(n).allocations == hier4.allocations
    # mid-flight regrouping
    s2.set_groups([0] * 16)
    assert s2.partition(n).allocations == flat.allocations
    s2.set_groups(None)
    assert s2.partition(n).allocations == flat.allocations
    with pytest.raises(ValueError, match="groups must be a length-p"):
        s2.set_groups([0] * 3)


SPEEDS = [4.0, 3.0, 1.5, 2.0, 2.5, 1.0]
GROUPS = [0, 0, 1, 1, 2, 2]


def _observe_rounds(sched, rounds):
    ds = []
    for _ in range(rounds):
        sched.observe([d / s if d > 0 else 0.0 for d, s in zip(sched.d, SPEEDS)])
        ds.append(list(sched.d))
    return ds


def test_observe_routes_through_the_hierarchy_like_the_reference():
    kw = dict(n_units=120, num_groups=6, eps=0.03, min_units=1, smooth=0.7, groups=GROUPS)
    want = _observe_rounds(RefScheduler(backend="numpy", **kw), 4)
    for backend in BACKENDS:
        assert _observe_rounds(Scheduler(backend=backend, device="cpu", **kw), 4) == want, backend


def test_reference_state_with_groups_continues_in_the_port():
    kw = dict(n_units=120, num_groups=6, eps=0.03, min_units=1, smooth=0.7, groups=GROUPS)
    ref = RefScheduler(backend="numpy", **kw)
    _observe_rounds(ref, 2)
    state = ref.state_dict()
    assert state["groups"] == GROUPS and state["sharding"] is None
    port = Scheduler.from_state(state, device="cpu")
    assert port.groups == GROUPS and port.backend == "numpy"
    on_torch = Scheduler.from_state(state, device="cpu", backend="torch")
    assert _observe_rounds(port, 3) == _observe_rounds(ref, 3)
    ref2 = RefScheduler.from_state(state)
    assert _observe_rounds(on_torch, 3) == _observe_rounds(ref2, 3)

    sharded = dict(state, sharding="shard_map")
    with pytest.raises(NotImplementedError, match="single card"):
        Scheduler.from_state(sharded, device="cpu")


def test_autotune_rounds_repartition_flat_as_the_reference():
    """The DFPA loop keeps the reference's behaviour under ``groups=``: its
    rounds repartition flat (only ``partition`` and ``observe`` route
    through the hierarchy).  Both backends give the reference's numpy
    rounds, and the grouped loop's rounds equal the ungrouped loop's."""
    speeds = [3.0, 3.0, 1.0, 1.0, 2.0, 2.0, 0.5, 0.5]
    groups = [0, 0, 1, 1, 2, 2, 3, 3]
    fns = [(lambda s: lambda r: r / s * (1.0 + 0.002 * r))(s) for s in speeds]
    n, eps, mu = 512, 0.02, 1

    def run(sched, executor):
        return sched.autotune(executor(time_fns=fns), n, eps, min_units=mu, probe_budget=0)

    want = run(RefScheduler(backend="numpy", groups=groups), RefSimulatedExecutor)
    history = want.diagnostics["history"]
    assert len(history) >= 2
    for backend in BACKENDS:
        got = run(Scheduler(backend=backend, device="cpu", groups=groups), SimulatedExecutor)
        assert got.diagnostics["history"] == history, backend
        assert got.allocations == want.allocations, backend
    flat = run(Scheduler(backend="torch", device="cpu"), SimulatedExecutor)
    assert flat.diagnostics["history"] == history
