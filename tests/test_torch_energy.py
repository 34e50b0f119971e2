"""The port's time/energy front held against the reference's.

``repro_torch.core.energy`` and the energy sub-store of the port's
``SpeedStore`` on both banked backends (``"numpy"`` on the host,
``"torch"`` with the device bank in float64 on the CPU) against the
reference's numpy ``SpeedStore`` on the same models.  The cases are
``tests/test_energy.py``'s, drawn from the same seeds; that file does not
collect on this toolchain (its module imports ``jax.experimental.
enable_x64``), so its numpy-lane cases are copied here.

Contract:

* fronts (times, energies, every allocation row) are bit-identical to the
  reference's numpy front on both backends; the torch backend solves the
  interior thresholds as one stacked ``[T, p, k]`` partition;
* ``objective="time"`` with energy attached moves no unit;
* index 0 of a front is the time-optimal partition, index -1 the
  energy-balanced one;
* energy state round-trips, and a reference state with energy models
  continues in the port with the same front.
"""

import numpy as np
import pytest
import torch

from repro.core import Scheduler as RefScheduler
from repro.core import SpeedStore as RefSpeedStore
from repro.core.energy import energy_model as ref_energy_model
from repro.core.fpm import PiecewiseLinearFPM as RefFPM

from repro_torch.core import ModelBank, PiecewiseLinearFPM, Scheduler, SpeedStore, TorchModelBank
from repro_torch.core.energy import (
    ParetoFront,
    _stacked_energy_partition,
    capped_energy_partition,
    energy_model,
)

BACKENDS = ("numpy", "torch")


# ---------------------------------------------------------------------------
# Cases (tests/test_energy.py's generator): heterogeneous speed, affine energy
# ---------------------------------------------------------------------------


def _case_from_raw(speed_rows, energy_params, n, caps_frac, min_units):
    xs = sorted({x for r in speed_rows for x, _ in r})
    energy_rows = [[(x, a + b * x) for x in xs] for a, b in energy_params]
    return dict(
        speed_rows=speed_rows, energy_rows=energy_rows, energy_params=energy_params,
        n=n, caps_frac=caps_frac, min_units=min_units,
    )


def _random_case(rng):
    p = int(rng.choice([3, 5]))
    grid = np.sort(rng.uniform(1.0, 1e4, 5))
    rows = []
    for i in range(p):
        ss = rng.uniform(0.5, 500.0, len(grid))
        rows.append(list(zip(grid.tolist(), ss.tolist())))
    energy_params = [
        (float(rng.uniform(1.0, 50.0)), float(rng.uniform(0.05, 2.0)))
        for _ in range(p)
    ]
    n = int(rng.integers(max(2 * p, 8), 3000))
    caps_frac = rng.uniform(0.6, 1.0, p).tolist() if rng.random() < 0.4 else None
    min_units = int(rng.integers(0, 2))
    return _case_from_raw(rows, energy_params, n, caps_frac, min_units)


def _caps(case):
    if case["caps_frac"] is None:
        return None
    lo = max(1, case["min_units"])
    return [lo + int(f * case["n"]) for f in case["caps_frac"]]


def _emods(case):
    return [energy_model(r) for r in case["energy_rows"]]


def _models(case):
    return [PiecewiseLinearFPM.from_points(r) for r in case["speed_rows"]]


def _store(case, backend, energy=True):
    st = SpeedStore.from_models(_models(case), backend=backend, device="cpu")
    if energy:
        st.attach_energy(_emods(case))
    return st


def _ref_store(case, energy=True):
    st = RefSpeedStore.from_models(
        [RefFPM.from_points(r) for r in case["speed_rows"]], backend="numpy"
    )
    if energy:
        st.attach_energy([ref_energy_model(r) for r in case["energy_rows"]])
    return st


def _same_front(got, want, what=""):
    np.testing.assert_array_equal(got.times, want.times, err_msg=what)
    np.testing.assert_array_equal(got.energies, want.energies, err_msg=what)
    np.testing.assert_array_equal(got.allocations, want.allocations, err_msg=what)


def _scalar_energy(case, d):
    return sum(float(m.time(float(di))) for m, di in zip(_emods(case), d) if di > 0)


# ---------------------------------------------------------------------------
# The parity checks (one description drives every lane)
# ---------------------------------------------------------------------------


def _check_all(case):
    caps = _caps(case)
    n, mu = case["n"], case["min_units"]
    p = len(case["speed_rows"])
    ref = _ref_store(case)
    stores = {b: _store(case, b) for b in BACKENDS}

    # energy queries
    d = np.random.default_rng(int(n)).integers(0, 200, p).astype(np.float64)
    want_e = np.asarray(ref.energy_at(d))
    for b, st in stores.items():
        np.testing.assert_array_equal(np.asarray(st.energy_at(d)), want_e, err_msg=b)
        assert st.fleet_energy(d) == ref.fleet_energy(d), b

    # objective="time" with energy attached moves no unit
    want_t = ref.partition(n, caps, min_units=mu)
    for b, st in stores.items():
        plain = _store(case, b, energy=False).partition(n, caps, min_units=mu)
        assert st.partition(n, caps, min_units=mu, objective="time") == plain, b
        assert plain == want_t, b

    # the front, bit for bit, and its own properties
    want = ref.pareto_front(n, caps, min_units=mu, num_points=9)
    for b, st in stores.items():
        f = st.pareto_front(n, caps, min_units=mu, num_points=9)
        assert isinstance(f, ParetoFront) and len(f) >= 1
        _same_front(f, want, b)
        for row in f.allocations:
            assert int(row.sum()) == n
            if caps is not None:
                assert all(int(v) <= c for v, c in zip(row, caps))
            assert all(int(v) >= mu for v in row)
        assert all(f.times[i] < f.times[i + 1] for i in range(len(f) - 1)), b
        assert all(f.energies[i] > f.energies[i + 1] for i in range(len(f) - 1)), b
        assert list(f.allocations[0]) == st.partition(n, caps, min_units=mu)[0], b
        if len(f) > 1:
            d_energy = st.partition(n, caps, min_units=mu, objective="energy")[0]
            assert list(f.allocations[-1]) == d_energy, b
        for row, e in zip(f.allocations, f.energies):
            assert np.isclose(e, _scalar_energy(case, row), rtol=1e-9), b

    # the power-cap primitive (host numpy, as in the reference)
    sbank, ebank = ModelBank.from_models(_models(case)), ModelBank.from_models(_emods(case))
    icaps = [n] * p if caps is None else caps
    t_lo, t_hi = float(want.times[0]), float(want.times[-1])
    dc = capped_energy_partition(sbank, ebank, n, icaps, t_hi * 1.5, floor_d=want.allocations[0], min_units=mu)
    assert dc is not None and sum(dc) == n and all(v <= c for v, c in zip(dc, icaps))
    assert capped_energy_partition(sbank, ebank, n, icaps, t_lo * 1e-6, min_units=mu) is None

    # fold_energy: the same estimates on both backends
    rng = np.random.default_rng(int(n) + 1)
    obs = [(rng.uniform(1.0, 1e4, p), rng.uniform(1.0, 1e3, p)) for _ in range(3)]
    queries = rng.uniform(1.0, 1e4, p)
    ref_f = RefSpeedStore.from_models([RefFPM.from_points(r) for r in case["speed_rows"]], backend="numpy")
    for x, e in obs:
        ref_f.fold_energy(x, e)
    for b in BACKENDS:
        st = _store(case, b, energy=False)
        for x, e in obs:
            st.fold_energy(x, e)
        np.testing.assert_array_equal(np.asarray(st.energy_at(queries)), np.asarray(ref_f.energy_at(queries)))


def test_energy_parity_smoke(rng):
    for _ in range(25):
        _check_all(_random_case(rng))


@pytest.mark.slow
def test_energy_parity_fuzz_lane():
    rng = np.random.default_rng(42)
    for _ in range(200):
        _check_all(_random_case(rng))


def test_stacked_energy_partition_reads_the_bank_only():
    """The interior solves stack the energy bank as stride-0 views; the
    partition program writes none of its inputs, and each lane equals the
    one-lane solve of its caps."""
    case = _random_case(np.random.default_rng(11))
    n = case["n"]
    tb = TorchModelBank.from_models(_emods(case), device="cpu")
    before = (tb.xs.clone(), tb.ss.clone(), tb.counts.clone())
    p = tb.p
    caps_t = np.stack([np.full(p, n), np.full(p, n // 2 + 1), np.full(p, n)]).astype(np.int64)
    rows = _stacked_energy_partition(tb, caps_t, n, 0, "auto")
    for got, orig in zip((tb.xs, tb.ss, tb.counts), before):
        assert torch.equal(got, orig)
    for row, caps in zip(rows, caps_t):
        assert row == [int(v) for v in tb.partition_units(n, caps)]


def test_torch_bank_carries_the_energy_sub_bank():
    """``with_energy`` / ``energy_at`` / ``fleet_energy`` on the device bank
    equal the numpy bank's, and the sub-bank rides from_bank, to_bank,
    stack, scaled, copy and fold_in as the reference's does."""
    case = _random_case(np.random.default_rng(12))
    sbank = ModelBank.from_models(_models(case))
    ebank = ModelBank.from_models(_emods(case))
    host = sbank.with_energy(ebank)
    d = np.arange(1, host.p + 1) * 37.0
    tb = TorchModelBank.from_bank(host, device="cpu")
    assert tb.energy is not None
    np.testing.assert_array_equal(tb.energy_at(d).numpy(), host.energy_at(d))
    assert tb.fleet_energy(d) == host.fleet_energy(d)
    back = tb.to_bank()
    np.testing.assert_array_equal(back.energy.ss, ebank.ss)
    assert TorchModelBank.stack([tb, tb]).energy.xs.shape[0] == 2
    assert tb.scaled(2.0).energy is tb.energy
    assert tb.copy().energy.xs is not tb.energy.xs
    assert tb.fold_in(d, np.ones(host.p)).energy is tb.energy
    assert host.scaled(2.0).energy is ebank
    with pytest.raises(ValueError, match="rows"):
        sbank.with_energy(ModelBank.from_models(_emods(case)[:-1]))
    with pytest.raises(ValueError, match="no energy sub-bank"):
        TorchModelBank.from_bank(sbank, device="cpu").energy_at(d)


# ---------------------------------------------------------------------------
# Unit behaviour: front picking, validation, persistence, scheduler dispatch
# ---------------------------------------------------------------------------


def _simple_case():
    return _random_case(np.random.default_rng(5))


def test_pareto_pick_and_knee():
    f = ParetoFront(
        times=np.asarray([1.0, 2.0, 4.0]),
        energies=np.asarray([30.0, 20.0, 10.0]),
        allocations=np.asarray([[3, 1], [2, 2], [1, 3]], dtype=np.int64),
    )
    assert f.pick(None) == f.knee()
    assert f.pick(25.0) == 1  # fastest point within budget
    assert f.pick(10.0) == 2
    assert f.pick(5.0) == 2  # unattainable budget -> best effort (last)
    assert f.pick(1e9) == 0
    d = f.as_dict()
    assert d["times"] == [1.0, 2.0, 4.0] and len(d["allocations"]) == 3


def test_energy_model_validation():
    with pytest.raises(ValueError):
        energy_model([(0.0, 5.0)])
    with pytest.raises(ValueError):
        energy_model([(10.0, -1.0)])
    m = energy_model([(10.0, 5.0), (20.0, 8.0)])
    # rate representation: time(x) under the rate model IS E(x)
    assert np.isclose(m.time(10.0), 5.0) and np.isclose(m.time(20.0), 8.0)


@pytest.mark.parametrize("backend", BACKENDS)
def test_attach_energy_validation(backend):
    case = _simple_case()
    st = _store(case, backend, energy=False)
    with pytest.raises(ValueError, match="energy models"):
        st.attach_energy(_emods(case)[:-1])
    with pytest.raises(ValueError, match="need energy models"):
        st.partition(case["n"], objective="energy")
    with pytest.raises(ValueError, match="no energy models"):
        st.pareto_front(case["n"])
    st.attach_energy(_emods(case))
    with pytest.raises(ValueError, match="objective"):
        st.partition(case["n"], objective="power")


@pytest.mark.parametrize("backend", BACKENDS)
def test_state_dict_roundtrips_energy(backend):
    case = _simple_case()
    st = _store(case, backend)
    state = st.state_dict()
    assert "energy_points" in state
    st2 = SpeedStore.from_state(state, device="cpu")
    assert st2.has_energy and st2.backend == backend
    _same_front(st2.pareto_front(case["n"], num_points=5), st.pareto_front(case["n"], num_points=5))
    # a plain store's state has no energy field and loads clean
    plain = _store(case, backend, energy=False)
    assert "energy_points" not in plain.state_dict()
    assert not SpeedStore.from_state(plain.state_dict(), device="cpu").has_energy


def test_reference_state_with_energy_continues_in_the_port():
    """A reference store and scheduler state holding energy models load in
    the port (``core/convert.py``) and give the reference's front."""
    case = _simple_case()
    ref = _ref_store(case)
    want = ref.pareto_front(case["n"], num_points=7)
    for backend in BACKENDS:
        st = SpeedStore.from_state(ref.state_dict(), backend=backend, device="cpu")
        _same_front(st.pareto_front(case["n"], num_points=7), want, backend)
    sched = RefScheduler(ref, backend="numpy", n_units=case["n"])
    for backend in BACKENDS:
        port = Scheduler.from_state(sched.state_dict(), backend=backend, device="cpu")
        assert port.store.has_energy
        _same_front(port.pareto_front(num_points=7), want, backend)


@pytest.mark.parametrize("backend", BACKENDS)
def test_scheduler_objective_dispatch(backend):
    case = _simple_case()
    caps = _caps(case)
    sched = Scheduler(_store(case, backend, energy=False), backend=backend, n_units=case["n"], device="cpu")
    d_time = sched.partition(caps=caps).allocations
    sched.attach_energy(_emods(case))
    assert sched.partition(caps=caps, objective="time").allocations == d_time
    front = sched.pareto_front(caps=caps)
    knee = front.knee()
    part = sched.partition(caps=caps, objective="pareto")
    assert part.allocations == [int(v) for v in front.allocations[knee]]
    capped = sched.partition(caps=caps, energy_cap=float(front.energies[0]) * 0.999)
    idx = front.pick(float(front.energies[0]) * 0.999)
    assert capped.allocations == [int(v) for v in front.allocations[idx]]
    ref = RefScheduler(_ref_store(case), backend="numpy", n_units=case["n"])
    want = ref.partition(caps=caps, energy_cap=float(front.energies[0]) * 0.999)
    assert capped.allocations == want.allocations and capped.t_star == want.t_star
    # state round-trip carries the energy models
    sched2 = Scheduler.from_state(sched.state_dict(), device="cpu")
    assert sched2.store.has_energy


@pytest.mark.parametrize("backend", BACKENDS)
def test_scheduler_objective_needs_energy_and_flat_mode(backend):
    case = _simple_case()
    sched = Scheduler(_store(case, backend, energy=False), backend=backend, n_units=case["n"], device="cpu")
    with pytest.raises(ValueError, match="need energy models"):
        sched.partition(objective="energy")
    p = len(case["speed_rows"])
    hier = Scheduler(
        _store(case, backend, energy=False), backend=backend, n_units=case["n"],
        groups=[i % 2 for i in range(p)], device="cpu",
    )
    hier.store.attach_energy(_emods(case))
    with pytest.raises(ValueError, match="hierarchical scheduler: objective='time' only"):
        hier.partition(objective="energy")
    grid = Scheduler(grid=[[lambda mb, nb: 1.0]], backend=backend, device="cpu")
    with pytest.raises(ValueError, match="grid scheduler: objective='time' only"):
        grid.partition(4, energy_cap=1.0)
