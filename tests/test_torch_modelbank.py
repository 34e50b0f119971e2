"""The port's banks held against the reference, bit for bit.

``repro_torch``'s ``TorchModelBank`` on the CPU in float64, its own numpy
``ModelBank`` and its host partitioners are fed the same inputs (made from
a seed with numpy) as the reference's numpy ``ModelBank`` and its
``JaxModelBank``; the reference's jax bank runs under
``with jax.enable_x64(True):`` scoped to the check.

Contract (tolerance zero): model queries, allocations of every completion
route, ``t*`` and ``fold_in`` are bit-identical across the three.  The
25-case smokes run in tier-1, the 200-case lanes under the ``slow`` marker.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core.fpm import PiecewiseLinearFPM as RefFPM
from repro.core.modelbank import ModelBank as RefBank
from repro.core.modelbank import _alloc_at_times as ref_alloc_at_times
from repro.core.modelbank_jax import JaxModelBank
from repro.core.partition import _partition_units_bank as ref_units_bank
from repro.core.partition import _prep_unit_caps as ref_prep_unit_caps

from repro_torch.core.convert import bank_from_arrays
from repro_torch.core.fpm import PiecewiseLinearFPM
from repro_torch.core.modelbank import ModelBank, _alloc_at_times
from repro_torch.core.modelbank_torch import TorchModelBank, np_order_sum
from repro_torch.core.partition import _partition_units_bank, _prep_unit_caps

CPU = "cpu"
K_PAD = 8  # pad every jax bank to one width -> one jit compile per p


def _jax_bank(ref: RefBank) -> JaxModelBank:
    """The reference's device bank (call under ``jax.enable_x64(True)``),
    padded to ``K_PAD`` knots: padding segments are masked, so results are
    unchanged and jax compiles once per ``p``."""
    jb = JaxModelBank.from_bank(ref)
    xs, ss = jb._padded_to(K_PAD)
    return JaxModelBank(xs=xs, ss=ss, counts=jb.counts, monotone=jb.monotone)


# ---------------------------------------------------------------------------
# Case generation (the reference suite's generators, seeded numpy)
# ---------------------------------------------------------------------------


def _random_rows(rng, p, allow_empty=True):
    rows = []
    for _ in range(p):
        k = int(rng.integers(0 if allow_empty else 1, 8))
        if k == 0:
            rows.append([])
            continue
        xs = rng.uniform(1.0, 1e4, k)
        if rng.random() < 0.3:  # provoke duplicate x's (FPM replaces)
            xs = np.round(xs / 100.0) * 100.0 + 1.0
        ss = rng.uniform(0.5, 500.0, k)
        rows.append(list(zip(xs.tolist(), ss.tolist())))
    return rows


def _monotone_rows(rng, p, k_max=7):
    """Nonincreasing speed, or increasing speed with ordered knot times."""
    rows = []
    for _ in range(p):
        k = int(rng.integers(1, k_max))
        xs = np.unique(rng.uniform(1.0, 1e4, k))
        if rng.random() < 0.5:
            ss = np.sort(rng.uniform(0.5, 500.0, len(xs)))[::-1]
        else:
            ts = np.sort(rng.uniform(0.1, 50.0, len(xs)))
            ss = xs / ts
        rows.append(list(zip(xs.tolist(), ss.tolist())))
    return rows


def _banks(rows):
    """The same rows as (port numpy bank, reference numpy bank)."""
    mine = ModelBank.from_models([PiecewiseLinearFPM.from_points(r) for r in rows])
    ref = RefBank.from_models([RefFPM.from_points(r) for r in rows])
    assert np.array_equal(mine.xs, ref.xs) and np.array_equal(mine.ss, ref.ss)
    return mine, ref


def _partition_case(rng, monotone):
    p = int(rng.integers(1, 9))
    rows = _monotone_rows(rng, p) if monotone else _random_rows(rng, p, allow_empty=False)
    n = int(rng.integers(max(2 * p, 4), 3000))
    min_units = min(int(rng.integers(0, 3)), n // p)
    lo = max(1, min_units)
    caps = [lo + int(f * n) for f in rng.uniform(0.0, 1.0, p)]
    if min_units == 0 and p > 1 and rng.random() < 0.3:
        caps[int(rng.integers(0, p))] = 0  # zero-cap row
    return rows, n, caps, min_units


# ---------------------------------------------------------------------------
# Property 1: model queries
# ---------------------------------------------------------------------------


def _check_query_parity(rng):
    rows = _random_rows(rng, int(rng.integers(1, 9)))
    mine, ref = _banks(rows)
    p = mine.p
    x = rng.uniform(0.0, 2e4, p)
    t = float(rng.uniform(1e-3, 100.0))
    caps = rng.uniform(0.0, 1e4, p)
    caps[rng.random(p) < 0.15] = 0.0
    tb = TorchModelBank.from_bank(mine, device=CPU)
    got = [tb.speed(x).numpy(), tb.time(x).numpy(), tb.alloc_at_time(t, caps).numpy()]
    want = [ref.speed(x), ref.time(x), ref.alloc_at_time(t, caps)]
    host = [mine.speed(x), mine.time(x), mine.alloc_at_time(t, caps)]
    with jax.enable_x64(True):
        jb = _jax_bank(ref)
        jx = [np.asarray(jb.speed(x)), np.asarray(jb.time(x)), np.asarray(jb.alloc_at_time(t, caps))]
    for g, w, h, j in zip(got, want, host, jx):
        assert np.array_equal(g, w, equal_nan=True)
        assert np.array_equal(h, w, equal_nan=True)
        assert np.array_equal(j, w, equal_nan=True)
    assert float(tb.total_alloc(t, caps)) == ref.total_alloc(t, caps)
    ts = rng.uniform(0.0, 100.0, 5)
    assert np.array_equal(_alloc_at_times(mine, ts, caps), ref_alloc_at_times(ref, ts, caps))


def test_query_parity_smoke():
    rng = np.random.default_rng(111)
    for _ in range(25):
        _check_query_parity(rng)


@pytest.mark.slow
def test_query_parity_fuzz():
    rng = np.random.default_rng(101)
    for _ in range(200):
        _check_query_parity(rng)


# ---------------------------------------------------------------------------
# Property 2: partitions — every completion route, allocations and t*
# ---------------------------------------------------------------------------


def _check_partition_parity(rows, n, caps, min_units, *, with_jax=True):
    p = len(rows)
    if sum(min(c, n) for c in caps) < n:
        return  # infeasible: property 3's subject
    mine, ref = _banks(rows)
    icaps = ref_prep_unit_caps(p, n, caps, min_units)
    assert _prep_unit_caps(p, n, caps, min_units) == icaps
    tb = TorchModelBank.from_bank(mine, device=CPU)
    modes = ["greedy", "auto"] + (["threshold"] if ref.is_monotone() else [])
    for mode in modes:
        host_mode = "threshold" if (mode == "auto" and ref.is_monotone()) else mode
        host_mode = "greedy" if host_mode == "auto" else host_mode
        d_ref, t_ref = ref_units_bank(ref, n, list(icaps), min_units=min_units, completion=host_mode)
        d_mine, t_mine = _partition_units_bank(
            mine, n, list(icaps), min_units=min_units, completion=host_mode
        )
        d_t, t_t = tb.partition_units(n, caps, min_units=min_units, with_t=True, completion=mode)
        assert sum(d_ref) == n
        assert d_mine == d_ref and t_mine == t_ref
        assert [int(v) for v in d_t] == d_ref, (mode, d_t, d_ref)
        assert float(t_t) == t_ref
        if mode == "threshold" or not with_jax:
            continue  # the jax bank's "auto" already took the threshold route
        with jax.enable_x64(True):
            d_j, t_j = _jax_bank(ref).partition_units(
                n, caps, min_units=min_units, with_t=True, completion=mode
            )
        assert [int(v) for v in d_j] == d_ref and float(t_j) == t_ref


def test_partition_parity_smoke():
    rng = np.random.default_rng(222)
    for _ in range(25):
        _check_partition_parity(*_partition_case(rng, monotone=False))


def test_completion_parity_smoke():
    """The cases of the reference's completion suite: monotone banks, where
    the threshold count must give the exact greedy's allocations."""
    rng = np.random.default_rng(1001)
    for _ in range(25):
        _check_partition_parity(*_partition_case(rng, monotone=True))


@pytest.mark.slow
def test_partition_parity_fuzz():
    rng = np.random.default_rng(202)
    for _ in range(200):
        _check_partition_parity(*_partition_case(rng, monotone=False))


@pytest.mark.slow
def test_completion_parity_fuzz():
    rng = np.random.default_rng(1002)
    for _ in range(200):
        _check_partition_parity(*_partition_case(rng, monotone=True))


@pytest.mark.parametrize("seed", range(6))
def test_take_back_parity(seed):
    """``min_units`` overshoot: the closed-form round robin of the device
    bank equals the reference's sequential take-back."""
    rng = np.random.default_rng(900 + seed)
    p = int(rng.integers(20, 80))
    rows = []
    for _ in range(p):
        s = float(rng.choice([0.2, 1.0, 50.0, 400.0])) * rng.uniform(0.5, 2.0)
        rows.append([(10.0, s), (1000.0, s * rng.uniform(0.5, 1.0))])
    min_units = int(rng.integers(2, 6))
    n = min_units * p + int(rng.integers(0, 3 * p))
    _check_partition_parity(rows, n, [n] * p, min_units, with_jax=False)


@pytest.mark.parametrize("completion", ["greedy", "threshold", "auto"])
def test_infeasible_raises_like_reference(completion):
    rows = [[(10.0, 5.0), (100.0, 4.0)]] * 4
    mine, ref = _banks(rows)
    tb = TorchModelBank.from_bank(mine, device=CPU)
    # min_units * p > n; a cap below min_units; sum(caps) < n
    for n, caps, mu in ((7, None, 2), (20, [1, 20, 20, 20], 2), (20, [4, 4, 4, 4], 0)):
        with pytest.raises(ValueError) as want:
            ref_units_bank(ref, n, ref_prep_unit_caps(4, n, caps, mu), min_units=mu)
        with pytest.raises(ValueError) as got:
            tb.partition_units(n, caps, min_units=mu, completion=completion)
        assert str(got.value).split(":")[0] == str(want.value).split(":")[0]
    empty = TorchModelBank.from_bank(ModelBank.from_point_lists([([], []), ([10.0], [5.0])]), device=CPU)
    with pytest.raises(ValueError, match="empty FPM"):
        empty.partition_units(10, completion=completion)


def test_stacked_bank_matches_per_bank():
    rng = np.random.default_rng(31)
    banks, ns = [], []
    for q in range(3):
        rows = _monotone_rows(rng, 6) if q != 1 else _random_rows(rng, 6, allow_empty=False)
        banks.append(TorchModelBank.from_bank(_banks(rows)[0], device=CPU))
        ns.append(int(rng.integers(100, 3000)))
    stacked = TorchModelBank.stack(banks, min_k=9)
    d = stacked.partition_units(ns, min_units=1)
    for q, b in enumerate(banks):
        assert [int(v) for v in d[q]] == [int(v) for v in b.partition_units(ns[q], min_units=1)]


def test_continuous_parity():
    rng = np.random.default_rng(5)
    rows = _random_rows(rng, 7, allow_empty=False)
    mine, ref = _banks(rows)
    from repro.core.partition import _continuous_bank as ref_continuous_bank

    want, t_want = ref_continuous_bank(ref, 2500.0, [900.0] * 7)
    got, t_got = TorchModelBank.from_bank(mine, device=CPU).partition_continuous(2500.0, [900.0] * 7)
    assert got.tolist() == want and float(t_got) == t_want


# ---------------------------------------------------------------------------
# Property 4: fold_in == add_point
# ---------------------------------------------------------------------------


def _check_fold_in_parity(rng, donate):
    p = int(rng.integers(1, 8))
    models = [RefFPM() for _ in range(p)]
    tb = TorchModelBank.empty(p, k=2, device=CPU)
    for step in range(int(rng.integers(1, 14))):
        x = np.round(rng.uniform(1, 25, p))  # small ints -> many duplicates
        s = rng.uniform(0.5, 10.0, p)
        valid = rng.random(p) > 0.25
        for i in range(p):
            if valid[i]:
                models[i].add_point(float(x[i]), float(s[i]))
        before = tb.copy()
        tb2 = tb.fold_in(x, s, valid, donate=donate)
        assert tb2.generation == step + 1
        if not donate:  # the double-buffered form leaves the old carry intact
            assert torch.equal(tb.xs, before.xs) and torch.equal(tb.counts, before.counts)
        tb = tb2
    got = tb.to_bank()
    for i in range(p):
        assert got.row(i).as_points() == models[i].as_points()


@pytest.mark.parametrize("donate", [True, False])
def test_fold_in_parity_smoke(donate):
    rng = np.random.default_rng(444)
    for _ in range(25):
        _check_fold_in_parity(rng, donate)


@pytest.mark.slow
@pytest.mark.parametrize("donate", [True, False])
def test_fold_in_parity_fuzz(donate):
    rng = np.random.default_rng(404)
    for _ in range(200):
        _check_fold_in_parity(rng, donate)


# ---------------------------------------------------------------------------
# Sums, flags, conversion, and the reference's R2 behaviour
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 7, 8, 9, 127, 128, 129, 1000, 8191, 8192, 8193, 20000, 100000])
def test_np_order_sum_is_numpy_sum(n):
    rng = np.random.default_rng(n)
    a = rng.uniform(0.0, 1e6, (2, n)) * rng.uniform(0.0, 1.0, (2, n)) ** 8
    got = np_order_sum(torch.from_numpy(a)).numpy()
    assert got.tolist() == [float(np.sum(r)) for r in a]


def test_monotone_flag_matches_reference():
    rng = np.random.default_rng(7)
    spike = [[(10.0, 5.0), (20.0, 50.0)]] * 3
    for rows in (_monotone_rows(rng, 6), spike, [[(10.0, 10.0), (10.0, 9.0)]]):
        mine, ref = _banks(rows)
        tb = TorchModelBank.from_bank(mine, device=CPU)
        tb.monotone = None  # force the device check
        assert tb.is_monotone() == ref.is_monotone() == mine.is_monotone()


def test_bank_from_reference_arrays():
    rng = np.random.default_rng(8)
    _, ref = _banks(_random_rows(rng, 5))
    with jax.enable_x64(True):
        jb = JaxModelBank.from_bank(ref)
        arrays = (np.asarray(jb.xs), np.asarray(jb.ss), np.asarray(jb.counts))
    tb = bank_from_arrays(*arrays, device=CPU)
    assert np.array_equal(tb.to_bank().xs, ref.xs) and tb.is_monotone() == ref.is_monotone()


def test_alloc_at_time_mirrors_reference_r2_case():
    """Two knots one ULP apart: the reference returns an x whose time
    exceeds t (ROADMAP R2).  The port copies that behaviour for parity."""
    pts = [(1.0, 3.0), (1.0000000000000002, 1.0)]
    want = RefFPM.from_points(pts).alloc_at_time(0.5, 2.0)
    assert PiecewiseLinearFPM.from_points(pts).alloc_at_time(0.5, 2.0) == want
    mine, ref = _banks([pts])
    tb = TorchModelBank.from_bank(mine, device=CPU)
    assert float(tb.alloc_at_time(0.5, [2.0])[0]) == float(ref.alloc_at_time(0.5, [2.0])[0])


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs a machine without one")
    with pytest.raises(RuntimeError, match="cuda"):
        TorchModelBank.empty(4)


def test_completion_lanes_and_deferred_fetch():
    from repro_torch.core.modelbank_torch import fetch_partition

    rng = np.random.default_rng(41)
    banks = [TorchModelBank.from_bank(_banks(_monotone_rows(rng, 5))[0], device=CPU) for _ in range(2)]
    stacked = TorchModelBank.stack(banks)
    ns = [700, 1500]
    lanes = np.array([True, False])
    deferred = stacked.partition_units(ns, completion_lanes=lanes, defer=True, with_t=True)
    assert isinstance(deferred[0], torch.Tensor)
    d, t_star = fetch_partition(deferred)
    for q, b in enumerate(banks):
        mode = "threshold" if lanes[q] else "greedy"
        d_q, t_q = b.partition_units(ns[q], completion=mode, with_t=True)
        assert d[q].tolist() == d_q.tolist() and float(t_star[q]) == float(t_q)


def test_scaled_bank_matches_reference_scaled():
    rng = np.random.default_rng(42)
    mine, ref = _banks(_random_rows(rng, 6, allow_empty=False))
    scale = rng.uniform(0.5, 2.0, 6)
    got = TorchModelBank.from_bank(mine, device=CPU).scaled(scale).partition_units(900, min_units=1)
    ref_s = ref.scaled(scale)
    want, _ = ref_units_bank(ref_s, 900, [900] * 6, min_units=1)
    assert got.tolist() == want
