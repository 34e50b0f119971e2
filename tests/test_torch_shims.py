"""The port's deprecated free functions (``repro_torch.core.dfpa`` and the
2-D shims of ``core/partition2d.py``, and ``Scheduler.partition(n=(M, N))``
in grid mode) against the reference's.

Ports the cases of ``tests/test_scheduler_shims.py`` (the DFPA, 2-D and
bank shims) and ``tests/test_dfpa.py`` (the convergence proposition, the
paper's gates on the HCL and Grid5000 simulators, the golden trace, the
behavioural properties): each port shim warns ``DeprecationWarning`` and
gives the reference shim's result field for field, on the numpy backend
and on the torch backend (the bank on the host here).
"""

import json
import pathlib
import warnings

import numpy as np
import pytest
from _hyp import given, settings, st

from repro.core import AnalyticModel as RefAnalyticModel
from repro.core import SimulatedExecutor as RefSimulatedExecutor
from repro.core import bank_repartition_2d as ref_bank_repartition_2d
from repro.core import cpm_partition_2d as ref_cpm_partition_2d
from repro.core import dfpa as ref_dfpa
from repro.core import dfpa_partition_2d as ref_dfpa_partition_2d
from repro.core import ffmpa_partition_2d as ref_ffmpa_partition_2d
from repro.core import make_hcl_time_fns as ref_make_hcl_time_fns
from repro.core import partition_units as ref_partition_units
from repro.core.fpm import PiecewiseLinearFPM as RefFPM

from repro_torch.core import (
    HCL_SPECS,
    AnalyticModel,
    DFPAResult,
    Grid2DResult,
    Policy,
    Scheduler,
    SimulatedExecutor,
    app_time_2d,
    bank_repartition_2d,
    cpm_partition_2d,
    dfpa,
    dfpa_partition_2d,
    ffmpa_partition_2d,
    full_model_build_cost,
    imbalance,
    make_grid5000_time_fns,
    make_hcl_time_fns,
    matmul_app_time_1d,
    speed_fn_2d,
)
from repro_torch.core.fpm import PiecewiseLinearFPM

BACKENDS = ["numpy", "torch"]
GOLDEN = pathlib.Path(__file__).parent / "golden" / "dfpa_hcl.json"


def _row_fns(tfns, n):
    return [(lambda tf: lambda r: tf(r * n))(tf) for tf in tfns]


def _port_dfpa(ex, n, eps, backend, **kw) -> DFPAResult:
    with pytest.deprecated_call(match="dfpa"):
        return dfpa(ex, n, eps, backend=backend, device="cpu", **kw)


def _ref_dfpa(ex, n, eps, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return ref_dfpa(ex, n, eps, **kw)


def _same_result(got: DFPAResult, want) -> None:
    """Field for field: the distribution, times, rounds, the eps test, the
    imbalance, the history and the models' points."""
    assert got.d == want.d
    assert got.times == want.times
    assert got.iterations == want.iterations
    assert got.converged == want.converged
    assert got.imbalance == want.imbalance
    assert got.history == want.history
    assert got.points_per_proc == want.points_per_proc
    assert [m.as_points() for m in got.models] == [m.as_points() for m in want.models]


def _hcl(n):
    _, tfns = make_hcl_time_fns(n)
    _, rtfns = ref_make_hcl_time_fns(n)
    return _row_fns(tfns, n), _row_fns(rtfns, n)


# ---------------------------------------------------------------------------
# the shims warn and delegate (tests/test_scheduler_shims.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
def test_dfpa_shim_warns_and_delegates(backend):
    fns = [lambda x: x / 10.0, lambda x: x / 20.0, lambda x: x / 5.0]
    res = _port_dfpa(SimulatedExecutor(time_fns=list(fns)), 300, 0.05, backend, min_units=1)
    part = Scheduler(backend=backend, device="cpu").autotune(SimulatedExecutor(time_fns=list(fns)), 300, 0.05,
                                                             min_units=1)
    assert res.d == part.allocations
    assert res.iterations == part.iterations
    assert res.history == part.diagnostics["history"]
    assert res.points_per_proc == [m.num_points for m in part.diagnostics["models"]]
    _same_result(res, _ref_dfpa(RefSimulatedExecutor(time_fns=list(fns)), 300, 0.05, min_units=1))


def _grid(p=2, q=2):
    specs = HCL_SPECS[: p * q]
    return [[speed_fn_2d(specs[i * q + j]) for j in range(q)] for i in range(p)]


def _ref_grid(p=2, q=2):
    from repro.core import HCL_SPECS as RS
    from repro.core import speed_fn_2d as rsf

    return [[rsf(RS[: p * q][i * q + j]) for j in range(q)] for i in range(p)]


def _same_grid(got: Grid2DResult, want) -> None:
    for f in ("col_widths", "row_heights", "outer_iterations", "total_rounds", "converged", "imbalance", "times"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.bench_cost == pytest.approx(want.bench_cost, rel=1e-12)


@pytest.mark.parametrize("backend", BACKENDS)
def test_grid_shims_warn_and_delegate(backend):
    M, N = 64, 64
    grid, rgrid = _grid(), _ref_grid()
    with pytest.deprecated_call(match="dfpa_partition_2d"):
        df = dfpa_partition_2d(grid, M, N, eps=0.1, backend=backend, device="cpu")
    part = Scheduler(grid=grid, policy=Policy.GRID2D, backend=backend, device="cpu").partition_grid(M, N, eps=0.1)
    assert df.row_heights == part.row_heights and df.col_widths == part.col_widths
    # Scheduler.partition(n=(M, N)) delegates in grid mode, as the reference's does
    again = Scheduler(grid=grid, policy=Policy.GRID2D, backend=backend, device="cpu").partition(n=(M, N), eps=0.1)
    assert again.row_heights == part.row_heights and again.col_widths == part.col_widths
    with pytest.raises(ValueError, match="n=\\(M, N\\)"):
        Scheduler(grid=grid, policy=Policy.GRID2D, backend=backend, device="cpu").partition(64)

    with pytest.deprecated_call(match="cpm_partition_2d"):
        cpm, cost = cpm_partition_2d(grid, M, N, backend=backend, device="cpu")
    cpm_part = Scheduler(grid=grid, policy=Policy.CPM, backend=backend, device="cpu").partition_grid(M, N)
    assert cpm.row_heights == cpm_part.row_heights
    assert cost == pytest.approx(cpm_part.diagnostics["bench_cost"])

    with pytest.deprecated_call(match="ffmpa_partition_2d"):
        ff = ffmpa_partition_2d(grid, M, N, eps=0.1, backend=backend, device="cpu")
    ff_part = Scheduler(grid=grid, policy=Policy.FFMPA, backend=backend, device="cpu").partition_grid(
        M, N, eps=0.1, max_outer=50
    )
    assert ff.row_heights == ff_part.row_heights

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        _same_grid(df, ref_dfpa_partition_2d(rgrid, M, N, eps=0.1))
        rcpm, rcost = ref_cpm_partition_2d(rgrid, M, N)
        _same_grid(cpm, rcpm)
        assert cost == pytest.approx(rcost, rel=1e-12)
        _same_grid(ff, ref_ffmpa_partition_2d(rgrid, M, N, eps=0.1))
    assert app_time_2d(grid, df, 512) == app_time_2d(grid, part, 512)


@pytest.mark.parametrize("backend", BACKENDS)
def test_bank_repartition_2d_shim_warns_and_delegates(backend):
    p, q, M = 3, 2, 60
    rng = np.random.default_rng(2)
    widths = [20, 22]
    pts = [[[(float(r), float(rng.uniform(1.0, 9.0))) for r in rng.uniform(2, M, 3)] for _ in range(q)]
           for _ in range(p)]
    fpms = [[PiecewiseLinearFPM.from_points(pts[i][j]) for j in range(q)] for i in range(p)]
    rfpms = [[RefFPM.from_points(pts[i][j]) for j in range(q)] for i in range(p)]
    fpm_width = [[widths[j] for j in range(q)] for _ in range(p)]
    with pytest.deprecated_call(match="bank_repartition_2d"):
        rows = bank_repartition_2d(fpms, fpm_width, widths, M, backend=backend, device="cpu")
    want = Scheduler(policy=Policy.GRID2D, backend=backend, device="cpu").repartition_grid(fpms, fpm_width, widths, M)
    assert rows == want
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        assert rows == ref_bank_repartition_2d(rfpms, fpm_width, widths, M)


@pytest.mark.parametrize("shim", ["dfpa", "dfpa_partition_2d", "bank_repartition_2d"])
def test_shims_refuse_unknown_backends(shim):
    ex = SimulatedExecutor(time_fns=[lambda x: x] * 2)
    calls = {
        "dfpa": lambda: dfpa(ex, 10, 0.1, backend="jax"),
        "dfpa_partition_2d": lambda: dfpa_partition_2d(_grid(), 8, 8, 0.1, backend="jax"),
        "bank_repartition_2d": lambda: bank_repartition_2d([[PiecewiseLinearFPM()]], [[None]], [4], 4, backend="jax"),
    }
    with pytest.deprecated_call(), pytest.raises(ValueError, match="unknown backend"):
        calls[shim]()


# ---------------------------------------------------------------------------
# DFPA (tests/test_dfpa.py) through the port's shim
# ---------------------------------------------------------------------------


@st.composite
def _speed_functions(draw):
    """Speed functions satisfying [16]'s shape restrictions: positive,
    eventually monotonically decreasing (here: plateau then decay)."""
    p = draw(st.integers(2, 8))
    fns = []
    for _ in range(p):
        s0 = draw(st.floats(1.0, 100.0))
        knee = draw(st.floats(10.0, 1e4))
        decay = draw(st.floats(0.1, 3.0))

        def t(x, s0=s0, knee=knee, decay=decay):
            if x <= 0:
                return 0.0
            s = s0 if x <= knee else s0 / (1.0 + decay * (x - knee) / knee)
            return x / s

        fns.append(t)
    return fns


@given(fns=_speed_functions(), n=st.integers(100, 20000), eps=st.floats(0.05, 0.3))
@settings(max_examples=30, deadline=None)
def test_convergence_proposition(fns, n, eps):
    """DFPA terminates and either meets eps or reaches a fixed point, on
    both backends, with the reference's result."""
    want = _ref_dfpa(RefSimulatedExecutor(time_fns=fns), n, eps, min_units=1)
    for backend in BACKENDS:
        res = _port_dfpa(SimulatedExecutor(time_fns=fns), n, eps, backend, min_units=1)
        assert sum(res.d) == n
        assert res.iterations <= 100
        assert res.imbalance == imbalance(res.times) or not res.converged
        if res.converged:
            assert res.imbalance <= eps
        _same_result(res, want)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n", [2048, 3072, 4096, 5120, 6144, 7168, 8192])
def test_hcl_converges_fast(n, backend):
    """Gate 2: few iterations (paper: 2-11); eps or the oracle's own
    integer-granularity floor."""
    rows, rrows = _hcl(n)
    res = _port_dfpa(SimulatedExecutor(time_fns=rows), n, 0.025, backend, min_units=1)
    store = Scheduler.from_models([AnalyticModel(tf) for tf in rows], backend="numpy", device="cpu")
    oracle = store.partition(n, min_units=1).allocations
    oracle_imb = imbalance([tf(d) for tf, d in zip(rows, oracle)])
    assert res.converged or res.imbalance <= oracle_imb * 1.05
    assert res.iterations <= 45
    if n <= 4096:
        assert res.iterations <= 4
    _same_result(res, _ref_dfpa(RefSimulatedExecutor(time_fns=rrows), n, 0.025, min_units=1))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        assert oracle == ref_partition_units([RefAnalyticModel(tf) for tf in rrows], n, min_units=1)


def test_dfpa_matches_ffmpa_distribution():
    """Gate 1 (paper §3.1): DFPA returns almost FFMPA's distribution."""
    n = 5120
    rows, _ = _hcl(n)
    ffmpa = Scheduler.from_models([AnalyticModel(tf) for tf in rows], backend="numpy", device="cpu").partition(
        n, min_units=1).allocations
    for backend in BACKENDS:
        res = _port_dfpa(SimulatedExecutor(time_fns=rows), n, 0.025, backend, min_units=1)
        assert sum(abs(a - b) for a, b in zip(res.d, ffmpa)) / n < 0.05
    assert imbalance([tf(d) for tf, d in zip(rows, ffmpa)]) <= 0.05


def test_dfpa_cost_orders_of_magnitude_below_full_model_build():
    """Gate 3: DFPA cost << full-FPM construction (paper: 29 s vs 1850 s)."""
    n = 8192
    _, tfns = make_hcl_time_fns(n)
    ex = SimulatedExecutor(time_fns=_row_fns(tfns, n))
    res = _port_dfpa(ex, n, 0.025, "torch", min_units=1)
    build = full_model_build_cost(
        lambda nn: make_hcl_time_fns(nn)[1], [1024 * k for k in range(1, 9)], [i / 80 for i in range(1, 21)]
    )
    assert build / ex.total_cost > 30
    assert ex.total_cost / matmul_app_time_1d(tfns, res.d, n) < 0.15


@pytest.mark.parametrize("backend", BACKENDS)
def test_grid5000_two_to_three_iterations(backend):
    """Table 4: <= 3 iterations, cost < 1 % of the app."""
    for n in [7168, 10240, 12288]:
        _, tfns = make_grid5000_time_fns(n)
        ex = SimulatedExecutor(time_fns=_row_fns(tfns, n))
        res = _port_dfpa(ex, n, 0.025, backend, min_units=1)
        assert res.converged and res.iterations <= 3
        assert ex.total_cost / matmul_app_time_1d(tfns, res.d, n) < 0.01


@pytest.mark.parametrize("backend", BACKENDS)
def test_dfpa_hcl_golden_trace(backend):
    """Round by round the committed golden trace of the reference's suite."""
    golden = json.loads(GOLDEN.read_text())
    n = golden["n"]
    rows, _ = _hcl(n)
    res = _port_dfpa(SimulatedExecutor(time_fns=rows), n, golden["eps"], backend, min_units=golden["min_units"])
    assert res.iterations == golden["iterations"]
    assert res.converged == golden["converged"]
    assert res.d == golden["final_d"]
    assert res.points_per_proc == golden["points_per_proc"]
    assert len(res.history) == len(golden["rounds"])
    for (d, times), want in zip(res.history, golden["rounds"]):
        assert d == want["d"]
        assert times == pytest.approx(want["times"], rel=1e-12)
    assert res.imbalance == pytest.approx(golden["imbalance"], rel=1e-12)


@pytest.mark.parametrize("backend", BACKENDS)
def test_even_distribution_shortcut(backend):
    res = _port_dfpa(SimulatedExecutor(time_fns=[lambda x: x / 10.0] * 4), 1000, 0.05, backend)
    assert res.iterations == 1 and res.converged


@pytest.mark.parametrize("backend", BACKENDS)
def test_warm_start_reduces_iterations(backend):
    n = 5120
    rows, rrows = _hcl(n)
    cold = _port_dfpa(SimulatedExecutor(time_fns=rows), n, 0.025, backend, min_units=1)
    warm = _port_dfpa(SimulatedExecutor(time_fns=rows), n, 0.025, backend, min_units=1, warm_models=cold.models)
    assert warm.iterations <= max(cold.iterations // 2, 2)
    assert warm.converged
    rcold = _ref_dfpa(RefSimulatedExecutor(time_fns=rrows), n, 0.025, min_units=1)
    _same_result(warm, _ref_dfpa(RefSimulatedExecutor(time_fns=rrows), n, 0.025, min_units=1, warm_models=rcold.models))


@pytest.mark.parametrize("backend", BACKENDS)
def test_dfpa_with_noise_still_terminates(backend):
    n = 4096
    rows, rrows = _hcl(n)
    res = _port_dfpa(SimulatedExecutor(time_fns=rows, noise=0.02, rng=np.random.default_rng(7)), n, 0.10, backend,
                     min_units=1, max_iter=40)
    assert sum(res.d) == n and res.iterations <= 40
    want = _ref_dfpa(RefSimulatedExecutor(time_fns=rrows, noise=0.02, rng=np.random.default_rng(7)), n, 0.10,
                     min_units=1, max_iter=40)
    _same_result(res, want)


@pytest.mark.parametrize("backend", BACKENDS)
def test_input_validation(backend):
    ex = SimulatedExecutor(time_fns=[lambda x: x] * 4)
    with pytest.raises(ValueError):
        _port_dfpa(ex, 2, 0.1, backend)  # n < p
    with pytest.raises(ValueError):
        _port_dfpa(ex, 100, 0.0, backend)
