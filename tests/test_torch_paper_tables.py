"""The paper's tables on the port: ``repro_torch.launch.paper_tables``.

On the port's numpy backend each of the six artifacts (Tables 2–5, Fig. 6,
Fig. 10) gives, character for character, the CSV of the reference's
``benchmarks/paper_tables.py``.  On the torch backend (the device bank on
the CPU in float64) each gives the numpy backend's CSV at one size per
artifact (on the card: ``chip_smoke.py``'s ``paper`` phase at each
artifact's smallest size, and the CLI for the whole tables).
The gates of ``tests/test_dfpa.py`` that the tables rest on — DFPA's
distribution close to the full-model partitioner's, its cost far below
building full models, and Grid'5000 in at most three iterations — hold on
both backends.
"""

import pathlib
import sys
import warnings

import pytest

from repro_torch.core import (
    AnalyticModel,
    Policy,
    Scheduler,
    SimulatedExecutor,
    full_model_build_cost,
    imbalance,
    make_grid5000_time_fns,
    make_hcl_time_fns,
    matmul_app_time_1d,
)
from repro_torch.launch import paper_tables

ROOT = pathlib.Path(__file__).resolve().parents[1]

# one size per artifact for the torch backend on the CPU
ONE_SIZE = {
    "table2_dfpa_cost": dict(sizes=[5120]),
    "table3_epsilon": dict(sizes=[6144]),
    "table4_scale": dict(sizes=[10240]),
    "fig6_convergence": {},
    "table5_2d": dict(sizes=[384]),
    "fig10_compare": dict(sizes=[256]),
}


@pytest.fixture(scope="module")
def reference_tables():
    sys.path.insert(0, str(ROOT))
    try:
        from benchmarks import paper_tables as ref
    finally:
        sys.path.remove(str(ROOT))
    return ref


@pytest.mark.parametrize("name", list(paper_tables.TABLES))
def test_numpy_backend_csv_equals_reference(reference_tables, name):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)  # the reference's legacy shims
        want = getattr(reference_tables, name)()
    assert paper_tables.TABLES[name](backend="numpy", device="cpu") == want


@pytest.mark.parametrize("name", list(paper_tables.TABLES))
def test_torch_backend_csv_equals_numpy_at_one_size(name):
    fn = paper_tables.TABLES[name]
    want = fn(backend="numpy", device="cpu", **ONE_SIZE[name])
    assert fn(backend="torch", device="cpu", **ONE_SIZE[name]) == want
    assert want.count("\n") >= 2


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_cli_writes_the_csvs(tmp_path, capsys, backend):
    argv = ["--backend", backend, "--device", "cpu", "--only", "fig6_convergence", "--out", str(tmp_path)]
    assert paper_tables.main(argv) == 0
    csv = (tmp_path / "fig6_convergence.csv").read_text()
    assert csv == paper_tables.fig6_convergence(backend="numpy", device="cpu")
    out = capsys.readouterr()
    assert "simulated seconds" in out.out and f"backend {backend}" in out.out and csv in out.out
    assert "wall" in out.err


# ---------------------------------------------------------------------------
# tests/test_dfpa.py's paper gates, on both backends of the port
# ---------------------------------------------------------------------------


def _row_fns(tfns, n):
    return [(lambda tf: lambda r: tf(r * n))(tf) for tf in tfns]


def _dfpa(ex, n, eps, backend):
    return Scheduler(backend=backend, device="cpu").autotune(ex, n, eps, min_units=1)


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_dfpa_matches_ffmpa_distribution(backend):
    """Paper §3.1: DFPA returns almost the same distribution as the
    full-model partitioner (FFMPA)."""
    n = 5120
    _, tfns = make_hcl_time_fns(n)
    rows = _row_fns(tfns, n)
    ffmpa = Scheduler.from_models(
        [AnalyticModel(tf) for tf in rows], policy=Policy.FFMPA, backend=backend, device="cpu"
    ).partition(n, min_units=1).allocations
    res = _dfpa(SimulatedExecutor(time_fns=rows), n, 0.025, backend)
    l1 = sum(abs(a - b) for a, b in zip(res.allocations, ffmpa))
    assert l1 / n < 0.05  # distributions within 5% L1
    assert imbalance([tf(d) for tf, d in zip(rows, ffmpa)]) <= 0.05


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_dfpa_cost_orders_of_magnitude_below_full_model_build(backend):
    """DFPA cost << full-FPM construction (paper: 29 s vs 1850 s)."""
    n = 8192
    _, tfns = make_hcl_time_fns(n)
    ex = SimulatedExecutor(time_fns=_row_fns(tfns, n))
    res = _dfpa(ex, n, 0.025, backend)
    build = full_model_build_cost(
        lambda nn: make_hcl_time_fns(nn)[1], [1024 * k for k in range(1, 9)], [i / 80 for i in range(1, 21)]
    )
    assert build / ex.total_cost > 30
    assert ex.total_cost / matmul_app_time_1d(tfns, res.allocations, n) < 0.15


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_grid5000_two_to_three_iterations(backend):
    """Table 4: <= 3 iterations, cost < 1% of the app."""
    for n in [7168, 10240, 12288]:
        _, tfns = make_grid5000_time_fns(n)
        ex = SimulatedExecutor(time_fns=_row_fns(tfns, n))
        res = _dfpa(ex, n, 0.025, backend)
        assert res.converged and res.iterations <= 3
        assert ex.total_cost / matmul_app_time_1d(tfns, res.allocations, n) < 0.01
