"""The port's 2-D grid partitioner held against the reference's, bit for bit.

``repro_torch``'s ``Scheduler(grid=...).partition_grid`` — on its numpy
backend and on its torch backend with the device bank on the CPU in float64
— runs the paper's nested algorithm (§3.2) on the calibrated HCL 4x4 grid,
and the reference's numpy ``partition_grid`` runs it on the same grid.

Contract (tolerance zero): column widths, row heights, the per-processor
times, outer iterations, ``total_rounds``, ``bench_cost`` and the imbalance
are equal, for ``GRID2D``, ``CPM`` and ``FFMPA``.  Both run GRID2D's
per-column inner loops as jobs of one fleet per outer round, and the
fleets' ``fleet.round`` spans (round, jobs measured, jobs finished) are
equal under each package's telemetry sink.  The 2-D simulator
equals the reference's; the batched 2-D simulator equals the scalar one;
the properties of
``tests/test_partition2d.py`` hold on the port; ``repartition_grid`` on the
stacked ``[q, p, k]`` torch bank equals the numpy per-column path.
"""

import numpy as np
import pytest

from repro.core import HCL_SPECS as REF_HCL_SPECS
from repro.core import Policy as RefPolicy
from repro.core import Scheduler as RefScheduler
from repro.core import app_time_2d as ref_app_time_2d
from repro.core import full_model_build_cost as ref_full_model_build_cost
from repro.core import make_grid5000_specs as ref_make_grid5000_specs
from repro.core import make_grid5000_time_fns as ref_make_grid5000_time_fns
from repro.core import make_hcl_time_fns as ref_make_hcl_time_fns
from repro.core import speed_fn_2d as ref_speed_fn_2d

from repro_torch.core import (
    HCL_SPECS,
    PiecewiseLinearFPM,
    Policy,
    Scheduler,
    app_time_2d,
    full_model_build_cost,
    make_grid5000_specs,
    make_grid5000_time_fns,
    make_hcl_time_fns,
    speed_fn_2d,
)

BACKENDS = ["numpy", "torch"]


def _grid(p, q, b=32, specs=HCL_SPECS, fn=speed_fn_2d):
    specs = (list(specs) * 2)[: p * q]  # wrap around for grids > 16 procs
    return [[fn(specs[i * q + j], b) for j in range(q)] for i in range(p)]


def _ref_grid(p, q, b=32):
    return _grid(p, q, b, REF_HCL_SPECS, ref_speed_fn_2d)


def _port(grid, policy, backend, **kw):
    return Scheduler(grid=grid, policy=policy, backend=backend, device="cpu", **kw)


def _assert_same_partition(got, want):
    assert got.col_widths == want.col_widths
    assert got.row_heights == want.row_heights
    assert got.allocations == want.allocations
    assert got.times == want.times
    assert got.iterations == want.iterations
    assert got.converged == want.converged
    assert got.imbalance == want.imbalance
    assert got.makespan == want.makespan
    for key in ("total_rounds", "bench_cost", "times"):
        assert got.diagnostics[key] == want.diagnostics[key], key


# ---------------------------------------------------------------------------
# The 2-D simulator
# ---------------------------------------------------------------------------


def test_2d_simulator_matches_reference():
    rng = np.random.default_rng(0)
    mb = np.concatenate([[0.0, 1.0], rng.uniform(0.0, 3000.0, 30)])
    nb = np.concatenate([[5.0, 0.0], rng.uniform(0.0, 3000.0, 30)])
    for b in (16, 32):
        for spec, ref_spec in zip(HCL_SPECS, REF_HCL_SPECS):
            g, rg = speed_fn_2d(spec, b), ref_speed_fn_2d(ref_spec, b)
            assert [g(float(x), float(y)) for x, y in zip(mb, nb)] == [
                rg(float(x), float(y)) for x, y in zip(mb, nb)
            ]


def test_grid5000_and_full_model_cost_match_reference():
    assert [vars(s) for s in make_grid5000_specs()] == [vars(s) for s in ref_make_grid5000_specs()]
    assert [vars(s) for s in make_grid5000_specs(7)] == [vars(s) for s in ref_make_grid5000_specs(7)]
    _, fns = make_grid5000_time_fns(10240)
    _, ref_fns = ref_make_grid5000_time_fns(10240)
    xs = [1.0, 2.5e6, 4e7, 3e8]
    assert [f(x) for f in fns for x in xs] == [f(x) for f in ref_fns for x in xs]
    args = ([1024 * k for k in range(1, 5)], [i / 80 for i in range(1, 11)])
    assert full_model_build_cost(lambda n: make_hcl_time_fns(n)[1], *args) == ref_full_model_build_cost(
        lambda n: ref_make_hcl_time_fns(n)[1], *args
    )


# ---------------------------------------------------------------------------
# partition_grid: bit-identical to the reference's numpy backend
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n", [256, 512])
@pytest.mark.parametrize("policy", ["GRID2D", "CPM", "FFMPA"])
def test_partition_grid_matches_reference(policy, n, backend):
    kw = dict(eps=0.1) if policy != "CPM" else {}
    if policy == "FFMPA":
        kw["max_outer"] = 50
    want = RefScheduler(grid=_ref_grid(4, 4), policy=getattr(RefPolicy, policy)).partition_grid(n, n, **kw)
    got = _port(_grid(4, 4), getattr(Policy, policy), backend).partition_grid(n, n, **kw)
    _assert_same_partition(got, want)
    assert got.backend == backend and got.policy is getattr(Policy, policy)
    assert app_time_2d(_grid(4, 4), got, K=n) == ref_app_time_2d(_ref_grid(4, 4), want, K=n)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n", [256, 512])
def test_grid_fleet_rounds_match_reference(n, backend):
    """GRID2D's inner loops run through the fleet on both sides: the same
    fleet rounds, with the same jobs measured and finished in each."""
    import repro.obs as ref_obs

    from repro_torch import obs

    def rounds(tel):
        return [(e.attrs["round"], e.attrs["measured"], e.attrs["finished"]) for e in tel.spans("fleet.round")]

    ref_tel, port_tel = ref_obs.Telemetry(), obs.Telemetry()
    with ref_obs.use(ref_tel):
        want = RefScheduler(grid=_ref_grid(4, 4), policy=RefPolicy.GRID2D).partition_grid(n, n, eps=0.1)
    with obs.use(port_tel):
        got = _port(_grid(4, 4), Policy.GRID2D, backend).partition_grid(n, n, eps=0.1)
    _assert_same_partition(got, want)
    assert rounds(port_tel) == rounds(ref_tel) and rounds(ref_tel)
    assert sum(m for _, m, _ in rounds(port_tel)) == got.diagnostics["total_rounds"]


def test_2d_batch_simulator_matches_scalar():
    from repro_torch.core import speed_fn_2d_batch, time_fn_2d_batch

    rng = np.random.default_rng(1)
    mb = np.concatenate([[0.0, 1.0, 2.0], rng.uniform(0.0, 3000.0, 13)])
    nb = np.concatenate([[5.0, 0.0, 3.0], rng.uniform(0.0, 3000.0, 13)])
    for b in (16, 32):
        g, t = speed_fn_2d_batch(HCL_SPECS, b), time_fn_2d_batch(HCL_SPECS, b)
        want = [speed_fn_2d(spec, b)(float(x), float(y)) for spec, x, y in zip(HCL_SPECS, mb, nb)]
        assert np.allclose(g(mb, nb), want, rtol=1e-12, atol=0.0)
        tt = t(mb, nb)
        assert all(v == 0.0 for v, x, y in zip(tt, mb, nb) if x * y <= 0)
        assert np.allclose([v for v, x, y in zip(tt, mb, nb) if x * y > 0],
                           [x * y / w for w, x, y in zip(want, mb, nb) if x * y > 0], rtol=1e-12, atol=0.0)


@pytest.mark.parametrize("backend", BACKENDS)
def test_banked_ffmpa_matches_reference(backend):
    # analytic_tol: the full models are sample-and-banked onto the bank
    # backend (the reference's host bank; the port's device bank on torch)
    want = RefScheduler(grid=_ref_grid(3, 3), policy=RefPolicy.FFMPA, analytic_tol=0.005).partition_grid(
        192, 192, eps=0.1, max_outer=50
    )
    got = _port(_grid(3, 3), Policy.FFMPA, backend, analytic_tol=0.005).partition_grid(
        192, 192, eps=0.1, max_outer=50
    )
    _assert_same_partition(got, want)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n", [256, 512])
def test_banked_ffmpa_on_the_hcl_grid_matches_reference(n, backend):
    # the banked path on the 4x4 grid, as chip_smoke.py's grid phase runs it
    # on the card (at 512 it stops unconverged after 12 outer iterations)
    kw = dict(eps=0.1, max_outer=50)
    want = RefScheduler(grid=_ref_grid(4, 4), policy=RefPolicy.FFMPA, analytic_tol=0.005).partition_grid(n, n, **kw)
    got = _port(_grid(4, 4), Policy.FFMPA, backend, analytic_tol=0.005).partition_grid(n, n, **kw)
    _assert_same_partition(got, want)


@pytest.mark.parametrize("policy", ["GRID2D", "CPM"])
def test_app_time_2d_matches_reference(policy):
    want = RefScheduler(grid=_ref_grid(3, 3), policy=getattr(RefPolicy, policy)).partition_grid(192, 192)
    got = _port(_grid(3, 3), getattr(Policy, policy), "torch").partition_grid(192, 192)
    _assert_same_partition(got, want)
    for K in (1, 192):
        assert app_time_2d(_grid(3, 3), got, K=K) == ref_app_time_2d(_ref_grid(3, 3), want, K=K)
    assert app_time_2d(_grid(3, 3), got, K=192, bcast_overhead=0.0) == ref_app_time_2d(
        _ref_grid(3, 3), want, K=192, bcast_overhead=0.0
    )


def test_grid_partition_through_partition_and_its_refusals():
    sched = _port(_grid(2, 2), Policy.CPM, "numpy")
    for n in (64, (64, 64)):
        with pytest.raises(ValueError, match="partition_grid"):
            sched.partition(n)
    with pytest.raises(ValueError, match="grid"):
        Scheduler(num_groups=2, backend="numpy").partition_grid(8, 8)
    # Policy.DFPA on a grid is the nested DFPA algorithm, as GRID2D
    dfpa = _port(_grid(2, 2), Policy.DFPA, "numpy").partition_grid(64, 64, eps=0.1)
    grid2d = _port(_grid(2, 2), Policy.GRID2D, "numpy").partition_grid(64, 64, eps=0.1)
    assert (dfpa.col_widths, dfpa.row_heights) == (grid2d.col_widths, grid2d.row_heights)


# ---------------------------------------------------------------------------
# The properties of tests/test_partition2d.py, on the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
def test_dfpa_2d_partitions_are_valid(backend):
    p, q, M, N = 3, 3, 384, 384
    res = _port(_grid(p, q), Policy.GRID2D, backend).partition_grid(M, N, eps=0.1)
    assert sum(res.col_widths) == N
    for j in range(q):
        assert sum(res.row_heights[j]) == M
        assert all(r >= 1 for r in res.row_heights[j])
    assert res.allocations == [r for col in res.row_heights for r in col]


@pytest.mark.parametrize("backend", BACKENDS)
def test_dfpa_2d_matches_ffmpa_makespan(backend):
    p, q, M, N = 3, 3, 384, 384
    grid = _grid(p, q)
    dfpa_res = _port(grid, Policy.GRID2D, backend).partition_grid(M, N, eps=0.1)
    ff = _port(grid, Policy.FFMPA, backend).partition_grid(M, N, eps=0.1)
    assert app_time_2d(grid, dfpa_res, K=N) <= app_time_2d(grid, ff, K=N) * 1.4


@pytest.mark.parametrize("backend", BACKENDS)
def test_dfpa_2d_beats_cpm_app_time(backend):
    p, q, M, N = 4, 4, 512, 512
    grid = _grid(p, q)
    dfpa_res = _port(grid, Policy.GRID2D, backend).partition_grid(M, N, eps=0.1)
    cpm_res = _port(grid, Policy.CPM, backend).partition_grid(M, N)
    assert app_time_2d(grid, dfpa_res, K=N) < app_time_2d(grid, cpm_res, K=N)


@pytest.mark.parametrize("backend", BACKENDS)
def test_ffmpa_2d_zero_benchmark_cost(backend):
    ff = _port(_grid(3, 3), Policy.FFMPA, backend).partition_grid(256, 256, eps=0.1)
    assert ff.diagnostics["bench_cost"] == 0.0
    assert sum(ff.col_widths) == 256


@pytest.mark.parametrize("backend", BACKENDS)
def test_dfpa_2d_bench_cost_bounded(backend):
    p, q, M, N = 3, 3, 384, 384
    grid = _grid(p, q)
    res = _port(grid, Policy.GRID2D, backend).partition_grid(M, N, eps=0.1)
    app = app_time_2d(grid, res, K=N)
    cost = res.diagnostics["bench_cost"]
    assert cost / (app + cost) < 0.5


@pytest.mark.parametrize("backend", BACKENDS)
def test_dfpa_2d_reuses_benchmarks_across_outer_iterations(backend):
    res = _port(_grid(3, 3), Policy.GRID2D, backend).partition_grid(384, 384, eps=0.1)
    assert res.diagnostics["total_rounds"] < res.iterations * 3 * 10


# ---------------------------------------------------------------------------
# repartition_grid: the stacked [q, p, k] device bank against numpy
# ---------------------------------------------------------------------------


def _random_estimates(rng, p, q, M, widths, knots=4, monotone=False):
    fpms = [[PiecewiseLinearFPM() for _ in range(q)] for _ in range(p)]
    fpm_width = [[None] * q for _ in range(p)]
    for i in range(p):
        for j in range(q):
            xs = np.sort(rng.uniform(4, M, knots))
            if monotone:  # ordered knot times: time nondecreasing in x
                ss = xs / np.sort(rng.uniform(0.1, 50.0, knots))
            else:
                ss = rng.uniform(1.0, 30.0, knots)
            for x, s in zip(xs, ss):
                fpms[i][j].add_point(float(x), float(s))
            fpm_width[i][j] = int(rng.integers(max(1, widths[j] // 2), 2 * widths[j]))
    return fpms, fpm_width


@pytest.mark.parametrize("monotone", [False, True])
@pytest.mark.parametrize("p,q,M", [(3, 2, 128), (16, 5, 1000)])
def test_repartition_grid_torch_matches_numpy(p, q, M, monotone):
    rng = np.random.default_rng(p * q + monotone)
    widths = [int(w) for w in rng.integers(20, 60, q)]
    fpms, fpm_width = _random_estimates(rng, p, q, M, widths, monotone=monotone)
    want = Scheduler(policy=Policy.GRID2D, backend="numpy").repartition_grid(fpms, fpm_width, widths, M)
    got = Scheduler(policy=Policy.GRID2D, backend="torch", device="cpu").repartition_grid(
        fpms, fpm_width, widths, M
    )
    assert got == want
    assert all(sum(r) == M and min(r) >= 1 for r in got)
    # the reference's numpy path gives the same rows
    from repro.core.fpm import PiecewiseLinearFPM as RefFPM

    ref_fpms = [[RefFPM.from_points(m.as_points()) for m in row] for row in fpms]
    assert RefScheduler(policy=RefPolicy.GRID2D).repartition_grid(ref_fpms, fpm_width, widths, M) == want


def test_repartition_grid_refuses_missing_estimates():
    fpms = [[PiecewiseLinearFPM.from_points([(4.0, 2.0)]), PiecewiseLinearFPM()]]
    with pytest.raises(ValueError, match=r"\(0, 1\)"):
        Scheduler(policy=Policy.GRID2D, backend="torch", device="cpu").repartition_grid(
            fpms, [[30, 30]], [30, 30], 16
        )


# ---------------------------------------------------------------------------
# MatmulGrid's launch accounting (the card's application, on the host)
# ---------------------------------------------------------------------------


class _HostEvent:
    """Stands in for ``torch.cuda.Event`` on the host: an event records the
    work launched so far (the multiply-adds of every block, ``WORK[0]``),
    and a timing is the work between two events times a seeded jitter, so
    repeated timings of one block differ and their median is not the first
    of them.  Every timing is kept in ``TIMINGS``."""

    WORK, TIMINGS, RNG = [0.0], [], np.random.default_rng(0)

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        self.t = self.WORK[0]

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        ms = (end.t - self.t) * float(self.RNG.uniform(0.8, 1.25))
        self.TIMINGS.append(ms)
        return ms


@pytest.mark.parametrize("samples", [1, 3])
def test_matmul_grid_counts_every_sample(monkeypatch, samples):
    """Each evaluation of a speed function runs the block ``samples`` times
    and returns ``r*w`` over the median timing; ``expected`` counts
    ``repeats * samples`` launches per evaluation, exactly the launches made
    while ``partition_grid`` balances the grid; ``measure`` times each block
    once."""
    import torch

    from repro_torch.launch import matmul_grid as mg

    launches = []
    plain = mg.matmul_update

    def counted(c, a, b, **blocks):
        launches.append(1)
        _HostEvent.WORK[0] += c.shape[0] * c.shape[1] * a.shape[1] * 1e-3
        return plain(c, a, b, **blocks)

    monkeypatch.setattr(mg, "matmul_update", counted)
    monkeypatch.setattr(torch.cuda, "Event", _HostEvent)
    repeats = [[1, 2, 3], [3, 2, 1]]
    app = mg.MatmulGrid(repeats=repeats, unit=4, units=12, K=8, blocks=dict(bm=4, bn=4, bk=8),
                        samples=samples, device="cpu")
    assert app.samples == samples and app.a.device.type == "cpu"

    evals = []
    grid = [[(lambda i, j, g: lambda mb, nb: (evals.append((i, j)), g(mb, nb))[1])(i, j, g)
             for j, g in enumerate(row)] for i, row in enumerate(app.grid())]
    before = len(_HostEvent.TIMINGS)
    speed = grid[1][0](5.0, 3.0)
    timings = _HostEvent.TIMINGS[before:]
    assert len(timings) == samples and len(launches) == repeats[1][0] * samples
    assert speed == 5 * 3 / (float(np.median(timings)) / 1e3)
    app.reset_counts()
    del launches[:], evals[:]

    part = Scheduler(grid=grid, policy=Policy.GRID2D, backend="numpy", device="cpu").partition_grid(
        12, 12, eps=0.3
    )
    assert sum(part.col_widths) == 12 and all(sum(r) == 12 for r in part.row_heights)
    assert app.evals == len(evals) > 0
    assert len(launches) == app.expected == sum(repeats[i][j] * samples for i, j in evals)
    del launches[:]
    times = app.measure(part)
    assert len(times) == 6 and len(launches) == sum(map(sum, repeats))
    with pytest.raises(ValueError, match="samples"):
        mg.MatmulGrid(samples=0, device="cpu")


def test_matmul_grid_default_device_refuses_without_cuda():
    import torch

    from repro_torch.launch.matmul_grid import MatmulGrid

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs a machine without one")
    with pytest.raises(RuntimeError, match="cuda"):
        MatmulGrid()
