"""The 2-D grid partitioner on the card.

Marked ``cuda``: each test skips where there is no CUDA device.  This file
imports no JAX and nothing of the reference, so it runs on the machine with
the card:

    python -m pytest -q -m cuda tests/test_torch_grid_cuda.py

* ``partition_grid`` on the HCL 4x4 grid (GRID2D, CPM, FFMPA, and FFMPA
  with its analytic models sample-and-banked) with the bank on the card is
  bit-identical to the numpy backend on the host;
* ``repartition_grid`` on one stacked ``[q, p, k]`` device bank equals the
  numpy per-column path;
* ``MatmulGrid``, the 2-D application at ``chip_smoke.py``'s configuration
  (a 2 x 4 grid of processors sharing the card, each running
  ``matmul_update`` on its block), balanced by ``partition_grid`` under
  GRID2D: it converges at eps 0.1, every launch takes the ``"wgmma"``
  route, and the launches are the speed functions' evaluations times their
  repeats; ``matmul_update`` at the blocks' shapes (K = 4096, 128 x 128 x
  512 tiles) meets its plain version, ``atol 5e-2 * sqrt(K), rtol 2e-2``.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import PiecewiseLinearFPM, Policy, Scheduler
from repro_torch.kernels import matmul_update
from repro_torch.kernels.matmul_update import matmul_update_cuda
from repro_torch.kernels.ref import matmul_update_ref
from repro_torch.launch.matmul_grid import GRID_BLOCKS, GRID_EPS, GRID_K, GRID_UNIT, GRID_UNITS, MatmulGrid
from repro_torch.launch.paper_tables import hcl_grid

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _same(got, want):
    assert got.col_widths == want.col_widths
    assert got.row_heights == want.row_heights
    assert got.times == want.times
    assert got.iterations == want.iterations
    assert got.imbalance == want.imbalance
    for key in ("total_rounds", "bench_cost", "times"):
        assert got.diagnostics[key] == want.diagnostics[key], key


@pytest.mark.parametrize("policy,kw", [
    ("GRID2D", dict(eps=0.1)),
    ("CPM", {}),
    ("FFMPA", dict(eps=0.1, max_outer=50)),
])
def test_hcl_grid_on_card_matches_numpy(card, policy, kw):
    want = Scheduler(grid=hcl_grid(4, 4), policy=getattr(Policy, policy), backend="numpy").partition_grid(
        384, 384, **kw
    )
    got = Scheduler(grid=hcl_grid(4, 4), policy=getattr(Policy, policy), backend="torch", device=card).partition_grid(
        384, 384, **kw
    )
    _same(got, want)


def test_banked_ffmpa_on_card_matches_numpy(card):
    kw = dict(eps=0.1, max_outer=50)
    want = Scheduler(grid=hcl_grid(4, 4), policy=Policy.FFMPA, backend="numpy", analytic_tol=0.005).partition_grid(
        384, 384, **kw
    )
    got = Scheduler(
        grid=hcl_grid(4, 4), policy=Policy.FFMPA, backend="torch", device=card, analytic_tol=0.005
    ).partition_grid(384, 384, **kw)
    _same(got, want)


@pytest.mark.parametrize("monotone", [False, True])
def test_repartition_grid_on_card_matches_numpy(card, monotone):
    rng = np.random.default_rng(7 + monotone)
    p, q, M = 256, 8, 25_600
    widths = [int(w) for w in rng.integers(32, 128, q)]
    fpms = [[None] * q for _ in range(p)]
    fpm_width = [[None] * q for _ in range(p)]
    for i in range(p):
        for j in range(q):
            xs = np.sort(rng.uniform(1.0, 400.0, 8))
            ss = xs / np.sort(rng.uniform(0.1, 50.0, 8)) if monotone else rng.uniform(1.0, 30.0, 8)
            fpms[i][j] = PiecewiseLinearFPM.from_points(list(zip(xs.tolist(), ss.tolist())))
            fpm_width[i][j] = int(rng.integers(widths[j] // 2, 2 * widths[j]))
    want = Scheduler(policy=Policy.GRID2D, backend="numpy").repartition_grid(fpms, fpm_width, widths, M)
    got = Scheduler(policy=Policy.GRID2D, backend="torch", device=card).repartition_grid(fpms, fpm_width, widths, M)
    assert got == want


def test_matmul_grid_converges_on_card(card):
    app = MatmulGrid()
    app.run(0, 0, 1, 1)  # the kernel's first use, outside the counts
    torch.cuda.synchronize()
    app.reset_counts()
    before = (matmul_update_cuda.launches, dict(matmul_update_cuda.launches_by_route))
    part = Scheduler(grid=app.grid(), policy=Policy.GRID2D, backend="torch", device=card).partition_grid(
        GRID_UNITS, GRID_UNITS, eps=GRID_EPS
    )
    launched = matmul_update_cuda.launches - before[0]
    routes = {r: n - before[1][r] for r, n in matmul_update_cuda.launches_by_route.items()}
    assert part.converged and part.imbalance <= GRID_EPS
    assert launched == app.expected > 0 and app.evals > 0
    assert routes == {"tile": 0, "wgmma": launched}
    assert sum(part.col_widths) == GRID_UNITS and all(sum(r) == GRID_UNITS for r in part.row_heights)


@pytest.mark.parametrize("r,w", [(64, 32), (100, 50), (28, 26)])
def test_matmul_grid_blocks_match_plain_on_card(card, r, w):
    M, N, K = r * GRID_UNIT, w * GRID_UNIT, GRID_K
    g = torch.Generator(device=card).manual_seed(3)
    c, a, b = (torch.randn(s, generator=g, device=card).to(torch.bfloat16) for s in ((M, N), (M, K), (K, N)))
    want = matmul_update_ref(c, a, b).float()
    before = dict(matmul_update_cuda.launches_by_route)
    got = matmul_update(c.clone(), a, b, **GRID_BLOCKS)
    again = matmul_update(c.clone(), a, b, **GRID_BLOCKS)
    torch.cuda.synchronize()
    assert matmul_update_cuda.launches_by_route["wgmma"] - before["wgmma"] == 2
    assert torch.equal(got, again)
    err = (got.float() - want).abs()
    assert bool((err <= 5e-2 * np.sqrt(K) + 2e-2 * want.abs()).all()), float(err.max())
