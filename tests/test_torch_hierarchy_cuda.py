"""The two-level partitioner and the time/energy front on the card.

Marked ``cuda``: each test skips where there is no CUDA device.  This file
imports no JAX and nothing of the reference, so it runs on the machine with
the card:

    python -m pytest -q -m cuda tests/test_torch_hierarchy_cuda.py

* the device aggregation (``modelbank_torch._agg_alloc``) equals the host
  ``_alloc_at_times`` pass element for element, and the torch hierarchy's
  aggregate bank equals the numpy hierarchy's;
* the stacked inner solve over ragged ``[g, p_max, k]`` group blocks
  gives the numpy hierarchy's allocations and ``t_outer`` bit for bit, at
  small ``p``, with monotone and non-monotone groups;
* the time/energy front on the card equals numpy's.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import Hierarchy, ModelBank, PiecewiseLinearFPM, SpeedStore
from repro_torch.core.energy import energy_model
from repro_torch.core.modelbank import _aggregate_times, _alloc_at_times
from repro_torch.core.modelbank_torch import _agg_alloc

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _points(rng, p, monotone, kmax=5):
    pts = []
    for _ in range(p):
        k = int(rng.integers(1, kmax + 1))
        xs = np.unique(np.round(rng.uniform(1.0, 200.0, k), 3))
        ss = xs / np.sort(rng.uniform(0.1, 10.0, len(xs))) if monotone else rng.uniform(0.5, 20.0, len(xs))
        pts.append((list(xs), list(ss)))
    return pts


def test_device_aggregation_is_the_host_pass(card):
    rng = np.random.default_rng(301)
    for monotone in (True, False):
        bank = ModelBank.from_point_lists(_points(rng, 40, monotone))
        caps = rng.uniform(20.0, 400.0, bank.p)
        ts = _aggregate_times(bank, caps, 64)
        want = _alloc_at_times(bank, ts, caps)
        put = lambda a: torch.as_tensor(a, device=card)  # noqa: E731
        got = _agg_alloc(
            put(bank.xs[None]), put(bank.ss[None]), put(bank.counts[None]), put(caps[None]), put(ts[None])
        )[0].cpu().numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(6))
def test_hierarchy_on_card_is_numpy(card, seed):
    rng = np.random.default_rng(310 + seed)
    sizes = [int(v) for v in rng.integers(1, 40, int(rng.integers(2, 7)))]
    pts = []
    for size in sizes:
        pts += _points(rng, size, monotone=bool(rng.random() < 0.7))
    bank = ModelBank.from_point_lists(pts)
    groups = [gi for gi, size in enumerate(sizes) for _ in range(size)]
    n = int(rng.integers(30 * bank.p, 120 * bank.p))
    mu = int(rng.integers(0, 2))
    caps = [max(1, mu) + int(f * n) for f in rng.uniform(0.6, 1.0, bank.p)] if seed % 2 else None
    host = Hierarchy.from_bank(bank, groups, backend="numpy")
    dev = Hierarchy.from_bank(bank, groups, backend="torch", device=card)
    assert dev.partition_units(n, caps, min_units=mu, with_t=True) == host.partition_units(
        n, caps, min_units=mu, with_t=True
    )
    for got, want in zip(dev._agg_cache.values(), host._agg_cache.values()):
        np.testing.assert_array_equal(got.xs, want.xs)
        np.testing.assert_array_equal(got.ss, want.ss)


def test_pareto_front_on_card_is_numpy(card):
    rng = np.random.default_rng(320)
    p = 16
    grid = np.sort(rng.uniform(1.0, 1e4, 5))
    speed = [PiecewiseLinearFPM.from_points(list(zip(grid, rng.uniform(0.5, 500.0, 5)))) for _ in range(p)]
    energy = [
        energy_model([(x, a + b * x) for x in grid])
        for a, b in zip(rng.uniform(1.0, 50.0, p), rng.uniform(0.05, 2.0, p))
    ]
    n = 2000
    fronts = {}
    for backend, device in (("numpy", "cpu"), ("torch", card)):
        st = SpeedStore.from_models(speed, backend=backend, device=device).attach_energy(energy)
        fronts[backend] = st.pareto_front(n, num_points=17)
    for name in ("times", "energies", "allocations"):
        np.testing.assert_array_equal(getattr(fronts["torch"], name), getattr(fronts["numpy"], name))
