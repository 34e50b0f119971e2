"""The plain references against the port on the CPU: the frozen partitioner
and the replay of the DFPA loop against the port's banks and ``Scheduler``,
the dense LM against the port's prefill, the product rows against the
port's ``matmul_update``."""

import numpy as np
import pytest
import torch

from bench.lib import loader
from bench.reference import dense_lm, matmul_rows, partitioner
from repro_torch.core import CallableExecutor, Scheduler, SpeedStore


def _random_points(rng, p):
    """Each processor: a few observed (x, s) points of a slowly varying speed."""
    pts = []
    for _ in range(p):
        xs = np.sort(rng.choice(np.arange(1, 400), size=rng.integers(1, 6), replace=False)).astype(float)
        base = rng.uniform(0.5, 4.0)
        pts.append([(float(x), float(base * (1.0 + 0.2 * np.sin(x / 50.0)))) for x in xs])
    return pts


@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("case", range(24))
def test_frozen_partitioner_equals_the_ports_banks(case, backend):
    rng = np.random.default_rng(case)
    p = int(rng.integers(2, 10))
    n = int(rng.integers(p, 600))
    mu = int(rng.integers(0, 2))
    pts = _random_points(rng, p)
    est = partitioner.Estimates(p)
    store = SpeedStore.empty(p, backend=backend, device="cpu")
    for k in range(max(len(r) for r in pts)):
        x = [r[k][0] if k < len(r) else 1.0 for r in pts]
        s = [r[k][1] if k < len(r) else 1.0 for r in pts]
        ok = [k < len(r) for r in pts]
        est.fold_in(x, s, ok)
        store.fold_in(x, s, ok)
    want = partitioner.partition_units(est.bank(), n, mu)
    assert store.partition_units(n, min_units=mu) == want
    assert sum(want) == n and min(want) >= mu


def _session(seed, observe, plant=None):
    """A cold ``Scheduler`` on a simulated 6-processor platform with noise:
    autotune, then 8 iterations; returns the rounds as run."""
    rng = np.random.default_rng(seed)
    speed = rng.uniform(1.0, 4.0, size=6)
    rounds = []

    def fn(i):
        return lambda units: None

    class Sim(CallableExecutor):
        def run(self, d):
            t = [float(di / speed[i] * (1 + 0.02 * rng.standard_normal()) + 0.3 * (di > 40)) for i, di in enumerate(d)]
            rounds.append((list(d), t))
            return t

    ex = Sim([fn(i) for i in range(6)], device="cpu")
    sched = Scheduler(SpeedStore.empty(6, backend="torch", device="cpu"), backend="torch", device="cpu", eps=0.05,
                      min_units=1)
    sched.autotune(ex, 240, 0.05, min_units=1)
    balance = len(rounds)
    for _ in range(8):
        t = ex.run(sched.d if plant is None or len(rounds) != balance + 3 else plant(sched.d))
        if observe:
            sched.observe(t)
    return rounds, balance


@pytest.mark.parametrize("observe", [True, False])
@pytest.mark.parametrize("seed", range(6))
def test_replay_follows_the_ports_scheduler(seed, observe):
    rounds, balance = _session(seed, observe)
    assert partitioner.replay(rounds, n=240, eps=0.05, min_units=1, balance_rounds=balance, observe=observe) == []


def test_replay_catches_a_moved_unit():
    rounds, balance = _session(0, True, plant=lambda d: [d[0] - 1] + list(d[1:-1]) + [d[-1] + 1])
    faults = partitioner.replay(rounds, n=240, eps=0.05, min_units=1, balance_rounds=balance, observe=True)
    assert faults and f"iteration {balance + 3}" in faults[0]


def test_dense_reference_equals_the_ports_prefill_in_float32(small):
    from bench.systems import prefill_pool
    from repro_torch.models.transformer import LanguageModel, init_cache, prefill

    cfg = {**loader.config(loader.benchmark(), "stablelm-12b"), **small["stablelm-12b"]["config"]}
    mc = prefill_pool.model_config(cfg).replace(dtype=torch.float32)
    w = dense_lm.make_weights(cfg, torch.Generator().manual_seed(3), "cpu")
    model = LanguageModel.from_state_dict(mc, w)
    tokens = torch.randint(0, mc.vocab_size, (3, 24), generator=torch.Generator().manual_seed(4))
    with torch.inference_mode():
        got, _ = prefill(model, mc, tokens, init_cache(mc, 3, 25, torch.float32, "cpu"))
    want = dense_lm.forward(w, cfg, tokens)
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4)
    fp8 = dense_lm.forward(w, cfg, tokens, precision="fp8")
    assert (fp8 - want).abs().max() > 100 * (got - want).abs().max()


def test_product_rows_equal_the_ports_update_on_the_cpu():
    from repro_torch.kernels import ops

    g = torch.Generator().manual_seed(5)
    a = torch.randn((64, 512), generator=g).to(torch.bfloat16)
    b = torch.randn((512, 256), generator=g).to(torch.bfloat16)
    rows, reps = [3, 17, 40, 63], [1, 2, 3, 4]
    got = []
    for r, k in zip(rows, reps):
        c = torch.zeros((1, 256), dtype=torch.bfloat16)
        for _ in range(k):
            ops.matmul_update(c, a[r:r + 1], b, bm=1, bn=256, bk=512)
        got.append(c)
    ref = matmul_rows.Product(a, b, list(range(64)))
    assert ref.error(rows, reps, torch.cat(got)) == 0.0
    low = matmul_rows.Product(a, b, list(range(64)), precision="fp8")
    assert ref.error(rows, reps, low.rows(rows, reps)) > 0.01
