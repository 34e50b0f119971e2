"""A run with the timed path broken underneath comes out not correct, once
for each fault a cell can have; and the control (the plain reference in
fp8, put in the program's place) reads above the program and fails the
run's own check.  The cells run
at the CPU's small sizes, past the harness's look for a card."""

import time

import pytest
import torch

from bench.lib import harness, loader
from bench.tests import controls
from repro_torch.core import SpeedStore
from repro_torch.kernels import ops
from repro_torch.runtime import ServeEngine, serve_loop

CPU = torch.device("cpu")
BENCH = loader.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 2**31 + 11


def _run(cell, small):
    cfg = loader.workload(BENCH, cell)["config"]
    return harness.run_cell(BENCH, cell, SEED, 0.5, False, CPU, time.perf_counter(), small[cfg])[0]


def _moved_unit(real):
    """The partitioner's answer altered where it is produced: one unit moved
    from the processor with the most to the one with the fewest."""
    def partition_units(self, n, *args, **kwargs):
        d = list(real(self, n, *args, **kwargs))
        d[d.index(max(d))] -= 1
        d[d.index(min(d))] += 1
        return d
    return partition_units


def _update_unchanged(c, a, b, **kw):
    return c


def _update_half(c, a, b, **kw):
    h = c.shape[0] // 2
    c[:h].copy_((c[:h].float() + a[:h].float() @ b.float()).to(c.dtype))
    return c


def _update_altered(real):
    def update(c, a, b, **kw):
        real(c, a, b, **kw)
        return c.mul_(1.03)
    return update


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, small):
    """A run as the cell's files state it passes its check."""
    r = _run(cell, small)
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_matmul_faults_fail(fault, small, monkeypatch):
    real = ops.matmul_update
    monkeypatch.setattr(ops, "matmul_update", {"unchanged": _update_unchanged, "half": _update_half,
                                               "altered": _update_altered(real)}[fault])
    r = _run("hcl-matmul.steady", small)
    assert not r["correct"] and r["checks"]["c_rows_rel_rms"]["value"] > r["checks"]["c_rows_rel_rms"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_moved_unit_fails(cell, small, monkeypatch):
    monkeypatch.setattr(SpeedStore, "partition_units", _moved_unit(SpeedStore.partition_units))
    r = _run(cell, small)
    assert not r["correct"] and r["checks"]["allocations_unlike_replay"]["value"] > 0


def _prefill_unchanged(params, cfg, tokens, caches, **kw):
    return torch.zeros((tokens.shape[0], cfg.vocab_size), device=tokens.device), caches


def _prefill_half(real):
    def prefill(params, cfg, tokens, caches, **kw):
        logits, caches = real(params, cfg, tokens, caches, **kw)
        logits[tokens.shape[0] // 2:] = 0.0
        return logits, caches
    return prefill


def _generate_altered(real):
    def generate(self, tokens, max_new, **kw):
        return (real(self, tokens, max_new, **kw) + 1) % self.cfg.vocab_size
    return generate


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_serving_faults_fail(fault, small, monkeypatch):
    if fault == "altered":
        monkeypatch.setattr(ServeEngine, "generate", _generate_altered(ServeEngine.generate))
    else:
        monkeypatch.setattr(serve_loop, "prefill",
                            _prefill_unchanged if fault == "unchanged" else _prefill_half(serve_loop.prefill))
    r = _run("stablelm-12b.dispatch", small)
    assert not r["correct"] and r["checks"]["served_logit_gap"]["value"] > r["checks"]["served_logit_gap"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_above_the_program(cell, small):
    out = controls.readings(cell, SEED, 0.5, CPU, control=True, overrides=small[loader.workload(BENCH, cell)["config"]])
    name = next(k for k in out["control"] if k != "allocations_unlike_replay")
    assert out["program_correct"] and out["control"][name] > 3 * max(out["program"][name], 1e-3)


def test_matmul_control_fails_the_check(small):
    """The rows' limit holds at every size, so the small run shows the
    control failing the run's own check (the served gap's limit is the
    cell's size's: ``test_bench_card.py`` shows it there)."""
    out = controls.readings("hcl-matmul.steady", SEED, 0.5, CPU, control=True, overrides=small["hcl-matmul"])
    assert out["program_correct"] and not out["control_correct"]
