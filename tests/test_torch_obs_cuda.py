"""The port's telemetry on the card, against ``torch.profiler``'s trace.

Marked ``cuda``: each test skips where there is no CUDA device.  This file
imports no JAX and nothing of the reference, so it runs on the machine with
the card:

    python -m pytest -q -m cuda tests/test_torch_obs_cuda.py

A ``CallableExecutor`` round of three processors, each running
``matmul_update`` on its row panel ``r_i`` times, is profiled with CPU and
CUDA activity and no sink installed.  Every kernel lies inside the
``executor.proc`` span (in ``obs.profiled()``) of the processor that
launched it, within 50 µs: the spans are on the trace's clock.  And the
trace holds the same events, name for name, as one made with every
telemetry hook off: the program adds nothing to the trace.
"""

from collections import Counter

import pytest
import torch
from torch.autograd import DeviceType

from repro_torch import obs
from repro_torch.core import CallableExecutor
from repro_torch.kernels import ops

pytestmark = pytest.mark.cuda

N = K = 2048
ROWS = 256
REPEATS = (1, 2, 3)
SLACK_NS = 50_000


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _executor(device):
    g = torch.Generator(device=device).manual_seed(0)
    a = torch.randn((ROWS * len(REPEATS), K), generator=g, device=device, dtype=torch.bfloat16)
    b = torch.randn((K, N), generator=g, device=device, dtype=torch.bfloat16)
    c = torch.zeros((ROWS * len(REPEATS), N), device=device, dtype=torch.bfloat16)

    def proc(i):
        def run(units):
            rows = slice(ROWS * i, ROWS * i + units)
            for _ in range(REPEATS[i]):
                ops.matmul_update(c[rows], a[rows], b, bm=32, bn=256, bk=512)
        return run

    ex = CallableExecutor([proc(i) for i in range(len(REPEATS))], device=device)
    ex.run([ROWS] * len(REPEATS))  # each processor's untimed first run, and one timed round
    torch.cuda.synchronize(device)
    return ex


def _profiled_round(ex, device):
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        ex.run([ROWS] * len(REPEATS))
        torch.cuda.synchronize(device)
    return list(prof.profiler.kineto_results.events())


def test_each_kernel_lies_inside_the_span_that_launched_it(device):
    ex = _executor(device)
    sink = obs.profiled()
    sink.clear()
    events = _profiled_round(ex, device)
    spans = sorted(sink.spans("executor.proc"), key=lambda e: e.t0)
    assert [e.attrs["proc"] for e in spans] == list(range(len(REPEATS)))
    kernels = sorted((e for e in events if e.device_type() == DeviceType.CUDA and "matmul_update" in e.name()),
                     key=lambda e: e.start_ns())
    owners = [s for s, r in zip(spans, REPEATS) for _ in range(r)]
    assert len(kernels) == len(owners) == sum(REPEATS)
    for k, s in zip(kernels, owners):
        assert s.t0 * 1e9 - SLACK_NS <= k.start_ns() <= k.start_ns() + k.duration_ns() <= s.t1 * 1e9 + SLACK_NS
        assert s.attrs["device_s"] <= s.t1 - s.t0 + SLACK_NS / 1e9
    sink.clear()


def test_the_trace_holds_no_event_of_the_programs_telemetry(device, monkeypatch):
    import repro_torch.core.executor as executor

    ex = _executor(device)
    on = Counter(e.name() for e in _profiled_round(ex, device))
    assert obs.profiled().spans("executor.proc")
    obs.profiled().clear()
    monkeypatch.setattr(executor, "_obs_active", lambda: None)
    off = Counter(e.name() for e in _profiled_round(ex, device))
    assert not obs.profiled().events
    assert sum(on.values()) == sum(off.values()) and on == off
