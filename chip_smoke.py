"""Drive the PyTorch/CUDA port on one NVIDIA H100 and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout: it builds ``src/repro_torch/csrc`` with
``nvcc`` into ``build/repro_torch/``, then runs six phases, each printing one
JSON line, and fails (non-zero exit, no result line) at the first fault:

  1. ``device``     — the card's name, power limit, capability (must be 9.0)
                      and the software versions;
  2. ``build``      — the kernels' build: seconds and the ``ptxas -v``
                      register / spill / shared-memory report;
  3. ``kernels``    — ``matmul_update``'s CUDA kernel against its plain
                      PyTorch version on the card, on the reference's test
                      shapes and two ragged ones at the reference's
                      tolerances, the indivisible-shape refusal, and times at
                      the main path's panel shape and at 1024x8192x8192;
  4. ``bank``       — the device bank (float64) against the host numpy bank
                      at p=10^5 (threshold completion) and p=10^4 (greedy),
                      contract: bit-identical allocations and t*;
  5. ``hcl_golden`` — ``Scheduler(backend="torch", device="cuda").autotune``
                      on the HCL simulator reproduces tests/golden/dfpa_hcl.json;
  6. ``dfpa``       — the main path: the paper's DFPA loop balancing
                      ``matmul_update`` row panels across eight "processors"
                      that share the card and repeat their panel r_i times,
                      timed by the card's clock.  It must converge at eps=0.1,
                      launch the kernel exactly as often as the rounds say,
                      and the final distribution, measured again, must stay
                      within 2*eps.

Then it prints the ``kernels`` summary line, the card's name and power limit
as ``nvidia-smi`` gives them, and, last, ``{"ok": true, "device": ...}``.
It imports only ``repro_torch``, ``torch`` and ``numpy`` and reads the golden
trace as data.
"""

from __future__ import annotations

import json
import pathlib
import platform
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import _build  # noqa: E402  (needs the checkout's src/ on the path)
from repro_torch.core import (  # noqa: E402
    CallableExecutor,
    ModelBank,
    PiecewiseLinearFPM,
    Scheduler,
    SimulatedExecutor,
    SpeedStore,
    TorchModelBank,
    imbalance,
    make_hcl_time_fns,
)
from repro_torch.core.modelbank_torch import numpy_sum_block, np_order_sum  # noqa: E402
from repro_torch.core.partition import _partition_units_bank  # noqa: E402
from repro_torch.kernels import matmul_update  # noqa: E402
from repro_torch.kernels.matmul_update import matmul_update_cuda  # noqa: E402
from repro_torch.kernels.ref import matmul_update_ref  # noqa: E402

# the H100 SXM's published dense peaks and memory rate
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12

MATMUL_CASES = [  # (M, N, K, bm, bn, bk): the reference's cases, then ragged ones
    (128, 128, 128, 128, 128, 128),
    (256, 512, 384, 128, 256, 128),
    (512, 256, 1024, 256, 256, 512),
    (128, 1024, 256, 64, 512, 256),
    (100, 96, 40, 256, 256, 512),  # blocks clip to the shape; tensor-core path
    (72, 90, 36, 256, 256, 512),  # K, N not multiples of 8; plain-tile path
]
ATOL = {torch.float32: 2e-4, torch.bfloat16: 5e-2}  # times sqrt(K); rtol 2e-2

# the main path: N x N bf16 panels, 512 units of 32 rows, eight processors
DFPA_N = 16384
DFPA_UNIT_ROWS = 32
DFPA_UNITS = DFPA_N // DFPA_UNIT_ROWS
DFPA_BLOCKS = dict(bm=32, bn=256, bk=512)
DFPA_REPEATS = [1, 1, 2, 2, 3, 3, 4, 4]
DFPA_EPS = 0.1


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(M: int, N: int, K: int, dtype) -> tuple:
    """Least time the card needs for C += A.B: operations over the peak of
    their type, or the bytes (A, B, C read once, C written once) over the
    memory rate — whichever is larger, in ms."""
    elt = torch.finfo(dtype).bits // 8
    t_ops = 2.0 * M * N * K / PEAK_FLOPS[dtype]
    t_bytes = elt * (M * K + K * N + 2 * M * N) / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------------------


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    smi = nvidia_smi()
    cap = torch.cuda.get_device_capability(0)
    emit({
        "phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(), "capability": list(cap),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "python": platform.python_version(), "numpy": np.__version__,
    })
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: needs compute capability 9.0 (Hopper), got {cap}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise SystemExit("chip_smoke: float32 matmuls must not run in TF32")
    return smi


def phase_build() -> None:
    for name, built in _build.build().items():
        emit({
            "phase": "build", "source": f"src/repro_torch/csrc/{name}.cu",
            "library": str(built.path.relative_to(ROOT)), "seconds": built.seconds,
            "ptxas": built.ptxas_lines(),
        })


def _operands(M, N, K, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(
        torch.randn(shape, generator=g, device="cuda", dtype=torch.float32).to(dtype)
        for shape in ((M, N), (M, K), (K, N))
    )


def _check_parity(M, N, K, blocks, dtype, seed=0) -> float:
    c, a, b = _operands(M, N, K, dtype, seed)
    want = matmul_update_ref(c, a, b).float()
    got = matmul_update(c, a, b, impl="cuda", **blocks)
    torch.cuda.synchronize()
    err = (got.float() - want).abs()
    atol = ATOL[dtype] * float(np.sqrt(K))
    ok = bool((err <= atol + 2e-2 * want.abs()).all())
    max_err = float(err.max())
    emit({
        "phase": "kernels", "case": [M, N, K], "blocks": [blocks["bm"], blocks["bn"], blocks["bk"]],
        "dtype": str(dtype).replace("torch.", ""), "max_abs_err": max_err,
        "tol": f"atol {ATOL[dtype]}*sqrt(K), rtol 2e-2", "ok": ok,
    })
    if not ok:
        raise SystemExit(f"chip_smoke: matmul_update disagrees with its plain version at {(M, N, K)}")
    return max_err


def _timing(M, N, K, blocks, dtype) -> dict:
    max_err = _check_parity(M, N, K, blocks, dtype, seed=1)
    c, a, b = _operands(M, N, K, dtype, 2)
    reps = 20
    ms = cuda_ms(lambda: matmul_update(c, a, b, impl="cuda", **blocks), reps)
    plain_ms = cuda_ms(lambda: matmul_update_ref(c, a, b), reps)
    library_ms = cuda_ms(lambda: c.addmm_(a, b), reps)  # yardstick only
    bound_ms, bound_by = bound(M, N, K, dtype)
    row = {
        "shape": [M, N, K], "dtype": str(dtype).replace("torch.", ""), "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "tflops": 2.0 * M * N * K / (ms * 1e-3) / 1e12,
    }
    emit({"phase": "kernels", "timing": row})
    return row


def phase_kernels() -> dict:
    for dtype in (torch.float32, torch.bfloat16):
        for M, N, K, bm, bn, bk in MATMUL_CASES:
            _check_parity(M, N, K, dict(bm=bm, bn=bn, bk=bk), dtype)
    c, a, b = _operands(100, 128, 128, torch.bfloat16, 0)
    try:
        matmul_update(c, a, b, impl="cuda", bm=64, bn=64, bk=64)
    except ValueError as exc:
        emit({"phase": "kernels", "indivisible_raises": str(exc)})
    else:
        raise SystemExit("chip_smoke: an indivisible shape did not raise ValueError")
    even_rows = DFPA_UNIT_ROWS * (DFPA_UNITS // len(DFPA_REPEATS))
    main = _timing(even_rows, DFPA_N, DFPA_N, DFPA_BLOCKS, torch.bfloat16)
    for rows in (DFPA_UNIT_ROWS, DFPA_UNIT_ROWS * 31):  # the smallest and the slowest's panel
        _timing(rows, DFPA_N, DFPA_N, DFPA_BLOCKS, torch.bfloat16)
    _timing(1024, 8192, 8192, dict(bm=256, bn=256, bk=512), torch.bfloat16)
    return main


# ---------------------------------------------------------------------------


def _random_bank(rng, p, monotone, k=8):
    """A random padded bank of piecewise speed estimates, 1..k knots a row."""
    counts = rng.integers(1, k + 1, p)
    xs = np.sort(rng.uniform(1.0, 1e4, (p, k)), axis=1)
    if monotone:  # ordered knot times: time is nondecreasing
        ss = xs / np.sort(rng.uniform(0.1, 50.0, (p, k)), axis=1)
    else:
        ss = rng.uniform(0.5, 500.0, (p, k))
    last = np.take_along_axis(xs, (counts - 1)[:, None], 1), np.take_along_axis(ss, (counts - 1)[:, None], 1)
    pad = np.arange(k)[None, :] >= counts[:, None]
    return ModelBank(xs=np.where(pad, last[0], xs), ss=np.where(pad, last[1], ss), counts=counts.astype(np.int64))


def _bank_case(rng, p, n, completion, min_units, monotone) -> dict:
    bank = _random_bank(rng, p, monotone)
    if monotone and not bank.is_monotone():
        raise SystemExit("chip_smoke: the threshold case needs a monotone bank")
    t0 = time.perf_counter()
    d_host, t_host = _partition_units_bank(bank, n, [n] * p, min_units=min_units, completion=completion)
    host_ms = (time.perf_counter() - t0) * 1e3
    tb = TorchModelBank.from_bank(bank, device="cuda")
    dev_ms = []
    for _ in range(2):  # cold, then warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d_dev, t_dev = tb.partition_units(n, min_units=min_units, completion=completion, with_t=True)
        torch.cuda.synchronize()
        dev_ms.append((time.perf_counter() - t0) * 1e3)
    drift = int(np.abs(np.asarray(d_dev) - np.asarray(d_host)).max())
    row = {
        "p": p, "n": n, "min_units": min_units, "completion": completion,
        "device_ms_cold": dev_ms[0], "device_ms": dev_ms[1], "host_numpy_ms": host_ms,
        "max_unit_drift": drift, "t_star_equal": float(t_dev) == t_host,
        "sum": int(np.asarray(d_dev).sum()),
    }
    if drift or not row["t_star_equal"] or row["sum"] != n:
        emit({"phase": "bank", "failed": row})
        raise SystemExit("chip_smoke: the device bank broke its bit-identity contract")
    return row


def phase_bank() -> None:
    rng = np.random.default_rng(2024)
    for size in (7, 128, 8193, 100_000):
        a = rng.uniform(0.0, 1e6, size) * rng.uniform(0.0, 1.0, size) ** 8
        if float(np_order_sum(torch.from_numpy(a).cuda())) != float(np.sum(a)):
            raise SystemExit(f"chip_smoke: np_order_sum on the card differs from numpy at n={size}")
    rows = {
        "p100000": _bank_case(rng, 100_000, 10_000_000, "threshold", 1, monotone=True),
        "p10000": _bank_case(rng, 10_000, 1_000_000, "greedy", 1, monotone=False),
        "p10000_takeback": _bank_case(rng, 10_000, 45_000, "threshold", 4, monotone=True),
    }
    # fold_in: one observation per row on the card == add_point on the host
    p = 10_000
    bank = _random_bank(rng, p, monotone=False)
    models = bank.to_models()
    tb = TorchModelBank.from_bank(bank, device="cuda")
    x = np.round(rng.uniform(1.0, 1e4, p))
    s = rng.uniform(0.5, 500.0, p)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tb = tb.fold_in(x, s)
    torch.cuda.synchronize()
    fold_ms = (time.perf_counter() - t0) * 1e3
    for m, xi, si in zip(models, x, s):
        m.add_point(float(xi), float(si))
    host = tb.to_bank()
    if any(host.row(i).as_points() != PiecewiseLinearFPM(list(m.xs), list(m.ss)).as_points()
           for i, m in enumerate(models)):
        raise SystemExit("chip_smoke: fold_in on the card differs from add_point")
    rows["fold_in_p10000_ms"] = fold_ms
    rows["numpy_sum_block"] = numpy_sum_block()  # None: numpy sums a row in one block
    emit({"phase": "bank", "contract": "bit-identical allocations and t* to the host numpy bank, float64", **rows})


def phase_hcl_golden() -> None:
    golden = json.loads((ROOT / "tests" / "golden" / "dfpa_hcl.json").read_text())
    n = golden["n"]
    _, tfns = make_hcl_time_fns(n)
    rows = [(lambda tf: lambda r: tf(r * n))(tf) for tf in tfns]
    sched = Scheduler(backend="torch", device="cuda")
    t0 = time.perf_counter()
    res = sched.autotune(
        SimulatedExecutor(time_fns=rows), n, golden["eps"], min_units=golden["min_units"]
    )
    history = res.diagnostics["history"]
    checks = {
        "iterations": res.iterations == golden["iterations"],
        "converged": res.converged == golden["converged"],
        "final_d": res.allocations == golden["final_d"],
        "points_per_proc": [m.num_points for m in res.diagnostics["models"]] == golden["points_per_proc"],
        "rounds_d": [d for d, _ in history] == [r["d"] for r in golden["rounds"]],
        "rounds_times": len(history) == len(golden["rounds"]) and all(
            np.allclose(t, r["times"], rtol=1e-12, atol=0.0) for (_, t), r in zip(history, golden["rounds"])
        ),
    }
    emit({
        "phase": "hcl_golden", "bank_device": str(sched.store.device_bank(snapshot=False).device),
        "contract": "bit-identical", "iterations": res.iterations,
        "wall_s": time.perf_counter() - t0, "checks": checks,
    })
    if not all(checks.values()):
        raise SystemExit("chip_smoke: the HCL golden trace differs on the card")


def phase_dfpa() -> tuple:
    """The main path: Scheduler.autotune over CallableExecutor, each
    processor running matmul_update on its row panel r_i times a round."""
    g = torch.Generator(device="cuda").manual_seed(0)
    n = DFPA_N
    a = torch.randn((n, n), generator=g, device="cuda", dtype=torch.bfloat16)
    b = torch.randn((n, n), generator=g, device="cuda", dtype=torch.bfloat16)
    c = torch.zeros((n, n), device="cuda", dtype=torch.bfloat16)

    def processor(r):
        def run(units):
            rows = units * DFPA_UNIT_ROWS
            for _ in range(r):
                matmul_update(c[:rows], a[:rows], b, **DFPA_BLOCKS)
        return run

    fns = [processor(r) for r in DFPA_REPEATS]
    executor = CallableExecutor(fns, device="cuda")
    store = SpeedStore.empty(len(fns), backend="torch", device="cuda")
    # the scheduling overhead between rounds, on the host clock with the
    # card drained after each call: every fold_in and partition_units
    overhead_ms = {"fold_in": [], "partition_units": []}

    def timed(name, method):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = method(*args, **kwargs)
            torch.cuda.synchronize()
            overhead_ms[name].append((time.perf_counter() - t) * 1e3)
            return out
        return call

    for name in overhead_ms:
        setattr(store, name, timed(name, getattr(store, name)))
    sched = Scheduler(store, backend="torch", device="cuda")
    matmul_update_cuda.launches = 0
    t0 = time.perf_counter()
    res = sched.autotune(executor, DFPA_UNITS, DFPA_EPS, min_units=1)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = matmul_update_cuda.launches

    history = res.diagnostics["history"]
    expected = sum(r for r in DFPA_REPEATS) + sum(
        r for d, _ in history for di, r in zip(d, DFPA_REPEATS) if di > 0
    )
    remeasured = [executor.run(res.allocations) for _ in range(5)]
    remeasured_imb = [imbalance(t) for t in remeasured]
    median_imb = float(np.median(remeasured_imb))
    out = {
        "phase": "dfpa", "N": n, "units": DFPA_UNITS, "unit_rows": DFPA_UNIT_ROWS,
        "blocks": DFPA_BLOCKS, "dtype": "bfloat16", "repeats": DFPA_REPEATS, "eps": DFPA_EPS,
        "bank_device": str(sched.store.device_bank(snapshot=False).device), "iterations": res.iterations,
        "converged": res.converged, "final_imbalance": res.imbalance,
        "allocations": res.allocations,
        "rounds": [{"d": d, "imbalance": imbalance(t), "times_ms": [v * 1e3 for v in t]} for d, t in history],
        "launches": launches, "expected_launches": expected, "wall_s": wall_s,
        "round_ms_sum": sum(max(t) for _, t in history) * 1e3,
        "fold_in_ms": overhead_ms["fold_in"], "partition_units_ms": overhead_ms["partition_units"],
        "overhead_ms_sum": sum(overhead_ms["fold_in"]) + sum(overhead_ms["partition_units"]),
        "final_d_remeasured_ms": [[v * 1e3 for v in t] for t in remeasured],
        "final_d_remeasured_imbalance": remeasured_imb,
        "final_d_remeasured_imbalance_median": median_imb,
    }
    emit(out)
    if not res.converged:
        raise SystemExit("chip_smoke: DFPA did not converge on the card")
    if launches != expected:
        raise SystemExit(f"chip_smoke: {launches} kernel launches, the rounds account for {expected}")
    if median_imb > 2 * DFPA_EPS:
        raise SystemExit(f"chip_smoke: the final distribution re-measures at imbalance {median_imb}")
    return launches


def main() -> int:
    smi = phase_device()
    phase_build()
    main_timing = phase_kernels()
    phase_bank()
    phase_hcl_golden()
    launches = phase_dfpa()
    emit({"kernels": [{
        "name": "matmul_update", "route": "cuda",
        "source": "src/repro_torch/csrc/matmul_update.cu",
        "replaces": "src/repro/kernels/matmul_update.py:49",
        "launches": launches, "max_abs_err": main_timing["max_abs_err"],
        "ms": main_timing["ms"], "plain_ms": main_timing["plain_ms"],
        "bound_ms": main_timing["bound_ms"], "bound_by": main_timing["bound_by"],
        "library_ms": main_timing["library_ms"],
        "shape": main_timing["shape"], "dtype": main_timing["dtype"],
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
