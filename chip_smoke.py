"""Drive the PyTorch/CUDA port on one NVIDIA H100 and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout: it builds ``src/repro_torch/csrc`` with
``nvcc`` into ``build/repro_torch/``, then runs seven phases, each printing
JSON lines and its seconds, and fails (non-zero exit, no result line) at
the first fault:

  1. ``device``     — the card's name, power limit, capability (must be 9.0)
                      and the software versions;
  2. ``build``      — the three kernels' build (``matmul_update``,
                      ``flash_attention``, ``rglru_scan``): seconds and the
                      ``ptxas -v`` register / spill / shared-memory report,
                      plus the dynamic shared memory of the wgmma kernels
                      and the scan's chunk length;
  3. ``kernels``    — each CUDA kernel against its plain PyTorch version on
                      the card: ``matmul_update`` on the reference's test
                      shapes, two ragged ones and two larger ones on the
                      ``"wgmma"`` route, each launched twice on the same inputs
                      (the two results bit-identical), and the
                      indivisible-shape refusal; at the three DFPA panels
                      (32, 992, 2048 rows) it is timed beside ``addmm_`` and
                      must take the ``"wgmma"`` route, and at 2048 rows a
                      plain version that drops the last 64-deep slice of K
                      must fail the same check; ``flash_attention`` on the
                      reference's ``FLASH_CASES`` x float32 (2e-5) /
                      bfloat16 (2e-2) plus
                      a window whose first key tile is fully masked for some
                      rows, ragged lengths and head_dim 256 cases (an odd
                      group count, softcap, GQA), each launched twice
                      (bit-identical) on the route the wrapper picks;
                      ``rglru_scan`` on ``RGLRU_CASES`` at 1e-5 plus
                      ``h0``, ragged, shorter-than-a-chunk and long cases,
                      and the serve shape with decays near 1 (log_a scaled
                      by 0.002, so every chunk's carry reaches the chunk's
                      far end), each launched twice (bit-identical) on
                      ``"chunked"``.
                      Times at the main paths' shapes, beside the plain
                      version's, one PyTorch call's and the bound, and for
                      flash and the scan the route each replaced
                      (``"mma"``, ``"serial"``: "before") in the same run;
                      at the serve shape flash is held at atol 2e-3, rtol
                      2e-2, and a plain version whose window is one 64-key
                      tile short must fail that check; the scan is held at
                      1e-5, and a plain version that loses the carry at the
                      chunk boundary in mid-sequence must fail it; causal
                      attention with Sq > Sk must raise ``ValueError``;
  4. ``bank``       — the device bank (float64) against the host numpy bank
                      at p=10^5 (threshold completion) and p=10^4 (greedy),
                      contract: bit-identical allocations and t*;
  5. ``hcl_golden`` — ``Scheduler(backend="torch", device="cuda").autotune``
                      on the HCL simulator reproduces tests/golden/dfpa_hcl.json;
  6. ``dfpa``       — the paper's main path: the DFPA loop balancing
                      ``matmul_update`` row panels across eight "processors"
                      that share the card and repeat their panel r_i times,
                      timed by the card's clock.  It must converge at eps=0.1,
                      launch the kernel exactly as often as the rounds say,
                      every launch on the ``"wgmma"`` route, and the final
                      distribution, measured again, must stay within 2*eps;
  7. ``serve``      — the model stack's main path: recurrentgemma-2b at its
                      published width and depth (random weights, seed 0)
                      served by ``ServeEngine.generate`` — a 4096-token
                      prompt for a batch of 4, then 32 greedy tokens.  One
                      ``generate`` must launch ``flash_attention`` exactly 8
                      times, all on ``"wgmma"``, and ``rglru_scan`` 18
                      times, all on ``"chunked"``; two give identical
                      tokens; prefill(4096) + one decode step agree with the
                      full forward over 4097 tokens (rel 0.05); the kernels'
                      inputs captured from a real prefill agree with the plain
                      versions (flash as at the serve shape); and the
                      smoke-width model in float32 gives the CPU's tokens
                      (plain versions) on the card (kernels).  Times come
                      from CUDA events around ``generate``: prefill is one
                      of a single token (printed beside the 385.1 ms an
                      earlier run on another H100 took before the flash and
                      scan redesign: a constant), a decode step the rest of one
                      of 32 tokens over 31.

Then it prints the ``kernels`` summary line (with each kernel's launches by
route on its main path), the card's name and power limit
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
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import flash_attention, matmul_update, ops, rglru_scan  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_cuda,
    flash_attention_route,
)
from repro_torch.kernels.flash_attention import wgmma_smem_bytes as flash_wgmma_smem_bytes  # noqa: E402
from repro_torch.kernels.matmul_update import (  # noqa: E402
    matmul_update_cuda,
    matmul_update_route,
    wgmma_smem_bytes,
)
from repro_torch.kernels.ref import flash_attention_ref, matmul_update_ref, rglru_scan_ref  # noqa: E402
from repro_torch.kernels.rglru import chunk_steps, rglru_scan_cuda  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    LanguageModel,
    apply_lm,
    decode_step,
    init_cache,
    init_lm,
    lm_logits,
    prefill,
)
from repro_torch.runtime import ServeEngine  # noqa: E402

# the H100 SXM's published dense peaks and memory rate
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12

MATMUL_CASES = [  # (M, N, K, bm, bn, bk): the reference's cases, then ragged ones
    (128, 128, 128, 128, 128, 128),
    (256, 512, 384, 128, 256, 128),
    (512, 256, 1024, 256, 256, 512),
    (128, 1024, 256, 64, 512, 256),
    (100, 96, 40, 256, 256, 512),  # blocks clip to the shape; wgmma route
    (72, 90, 36, 256, 256, 512),  # K, N not multiples of 8; "tile" route
    (1024, 4096, 256, 1024, 4096, 256),  # wgmma route, 512 blocks
    (1000, 4000, 200, 1000, 4000, 200),  # wgmma route, ragged M, N and K
]
ATOL = {torch.float32: 2e-4, torch.bfloat16: 5e-2}  # times sqrt(K); rtol 2e-2

# the main path: N x N bf16 panels, 512 units of 32 rows, eight processors
DFPA_N = 16384
DFPA_UNIT_ROWS = 32
DFPA_UNITS = DFPA_N // DFPA_UNIT_ROWS
DFPA_BLOCKS = dict(bm=32, bn=256, bk=512)
DFPA_REPEATS = [1, 1, 2, 2, 3, 3, 4, 4]
DFPA_EPS = 0.1

# the reference's FLASH_CASES and RGLRU_CASES (tests/test_kernels.py), as data
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# at the serve shape (bf16, up to 2048 visible keys a row) outputs average
# many values and are small: atol 2e-3, rtol 2e-2 (see _check_serve_flash)
SERVE_FLASH_TOL = (2e-3, 2e-2)
FLASH_CASES = [  # (B, H, Kv, Sq, Sk, D, kwargs, blocks)
    (1, 2, 2, 128, 128, 64, dict(causal=True), 64),
    (2, 4, 2, 128, 128, 64, dict(causal=True), 64),  # GQA
    (2, 4, 1, 128, 128, 32, dict(causal=True), 64),  # MQA
    (1, 2, 2, 128, 128, 64, dict(causal=True, window=32), 64),  # sliding window
    (1, 2, 2, 128, 128, 64, dict(causal=True, softcap=30.0), 64),  # gemma softcap
    (1, 2, 2, 128, 128, 64, dict(causal=False), 64),  # encoder
    (1, 2, 2, 64, 256, 64, dict(causal=True), 64),  # right-aligned queries
    # the window's first key tile fully masked for most rows of a query tile
    (1, 2, 1, 256, 256, 64, dict(causal=True, window=40), None),
    # ragged lengths no block divides, at the model's head_dim and heads
    (2, 10, 1, 333, 333, 256, dict(causal=True, window=100, scale=0.0625), None),
    # the "wgmma" route at head_dim 256: an odd group count, softcap, GQA
    # with lengths no 128-row or 64-key tile divides
    (2, 3, 1, 200, 200, 256, dict(causal=True), None),
    (1, 2, 1, 190, 190, 256, dict(causal=True, softcap=30.0), None),
    (1, 4, 2, 97, 161, 256, dict(causal=True, window=50), None),
]
RGLRU_CASES = [  # (B, S, D, bs, bd, with_h0)
    (1, 128, 128, 64, 128, False),
    (2, 256, 512, 128, 256, False),
    (3, 512, 256, 256, 128, False),
    (2, 256, 512, 128, 256, True),  # an initial state, as the model's cache carries
    (2, 77, 130, None, None, True),  # ragged
    (3, 50, 200, None, None, True),  # S below one 64-step chunk
    (3, 130, 300, None, None, True),  # B * D not a multiple of the 128-channel tile
    (2, 4096, 64, None, None, True),  # a long sequence at a narrow D
]
RGLRU_NEAR_ONE = 0.002  # log_a scaled by this keeps a near 1 (the model's decays)

# the serving path: recurrentgemma-2b at full width and depth
SERVE_ARCH = "recurrentgemma-2b"
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 4096, 32
SERVE_LAUNCHES = {"flash_attention": 8, "rglru_scan": 18}  # one per local / rec layer
# the serve phase's prefill before the flash and scan redesign: a constant from an
# earlier run on another H100 (PERF.md §5), printed for reference, not measured here
PREFILL_MS_BEFORE = 385.1
SMOKE_BATCH, SMOKE_PROMPT, SMOKE_NEW = 2, 24, 8


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
    emit({
        "phase": "build", "matmul_update_wgmma_dynamic_smem_bytes": wgmma_smem_bytes(),
        "flash_attention_wgmma_dynamic_smem_bytes": {D: flash_wgmma_smem_bytes(D) for D in (64, 128, 256)},
        "rglru_scan_chunk_steps": chunk_steps(),
    })


def _operands(M, N, K, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(
        torch.randn(shape, generator=g, device="cuda", dtype=torch.float32).to(dtype)
        for shape in ((M, N), (M, K), (K, N))
    )


def _within(got, want, K, dtype) -> tuple:
    """The reference's check, ``|got - want| <= atol sqrt(K) + 2e-2 |want|``,
    and the largest absolute error."""
    err = (got.float() - want).abs()
    return bool((err <= ATOL[dtype] * float(np.sqrt(K)) + 2e-2 * want.abs()).all()), float(err.max())


def _check_parity(M, N, K, blocks, dtype, seed=0, planted_fault=False) -> float:
    """The kernel against its plain version, launched twice on the same
    inputs (bit-identical results), through the route the wrapper picks.
    With ``planted_fault`` a plain version that drops the last 64-deep
    slice of K (a lost pipeline stage) must fail the same check."""
    c, a, b = _operands(M, N, K, dtype, seed)
    want = matmul_update_ref(c, a, b).float()
    fault = matmul_update_ref(c, a[:, : K - 64], b[: K - 64]).float() if planted_fault else None
    again = c.clone()
    before = dict(matmul_update_cuda.launches_by_route)
    got = matmul_update(c, a, b, impl="cuda", **blocks)
    matmul_update(again, a, b, impl="cuda", **blocks)
    torch.cuda.synchronize()
    routes = {r: n - before[r] for r, n in matmul_update_cuda.launches_by_route.items()}
    route = matmul_update_route(M, N, K, dtype, (c.data_ptr(), a.data_ptr(), b.data_ptr()))
    ok, max_err = _within(got, want, K, dtype)
    row = {
        "phase": "kernels", "case": [M, N, K], "blocks": [blocks["bm"], blocks["bn"], blocks["bk"]],
        "dtype": _dtype_name(dtype), "route": route, "launches_by_route": routes,
        "max_abs_err": max_err,
        "tol": f"atol {ATOL[dtype]}*sqrt(K), rtol 2e-2", "ok": ok, "repeat_bit_identical": torch.equal(got, again),
    }
    if planted_fault:
        row["k_slice_dropped_passes"], row["k_slice_dropped_max_abs_err"] = _within(got, fault, K, dtype)
    emit(row)
    if not ok:
        raise SystemExit(f"chip_smoke: matmul_update disagrees with its plain version at {(M, N, K)}")
    if not row["repeat_bit_identical"]:
        raise SystemExit(f"chip_smoke: two matmul_update launches on the same inputs differ at {(M, N, K)}")
    if routes != {r: 2 * (r == route) for r in routes}:
        raise SystemExit(f"chip_smoke: matmul_update at {(M, N, K)} launched {routes}, not twice on {route!r}")
    if planted_fault and row["k_slice_dropped_passes"]:
        raise SystemExit("chip_smoke: the matmul_update check cannot tell a dropped 64-deep K slice")
    return max_err


def _timing(M, N, K, blocks, dtype, planted_fault=False) -> dict:
    """Parity, then times at a main-path shape (bf16, aligned): every timed
    launch must take the ``"wgmma"`` route."""
    max_err = _check_parity(M, N, K, blocks, dtype, seed=1, planted_fault=planted_fault)
    c, a, b = _operands(M, N, K, dtype, 2)
    reps = 20
    before = dict(matmul_update_cuda.launches_by_route)
    ms = cuda_ms(lambda: matmul_update(c, a, b, impl="cuda", **blocks), reps)
    routes = {r: n - before[r] for r, n in matmul_update_cuda.launches_by_route.items()}
    if routes["tile"] or not routes["wgmma"]:
        raise SystemExit(f"chip_smoke: matmul_update timed at {(M, N, K)} launched {routes}, not all 'wgmma'")
    plain_ms = cuda_ms(lambda: matmul_update_ref(c, a, b), reps)
    library_ms = cuda_ms(lambda: c.addmm_(a, b), reps)  # yardstick only
    bound_ms, bound_by = bound(M, N, K, dtype)
    row = {
        "shape": [M, N, K], "dtype": _dtype_name(dtype), "max_abs_err": max_err,
        "route": "wgmma",
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "ratio_to_library": ms / library_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "tflops": 2.0 * M * N * K / (ms * 1e-3) / 1e12,
        "gbps": torch.finfo(dtype).bits // 8 * (M * K + K * N + 2 * M * N) / (ms * 1e-3) / 1e9,
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
    main = _timing(even_rows, DFPA_N, DFPA_N, DFPA_BLOCKS, torch.bfloat16, planted_fault=True)
    for rows in (DFPA_UNIT_ROWS, DFPA_UNIT_ROWS * 31):  # the smallest and the slowest's panel
        _timing(rows, DFPA_N, DFPA_N, DFPA_BLOCKS, torch.bfloat16)
    _timing(1024, 8192, 8192, dict(bm=256, bn=256, bk=512), torch.bfloat16)
    _flash_refuses_rows_without_keys()
    for dtype in (torch.float32, torch.bfloat16):
        for case in FLASH_CASES:
            _flash_parity(*case, dtype)
    for case in RGLRU_CASES:
        _rglru_parity(*case)
    _rglru_parity(SERVE_BATCH, SERVE_PROMPT, get_config(SERVE_ARCH).d_rnn, None, None, True, decay=RGLRU_NEAR_ONE)
    flash_row = _flash_timing()
    rglru_row = _rglru_timing()
    return {"matmul_update": main, "flash_attention": flash_row, "rglru_scan": rglru_row}


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _close(got, want, tol) -> tuple:
    """``|got - want| <= tol + tol |want|`` everywhere (the reference's
    atol = rtol tests), and the largest absolute error."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    return bool((err <= tol + tol * want.abs()).all()), float(err.max())


def _flash_fp32(q, k, v, *, causal, window, softcap, scale) -> tuple:
    """Attention on the same inputs in fp32 throughout (logits, weights w
    and values): its output, and ``sqrt(sum_j w_j^2 v_j^2)`` for every
    output element, the size of the rounding error that a weighted sum of
    bf16 terms may carry.  One query head at a time."""
    B, H, Sq, D = q.shape
    Sk, G = k.shape[2], H // k.shape[1]
    qpos = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    out = torch.empty((B, H, Sq, D), dtype=torch.float32, device=q.device)
    terms = torch.empty_like(out)
    for h in range(H):
        logits = torch.einsum("bqd,bkd->bqk", q[:, h].float(), k[:, h // G].float()) * scale
        if softcap > 0:
            logits = softcap * torch.tanh(logits / softcap)
        w = torch.softmax(torch.where(mask, logits, -2e38), dim=-1)
        vf = v[:, h // G].float()
        out[:, h] = w @ vf
        terms[:, h] = ((w * w) @ (vf * vf)).sqrt()
    return out, terms


def _check_serve_flash(got, q, k, v, kw, what: str) -> dict:
    """The kernel's output at the serve shape against its plain version:
    ``|got - want| <= atol + rtol (|want| + terms)`` with SERVE_FLASH_TOL.
    The ``terms`` part covers rows that sum few keys whose values cancel
    (bf16 weights err relative to the terms, not to their sum); rows over
    many keys are held near atol.  The check's own power: the plain version
    with the window one 64-key tile short (a kernel that drops a tile) must
    fail it.  Also reports, by query-row band, the kernel's and the plain
    version's largest error against attention in fp32 throughout."""
    atol, rtol = SERVE_FLASH_TOL
    kw = {n: kw[n] for n in ("causal", "window", "softcap", "scale")}
    exact, terms = _flash_fp32(q, k, v, **kw)
    got = got.float()
    want = flash_attention_ref(q, k, v, **kw).float()

    def within(out) -> tuple:
        err = (out.float() - want).abs()
        return bool((err <= atol + rtol * (want.abs() + terms)).all()), float(err.max())

    ok, max_err = within(got)
    bands = {}
    Sq = q.shape[2]
    for lo, hi in ((0, 64), (64, kw["window"]), (kw["window"], Sq)):
        if lo < hi <= Sq:
            bands[f"rows {lo}-{hi}"] = {
                "kernel": float((got[:, :, lo:hi] - exact[:, :, lo:hi]).abs().max()),
                "plain": float((want[:, :, lo:hi] - exact[:, :, lo:hi]).abs().max()),
            }
    if not ok:
        raise SystemExit(f"chip_smoke: flash_attention disagrees with its plain version {what}: {bands}")
    passed, fault_err = within(flash_attention_ref(q, k, v, **dict(kw, window=kw["window"] - 64)))
    if passed:
        raise SystemExit(f"chip_smoke: the flash check {what} cannot tell a window one tile short")
    return {
        "max_abs_err": max_err, "tol": f"atol {atol} + rtol {rtol} (|want| + sqrt(sum w^2 v^2))",
        "window_one_tile_short_max_abs_err": fault_err, "max_abs_err_vs_fp32": bands,
    }


def _flash_operands(B, H, Kv, Sq, Sk, D, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    def rand(shape, scale):
        return (scale * torch.randn(shape, generator=g, device="cuda")).to(dtype)
    return rand((B, H, Sq, D), 0.3), rand((B, Kv, Sk, D), 0.3), rand((B, Kv, Sk, D), 1.0)


def _flash_parity(B, H, Kv, Sq, Sk, D, kwargs, blocks, dtype) -> float:
    """The kernel against its plain version, launched twice on the same
    inputs (bit-identical results), on the route the wrapper picks."""
    q, k, v = _flash_operands(B, H, Kv, Sq, Sk, D, dtype, seed=Sq + D)
    want = flash_attention_ref(q, k, v, **kwargs)
    before = dict(flash_attention_cuda.launches_by_route)
    got = flash_attention(q, k, v, impl="cuda", bq=blocks, bk=blocks, **kwargs)
    again = flash_attention(q, k, v, impl="cuda", bq=blocks, bk=blocks, **kwargs)
    torch.cuda.synchronize()
    routes = {r: n - before[r] for r, n in flash_attention_cuda.launches_by_route.items()}
    ts = (q, k, v, got)
    route = flash_attention_route(D, dtype, [t.data_ptr() for t in ts], [s for t in ts for s in t.stride()[:3]])
    ok, max_err = _close(got, want, FLASH_TOL[dtype])
    emit({
        "phase": "kernels", "kernel": "flash_attention", "case": [B, H, Kv, Sq, Sk, D], "kwargs": kwargs,
        "blocks": blocks, "dtype": _dtype_name(dtype), "route": route, "launches_by_route": routes,
        "max_abs_err": max_err, "tol": f"atol = rtol = {FLASH_TOL[dtype]}", "ok": ok,
        "repeat_bit_identical": torch.equal(got, again),
    })
    if not ok:
        raise SystemExit(f"chip_smoke: flash_attention disagrees with its plain version at {(B, H, Kv, Sq, Sk, D, kwargs)}")
    if not torch.equal(got, again):
        raise SystemExit(f"chip_smoke: two flash_attention launches on the same inputs differ at {(B, H, Kv, Sq, Sk, D)}")
    if routes != {r: 2 * (r == route) for r in routes}:
        raise SystemExit(f"chip_smoke: flash_attention at {(B, H, Kv, Sq, Sk, D)} launched {routes}, not twice on {route!r}")
    return max_err


def _rglru_operands(B, S, D, with_h0, seed, decay=1.0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    log_a = -decay * torch.nn.functional.softplus(torch.randn((B, S, D), generator=g, device="cuda"))
    b = 0.1 * torch.randn((B, S, D), generator=g, device="cuda")
    h0 = torch.randn((B, D), generator=g, device="cuda") if with_h0 else None
    return log_a, b, h0


def _rglru_parity(B, S, D, bs, bd, with_h0, decay=1.0) -> float:
    """The kernel against its plain version, launched twice on the same
    inputs (bit-identical results), on the ``"chunked"`` route; ``decay``
    scales log_a."""
    log_a, b, h0 = _rglru_operands(B, S, D, with_h0, seed=S + D, decay=decay)
    want = rglru_scan_ref(log_a, b, h0)
    before = dict(rglru_scan_cuda.launches_by_route)
    got = rglru_scan(log_a, b, h0, impl="cuda", bs=bs, bd=bd)
    again = rglru_scan(log_a, b, h0, impl="cuda", bs=bs, bd=bd)
    torch.cuda.synchronize()
    routes = {r: n - before[r] for r, n in rglru_scan_cuda.launches_by_route.items()}
    ok, max_err = _close(got, want, 1e-5)
    emit({
        "phase": "kernels", "kernel": "rglru_scan", "case": [B, S, D], "blocks": [bs, bd], "h0": with_h0,
        "log_a_scale": decay, "dtype": "float32", "launches_by_route": routes, "max_abs_err": max_err, "tol": "atol = rtol = 1e-5",
        "ok": ok, "repeat_bit_identical": torch.equal(got, again),
    })
    if not ok:
        raise SystemExit(f"chip_smoke: rglru_scan disagrees with its plain version at {(B, S, D, with_h0)}")
    if not torch.equal(got, again):
        raise SystemExit(f"chip_smoke: two rglru_scan launches on the same inputs differ at {(B, S, D)}")
    if routes != {"chunked": 2, "serial": 0}:
        raise SystemExit(f"chip_smoke: rglru_scan at {(B, S, D)} launched {routes}, not twice on 'chunked'")
    return max_err


def _flash_refuses_rows_without_keys() -> None:
    """Causal attention with Sq > Sk raises ``ValueError`` on the card
    before any launch."""
    q, k, v = _flash_operands(1, 2, 1, 128, 64, 64, torch.bfloat16, seed=3)
    before = flash_attention_cuda.launches
    try:
        flash_attention(q, k, v, causal=True, bq=None, bk=None)
    except ValueError as exc:
        emit({"phase": "kernels", "kernel": "flash_attention", "causal_sq_gt_sk_raises": str(exc)})
    else:
        raise SystemExit("chip_smoke: causal flash_attention with Sq > Sk did not raise ValueError")
    if flash_attention_cuda.launches != before:
        raise SystemExit("chip_smoke: the refused flash_attention call launched the kernel")


def _bound_ms(ops_count: float, op_dtype, nbytes: float) -> tuple:
    t_ops = ops_count / PEAK_FLOPS[op_dtype]
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _routes_timed(wrapper, route, fn, reps) -> float:
    """``cuda_ms`` of ``fn``, failing unless every launch it made went
    through ``route``."""
    before = dict(wrapper.launches_by_route)
    ms = cuda_ms(fn, reps)
    routes = {r: n - before[r] for r, n in wrapper.launches_by_route.items()}
    if any(n for r, n in routes.items() if r != route) or not routes[route]:
        raise SystemExit(f"chip_smoke: timing the {route!r} route launched {routes}")
    return ms


def _flash_timing() -> dict:
    """flash_attention at the serve path's shape: B=4, H=10, Kv=1,
    Sq=Sk=4096, D=256, bf16, causal, window 2048.  The ``"wgmma"`` route,
    then the ``"mma"`` route it replaced ("before"), in the same run."""
    cfg = get_config(SERVE_ARCH)
    B, H, Kv, S, D, W = SERVE_BATCH, cfg.num_heads, cfg.num_kv_heads, SERVE_PROMPT, cfg.head_dim, cfg.window
    kw = dict(causal=True, window=W, scale=cfg.query_scale)
    q, k, v = _flash_operands(B, H, Kv, S, S, D, torch.bfloat16, seed=7)
    got = flash_attention(q, k, v, impl="cuda", bq=None, bk=None, **kw)
    again = flash_attention(q, k, v, impl="cuda", bq=None, bk=None, **kw)
    check = _check_serve_flash(got, q, k, v, dict(kw, softcap=0.0), "at the serve shape")
    if not torch.equal(got, again):
        raise SystemExit("chip_smoke: two flash_attention launches at the serve shape differ")
    del got, again
    launch = lambda route: lambda: flash_attention_cuda(q, k, v, bq=None, bk=None, route=route, **kw)  # noqa: E731
    ms = _routes_timed(flash_attention_cuda, "wgmma", launch("wgmma"), 20)
    before_ms = _routes_timed(flash_attention_cuda, "mma", launch("mma"), 20)
    plain_ms = cuda_ms(lambda: flash_attention_ref(q, k, v, **kw), 5)
    pos = torch.arange(S, device="cuda")
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - W)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_ms(lambda: sdpa(q, k, v, attn_mask=mask, scale=kw["scale"], enable_gqa=True), 10)  # yardstick only
    pairs = int(mask.sum())  # this run's visible (query, key) pairs per (b, h)
    nbytes = 2 * (2 * B * H * S * D + 2 * B * Kv * S * D)  # q, k, v read once, o written once
    bound_ms, bound_by = _bound_ms(4.0 * D * pairs * B * H, torch.bfloat16, nbytes)
    row = {
        "shape": [B, H, Kv, S, S, D], "dtype": "bfloat16", "window": W, "visible_pairs_per_head": pairs,
        **check, "repeat_bit_identical": True, "route": "wgmma", "ms": ms, "before_route": "mma",
        "before_ms": before_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "library": "scaled_dot_product_attention(bool mask, enable_gqa=True)",
        "bound_ms": bound_ms, "bound_by": bound_by, "tflops": 4.0 * D * pairs * B * H / (ms * 1e-3) / 1e12,
        "before_tflops": 4.0 * D * pairs * B * H / (before_ms * 1e-3) / 1e12,
    }
    emit({"phase": "kernels", "kernel": "flash_attention", "timing": row})
    return row


def _rglru_timing() -> dict:
    """rglru_scan at the serve path's shape: B=4, S=4096, D=2560, fp32, h0.
    The ``"chunked"`` route, then the ``"serial"`` route it replaced
    ("before"), in the same run.  The check's own power: the plain version
    with the carry reset to zero at the chunk boundary in mid-sequence (a
    kernel that loses one carry) must fail it."""
    cfg = get_config(SERVE_ARCH)
    B, S, D = SERVE_BATCH, SERVE_PROMPT, cfg.d_rnn
    log_a, b, h0 = _rglru_operands(B, S, D, True, seed=8)
    got = rglru_scan(log_a, b, h0, impl="cuda", bs=None, bd=None)
    again = rglru_scan(log_a, b, h0, impl="cuda", bs=None, bd=None)
    want = rglru_scan_ref(log_a, b, h0)
    torch.cuda.synchronize()
    ok, max_err = _close(got, want, 1e-5)
    if not ok:
        raise SystemExit("chip_smoke: rglru_scan disagrees with its plain version at the serve shape")
    if not torch.equal(got, again):
        raise SystemExit("chip_smoke: two rglru_scan launches at the serve shape differ")
    t = chunk_steps() * (S // chunk_steps() // 2)  # a chunk boundary in mid-sequence
    fault = torch.cat([want[:, :t], rglru_scan_ref(log_a[:, t:], b[:, t:], None)], dim=1)
    fault_passes, fault_err = _close(got, fault, 1e-5)
    if fault_passes:
        raise SystemExit("chip_smoke: the rglru_scan check cannot tell a carry lost at a chunk boundary")
    del got, again, fault
    launch = lambda route: lambda: rglru_scan_cuda(log_a, b, h0, bs=None, bd=None, route=route)  # noqa: E731
    ms = _routes_timed(rglru_scan_cuda, "chunked", launch("chunked"), 20)
    before_ms = _routes_timed(rglru_scan_cuda, "serial", launch("serial"), 20)
    plain_ms = cuda_ms(lambda: rglru_scan_ref(log_a, b, h0), 3)
    nbytes = 4 * (3 * B * S * D + B * D)  # log_a, b read once, h written once, h0 read once
    bound_ms, bound_by = _bound_ms(3.0 * B * S * D, torch.float32, nbytes)  # exp, multiply, add
    row = {
        "shape": [B, S, D], "dtype": "float32", "h0": True, "max_abs_err": max_err,
        "repeat_bit_identical": True, "carry_lost_at_step": t, "carry_lost_max_abs_err": fault_err,
        "route": "chunked", "ms": ms, "before_route": "serial", "before_ms": before_ms,
        "plain_ms": plain_ms, "library_ms": None,
        "library": "none: no single PyTorch call computes a linear recurrence",
        "bound_ms": bound_ms, "bound_by": bound_by, "gbps": nbytes / (ms * 1e-3) / 1e9,
        "before_gbps": nbytes / (before_ms * 1e-3) / 1e9,
    }
    emit({"phase": "kernels", "kernel": "rglru_scan", "timing": row})
    return row


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
    matmul_update_cuda.launches_by_route = dict.fromkeys(matmul_update_cuda.launches_by_route, 0)
    t0 = time.perf_counter()
    res = sched.autotune(executor, DFPA_UNITS, DFPA_EPS, min_units=1)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = matmul_update_cuda.launches
    routes = dict(matmul_update_cuda.launches_by_route)

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
        "launches": launches, "launches_by_route": routes, "expected_launches": expected, "wall_s": wall_s,
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
    if routes != {"tile": 0, "wgmma": launches}:
        raise SystemExit(f"chip_smoke: the DFPA panels launched {routes}, not every one on 'wgmma'")
    if median_imb > 2 * DFPA_EPS:
        raise SystemExit(f"chip_smoke: the final distribution re-measures at imbalance {median_imb}")
    return launches, routes


# ---------------------------------------------------------------------------


def _rel(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


class _Capture:
    """Records the inputs of the last ``ops.flash_attention`` and
    ``ops.rglru_scan`` call (the model calls them through ``ops``) while
    active, and passes every call on unchanged."""

    def __init__(self):
        self.seen = {}
        self._orig = (ops.flash_attention, ops.rglru_scan)

    def __enter__(self):
        fa, rg = self._orig

        def flash(q, k, v, **kw):
            self.seen["flash_attention"] = (q.clone(), k.clone(), v.clone(), kw)
            return fa(q, k, v, **kw)

        def scan(log_a, b, h0=None, **kw):
            self.seen["rglru_scan"] = (log_a.clone(), b.clone(), None if h0 is None else h0.clone(), kw)
            return rg(log_a, b, h0, **kw)

        ops.flash_attention, ops.rglru_scan = flash, scan
        return self

    def __exit__(self, *exc):
        ops.flash_attention, ops.rglru_scan = self._orig
        return False


def _serve_full(out: dict) -> dict:
    cfg = get_config(SERVE_ARCH)
    g = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    model = init_lm(cfg, g, "cuda")
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["params"] = sum(p.numel() for p in model.parameters())
    out["param_bytes"] = sum(p.numel() * p.element_size() for p in model.parameters())
    eng = ServeEngine(cfg, model, batch=SERVE_BATCH, seq_budget=SERVE_PROMPT + SERVE_NEW, device="cuda")
    gp = torch.Generator(device="cuda").manual_seed(1)
    seq = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT + 1), generator=gp, device="cuda")
    prompt = seq[:, :SERVE_PROMPT]

    def timed_generate(new):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        toks = eng.generate(prompt, new)
        end.record()
        end.synchronize()
        return toks, start.elapsed_time(end)

    # the main path: one generate, the kernels' counts read around it
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention_cuda.launches = rglru_scan_cuda.launches = matmul_update_cuda.launches = 0
    for wrapper in (flash_attention_cuda, rglru_scan_cuda):
        wrapper.launches_by_route = dict.fromkeys(wrapper.launches_by_route, 0)
    tokens, ms = timed_generate(SERVE_NEW)
    launches = {
        "flash_attention": flash_attention_cuda.launches, "rglru_scan": rglru_scan_cuda.launches,
        "matmul_update": matmul_update_cuda.launches,
    }
    out["launches"] = launches
    out["launches_by_route"] = {
        "flash_attention": dict(flash_attention_cuda.launches_by_route),
        "rglru_scan": dict(rglru_scan_cuda.launches_by_route),
    }
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    # two more generates, then three of one token (prefill and its argmax):
    # a decode step's time is the difference over the other new tokens
    gen_ms = [ms]
    for _ in range(2):
        again, ms = timed_generate(SERVE_NEW)
        gen_ms.append(ms)
        if not torch.equal(again, tokens):
            raise SystemExit("chip_smoke: two generate calls gave different tokens")
    prefill_ms = []
    for _ in range(3):
        first, ms = timed_generate(1)
        prefill_ms.append(ms)
        if not torch.equal(first[:, 0], tokens[:, 0]):
            raise SystemExit("chip_smoke: generate of one token differs from the first of 32")
    out["generate_ms_runs"] = gen_ms
    out["prefill_ms_runs"] = prefill_ms
    out["prefill_ms"] = float(np.median(prefill_ms))
    out["prefill_ms_before_redesign_earlier_run"] = PREFILL_MS_BEFORE
    out["decode_ms_per_token"] = (float(np.median(gen_ms)) - out["prefill_ms"]) / (SERVE_NEW - 1)
    out["tok_per_s"] = SERVE_BATCH * SERVE_NEW / (float(np.median(gen_ms)) / 1e3)
    out["prefill_tok_per_s"] = SERVE_BATCH * SERVE_PROMPT / (out["prefill_ms"] / 1e3)
    out["decode_tok_per_s"] = SERVE_BATCH / (out["decode_ms_per_token"] / 1e3)
    out["tokens_identical"] = True
    out["sample"] = tokens[0, :8].tolist()
    if launches["flash_attention"] != SERVE_LAUNCHES["flash_attention"] or launches["rglru_scan"] != SERVE_LAUNCHES["rglru_scan"]:
        raise SystemExit(f"chip_smoke: one generate launched {launches}, expected {SERVE_LAUNCHES}")
    if out["launches_by_route"]["flash_attention"]["wgmma"] != SERVE_LAUNCHES["flash_attention"]:
        raise SystemExit(f"chip_smoke: one generate's flash launches went {out['launches_by_route']}, not all 'wgmma'")
    if out["launches_by_route"]["rglru_scan"]["chunked"] != SERVE_LAUNCHES["rglru_scan"]:
        raise SystemExit(f"chip_smoke: one generate's scans went {out['launches_by_route']}, not all 'chunked'")

    with torch.inference_mode():
        # prefill(4096) + decode_step against the full forward over 4097 tokens
        hid, _, _ = apply_lm(model, cfg, seq, torch.arange(SERVE_PROMPT + 1, device="cuda"))
        full = lm_logits(model, cfg, hid[:, -1])
        del hid
        caches = init_cache(cfg, SERVE_BATCH, SERVE_PROMPT + SERVE_NEW, cfg.dtype, "cuda")
        with _Capture() as cap:
            _, caches = prefill(model, cfg, prompt, caches)
        step, _ = decode_step(model, cfg, seq[:, SERVE_PROMPT:], SERVE_PROMPT, caches)
        del caches
        out["decode_vs_full_rel"] = _rel(step, full)
        if not out["decode_vs_full_rel"] < 0.05:
            raise SystemExit(f"chip_smoke: prefill + decode differs from the full forward (rel {out['decode_vs_full_rel']})")

        # the kernels' inputs from that prefill (the last local and the last
        # rec layer), kernel against plain version on the card
        q, k, v, kw = cap.seen["flash_attention"]
        check = _check_serve_flash(flash_attention(q, k, v, impl="cuda", **kw), q, k, v, kw, "on the prefill's own inputs")
        out["captured_flash"] = {"shape": list(q.shape), "dtype": _dtype_name(q.dtype), **check}
        log_a, b, h0, kw = cap.seen["rglru_scan"]
        ok2, err2 = _close(rglru_scan(log_a, b, h0, impl="cuda", **kw), rglru_scan_ref(log_a, b, h0), 1e-5)
        out["captured_rglru"] = {"shape": list(log_a.shape), "h0": h0 is not None, "max_abs_err": err2, "ok": ok2}
        if not ok2:
            raise SystemExit("chip_smoke: rglru_scan disagrees with its plain version on the prefill's own inputs")
    return out


def _serve_smoke(out: dict) -> None:
    """The smoke-width model in float32: the card (kernels) gives the CPU's
    tokens (plain versions), logits within rel 1e-4."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out["tf32"] = {"matmul": torch.backends.cuda.matmul.allow_tf32, "cudnn": torch.backends.cudnn.allow_tf32}
    cfg = get_smoke_config(SERVE_ARCH).replace(dtype=torch.float32)
    cpu_model = init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    gpu_model = LanguageModel.from_state_dict(cfg, {n: t.to("cuda") for n, t in cpu_model.state_dict().items()})
    prompt = torch.randint(0, cfg.vocab_size, (SMOKE_BATCH, SMOKE_PROMPT), generator=torch.Generator().manual_seed(1))
    budget = SMOKE_PROMPT + SMOKE_NEW
    want = ServeEngine(cfg, cpu_model, batch=SMOKE_BATCH, seq_budget=budget, device="cpu").generate(prompt, SMOKE_NEW)
    before = (flash_attention_cuda.launches, rglru_scan_cuda.launches)
    got = ServeEngine(cfg, gpu_model, batch=SMOKE_BATCH, seq_budget=budget, device="cuda").generate(prompt, SMOKE_NEW)
    launched = (flash_attention_cuda.launches - before[0], rglru_scan_cuda.launches - before[1])
    with torch.inference_mode():
        rels = []
        for model, dev in ((cpu_model, "cpu"), (gpu_model, "cuda")):
            toks = prompt.to(dev)
            hid, _, _ = apply_lm(model, cfg, toks, torch.arange(SMOKE_PROMPT, device=dev))
            rels.append(lm_logits(model, cfg, hid).cpu())
    rel = _rel(rels[1], rels[0])
    out["smoke"] = {
        "tokens_equal": bool(torch.equal(got.cpu(), want)), "logits_rel": rel,
        "launches_flash_rglru": list(launched), "tokens": got[0].tolist(),
    }
    if not out["smoke"]["tokens_equal"] or not rel < 1e-4 or min(launched) < 1:
        raise SystemExit(f"chip_smoke: the smoke model on the card differs from the CPU: {out['smoke']}")


def phase_serve() -> dict:
    out = {"phase": "serve", "arch": SERVE_ARCH, "batch": SERVE_BATCH, "prompt": SERVE_PROMPT, "new_tokens": SERVE_NEW}
    try:
        _serve_full(out)
        _serve_smoke(out)
    finally:
        emit(out)
    return out


def main() -> int:
    seconds = {}

    def run(name, fn):
        t0 = time.perf_counter()
        result = fn()
        seconds[name] = time.perf_counter() - t0
        emit({"phase": name, "seconds": seconds[name]})
        return result

    smi = run("device", phase_device)
    run("build", phase_build)
    timings = run("kernels", phase_kernels)
    run("bank", phase_bank)
    run("hcl_golden", phase_hcl_golden)
    dfpa_launches, dfpa_routes = run("dfpa", phase_dfpa)
    serve = run("serve", phase_serve)
    launches = {"matmul_update": dfpa_launches, **{k: serve["launches"][k] for k in SERVE_LAUNCHES}}
    routes = {"matmul_update": dfpa_routes, **serve["launches_by_route"]}
    sources = {
        "matmul_update": "src/repro/kernels/matmul_update.py:49",
        "flash_attention": "src/repro/kernels/flash_attention.py:93",
        "rglru_scan": "src/repro/kernels/rglru.py:48",
    }
    emit({"kernels": [{
        "name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{name}.cu",
        "replaces": sources[name], "launches": launches[name], "max_abs_err": row["max_abs_err"],
        "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        "shape": row["shape"], "dtype": row["dtype"],
        "launches_by_route": routes[name], "kernel_route": row["route"],
        **({"before_ms": row["before_ms"], "before_route": row["before_route"]} if "before_ms" in row else {}),
    } for name, row in timings.items()], "phase_seconds": seconds})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
