"""Time flash_attention's "wgmma" route at head_dim 160 and 192, or 16 and 32, in its design variants on one NVIDIA H100.

    python3 tools/flash_headdim_probe.py [--passes 3] [--parent DIR] [--wide-only] [--small]
                                         [--out chiprun_out/flash_headdim_probe.jsonl]

Run on a machine with the card, from the root of a checkout.  The kernel
serves head_dim 160 (stablelm-12b) and 192 (deepseek-v2's MLA scores, ``v``
zero-padded from 128) with ``wg::WIDE_STAGES`` K/V tiles in flight
(``csrc/flash_attention.cu``).  Three other settings exist only here, as
edits of the source's text: P V over the zero-filled rest of the last
panel (``pv_padded``: n = 192 at D = 160, n = 64 at D = 16 and 32)
instead of n = D; ``small_stages`` K/V tiles in flight at D = 16 and 32
instead of 2; and the blocks' order with the query tiles of
``head_chunk`` (b, head) pairs side by side (heaviest tile first within a
chunk) instead of all heads of one query tile, so that under MHA (MLA's H
= Kv, where no two heads share K/V) the blocks in flight share their K/V
tiles in L2.  This probe compiles this checkout's source once per setting
in ``VARIANTS`` (the ``wg::`` constants set, the other settings' lines
rewritten, each as often as expected) with the package's flags under
``build/flash_headdim_probe/``, all ``nvcc`` processes at once, and with
``--parent DIR`` also the source of the checkout unpacked at ``DIR``.  A
parent's ``flash_attention`` entry must take this one's arguments; its
route numbering is read from its own ``kernels/flash_attention.py``.  Every
variant's library must pass the package's register check
(``check_register_split``) before it runs.  Then it

1. holds every variant of this checkout against the plain version at bf16
   tolerance (2e-2) on small cases at D 160 and 192 (GQA, ragged lengths,
   a window, softcap, the model's transposed views, MLA's padded ``v``, whose
   output columns must stay zero), launched twice (bit-identical);
2. times, interleaved (a, b, ..., b, a) ``--passes`` times, 10 launches
   each: the package's own build and every variant at stablelm-12b's and
   deepseek-v2's prefill shapes (batch 2 x 1,024 tokens, causal), with the
   plain version and ``scaled_dot_product_attention`` (``is_causal``,
   ``enable_gqa``) once a pass; and, unless ``--wide-only``, the package
   beside the parent at head_dim 256 (the serve shape and gemma2-2b's
   prefill shape), where nothing should have moved.

``--small`` does the same for head_dim 16 and 32 over ``SMALL_VARIANTS``
(``wg::SMALL_BLOCKS`` an SM, ``pv_padded``, ``small_stages``): the checks at ``SMALL_CASES``,
then the timings at ``SMALL_SHAPES`` (the model twins' captured shapes,
the reference's MQA case and a shape where the card sets the time) beside
the ``"mma"`` route (``mma.sync``, the first port's kernel, which this
head dim took until the ``"wgmma"`` kernel took it over) of ``--parent``,
which must be a checkout that still has that route, the plain version and
SDPA.  At the captured shapes it also splits one call: the
wrapper's ``flash_attention_cuda`` (CUDA events around back-to-back
calls), a bare ctypes launch, and the kernel's device time from
``torch.profiler``.

Every result is a JSON line on standard output and in ``--out``; the card's
name and power limit come first.
"""

from __future__ import annotations

import argparse
import ast
import ctypes
import importlib
import json
import pathlib
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch import _build  # noqa: E402
from repro_torch.kernels.ref import flash_attention_ref  # noqa: E402

# the module, not the function of the same name that the package exports
fa = importlib.import_module("repro_torch.kernels.flash_attention")
OUT_DIR = ROOT / "build" / "flash_headdim_probe"
WGMMA = fa.ROUTES.index("wgmma")

# name: the wg:: constants a variant sets, and the text edits of variant_source
VARIANTS = {
    "stages 2, pv n=D": dict(WIDE_STAGES=2),
    "stages 3, pv n=D": dict(WIDE_STAGES=3),
    "stages 3, pv n=192": dict(WIDE_STAGES=3, pv_padded=True),
    "stages 3, pv n=D, heads in chunks of 16": dict(WIDE_STAGES=3, head_chunk=16),
}
SMALL_VARIANTS = {
    "pv n=D, stages 2, 1 block": dict(SMALL_BLOCKS=1),
    "pv n=64, stages 2, 1 block": dict(SMALL_BLOCKS=1, pv_padded=True),
    "pv n=D, stages 4, 1 block": dict(SMALL_BLOCKS=1, small_stages=4),
    "pv n=D, stages 2, 2 blocks": dict(SMALL_BLOCKS=2),
    "pv n=D, stages 4, 2 blocks": dict(SMALL_BLOCKS=2, small_stages=4),
}
_KNOBS = {  # constant: the start of its one line in the source
    "WIDE_STAGES": "constexpr int WIDE_STAGES = ", "SMALL_BLOCKS": "constexpr int SMALL_BLOCKS = ",
}
_ORDER = (
    "  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / BH) * BM;\n"
    "  const int bh = static_cast<int>(blockIdx.x) % BH;\n"
)
_CHUNKED = (
    "  constexpr int CH = {};  // (b, head) pairs a chunk: their query tiles run side by side\n"
    "  const int x = static_cast<int>(blockIdx.x), c = x / (CH * n_qt);\n"
    "  const int chs = min(CH, BH - c * CH), r = x - c * CH * n_qt;\n"
    "  const int q0 = (n_qt - 1 - r / chs) * BM;\n"
    "  const int bh = c * CH + r % chs;\n"
)

# (B, H, Kv, S, D, v_dim, kwargs, transposed views) at bf16
CASES = [
    (1, 8, 2, 300, 160, 160, dict(causal=True), True),  # stablelm's GQA 4, ragged, as the model calls it
    (2, 4, 1, 200, 160, 160, dict(causal=True, window=70, softcap=30.0), False),
    (1, 4, 2, 97, 160, 160, dict(causal=False), False),
    (2, 4, 4, 300, 192, 128, dict(causal=True, scale=192 ** -0.5), True),  # MLA: v padded from 128
    (1, 6, 2, 190, 192, 192, dict(causal=True, window=50), False),
]
# (what, B, H, Kv, S, D, v_dim, kwargs)
WIDE_SHAPES = [
    ("stablelm-12b prefill", 2, 32, 8, 1024, 160, 160, dict(causal=True)),
    ("deepseek-v2 MLA prefill", 2, 128, 128, 1024, 192, 128, dict(causal=True, scale=192 ** -0.5)),
]
# head_dim 16 and 32: the model twins' captured inputs, the reference's MQA
# case (tests/test_kernels.py:94), GQA with a window and softcap, MHA
# without a mask, ragged lengths
SMALL_CASES = [
    (2, 4, 2, 16, 16, 16, dict(causal=True), True),  # the smoke stablelm-12b served
    (2, 4, 1, 32, 16, 16, dict(causal=True), True),  # the smoke granite-20b trained, MQA
    (2, 4, 1, 128, 32, 32, dict(causal=True), False),  # the reference's MQA case
    (1, 8, 2, 300, 16, 16, dict(causal=True, window=70, softcap=30.0), False),
    (2, 4, 4, 200, 32, 32, dict(causal=False), True),
    (1, 6, 3, 97, 32, 32, dict(causal=True, window=50), False),
]
SMALL_SHAPES = [  # (what, B, H, Kv, S, D, v_dim, kwargs)
    ("smoke stablelm-12b served", 2, 4, 2, 16, 16, 16, dict(causal=True)),
    ("smoke granite-20b trained, MQA", 2, 4, 1, 32, 16, 16, dict(causal=True)),
    ("the reference's MQA case", 2, 4, 1, 128, 32, 32, dict(causal=True)),
    ("card-bound, D 16", 4, 32, 8, 4096, 16, 16, dict(causal=True)),
    ("card-bound, D 32", 4, 32, 8, 4096, 32, 32, dict(causal=True)),
]
CAPTURED = 2  # the first SMALL_SHAPES, where one call is split into host and card
HEAD256_SHAPES = [
    ("serve shape", 4, 10, 1, 4096, 256, 256, dict(causal=True, window=2048, scale=0.0625)),
    ("gemma2-2b prefill", 2, 8, 4, 8192, 256, 256, dict(causal=True, window=4096, softcap=50.0, scale=0.0625)),
]

_sink = None


def emit(obj) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    if _sink is not None:
        _sink.write(line + "\n")
        _sink.flush()


def _edit(src: str, old: str, new: str, count: int = 1) -> str:
    if src.count(old) != count:
        raise SystemExit(f"flash_headdim_probe: {old!r} occurs {src.count(old)} times, not {count}")
    return src.replace(old, new)


_STAGES = "static constexpr int STAGES = (D == 160 || D == 192) ? WIDE_STAGES : 2;"


def variant_source(shipped: str, head_chunk: int = 0, pv_padded: bool = False, small_stages: int = 0,
                   **knobs) -> str:
    src = shipped
    if pv_padded:  # the accumulator and P V over DP columns; the store still writes D
        src = _edit(_edit(src, "issue_pv<D>(", "issue_pv<L::DP>(", 2), "D / 2", "L::DP / 2", 3)
    if small_stages:
        src = _edit(src, _STAGES, _STAGES.replace(": 2;", f": D <= 32 ? {small_stages} : 2;"))
    for name, value in knobs.items():
        start = _KNOBS[name]
        lines = [ln for ln in src.splitlines(keepends=True) if ln.startswith(start)]
        if len(lines) != 1:
            raise SystemExit(f"flash_headdim_probe: {start!r} starts {len(lines)} lines, not one")
        src = src.replace(lines[0], f"{start}{value};\n")
    return _edit(src, _ORDER, _CHUNKED.format(head_chunk)) if head_chunk else src


def build(sources: dict) -> tuple:
    """Compile every ``{name: source text}`` at once, the package's own
    library among them; returns it and the loaded variants."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for i, (name, text) in enumerate(sources.items()):
        src = OUT_DIR / f"flash_attention_{i}.cu"
        src.write_text(text)
        lib = OUT_DIR / f"libflash_attention_{i}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)]
        running[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                         time.perf_counter())
    package = fa._lib()
    libs = {}
    for name, (path, proc, t0) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"flash_headdim_probe: nvcc failed for {name}:\n{log}")
        ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln or "entry function" in ln]
        emit({"build": name, "seconds": time.perf_counter() - t0, "ptxas": ptxas})
        lib = ctypes.CDLL(str(path))
        if name == "parent":  # another checkout's library: its launch entry only
            libs[name] = _build.set_signatures(lib, {"flash_attention": fa._SIGNATURES["flash_attention"]})
        else:
            fa.check_register_split(_build.set_signatures(lib, fa._SIGNATURES))
            libs[name] = lib
    return package, libs


def routes_of(root: pathlib.Path) -> tuple:
    """The ``ROUTES`` tuple of the checkout at ``root`` (the C entry's
    numbering), read from its source."""
    src = (root / "src/repro_torch/kernels/flash_attention.py").read_text()
    line = next(ln for ln in src.splitlines() if ln.startswith("ROUTES = "))
    return ast.literal_eval(line.split("=", 1)[1].split("#")[0].strip())


def launch(lib, q, k, v, causal=True, window=0, softcap=0.0, scale=None, route=WGMMA):
    B, H, Sq, D = q.shape
    Kv, Sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    err = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *strides, B, H, Kv, Sq, Sk, D,
        float(D ** -0.5 if scale is None else scale), float(softcap), int(causal), int(window), 1, route,
        torch.cuda.current_stream().cuda_stream,
    )
    if err != 0:
        raise SystemExit(f"flash_headdim_probe: route {route} refused the launch (cudaError {err})")
    return out


def operands(B, H, Kv, S, D, v_dim, views, seed):
    """bf16 q, k, v; ``v`` zero past ``v_dim``; transposed ``(B, S, H, D)``
    views when ``views``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = 0.3 * torch.randn(B, S, H, D, generator=g, device="cuda")
    k = 0.3 * torch.randn(B, S, Kv, D, generator=g, device="cuda")
    v = torch.nn.functional.pad(torch.randn(B, S, Kv, v_dim, generator=g, device="cuda"), (0, D - v_dim))
    q, k, v = (x.bfloat16().transpose(1, 2) for x in (q, k, v))
    return (q, k, v) if views else tuple(x.contiguous() for x in (q, k, v))


def check(libs: dict, cases=CASES, routes=None) -> None:
    routes = routes or {}
    for B, H, Kv, S, D, v_dim, kw, views in cases:
        q, k, v = operands(B, H, Kv, S, D, v_dim, views, seed=S + D)
        want = flash_attention_ref(q.contiguous(), k.contiguous(), v.contiguous(), **kw)
        row = {"case": [B, H, Kv, S, D, v_dim, kw, views]}
        for name, lib in libs.items():
            r = routes.get(name, WGMMA)
            got, again = launch(lib, q, k, v, route=r, **kw), launch(lib, q, k, v, route=r, **kw)
            torch.cuda.synchronize()
            ok, err = cs._close(got, want, 2e-2)
            same = torch.equal(got, again)
            zero = not got[..., v_dim:].any()
            row[name] = {"ok": ok, "max_abs_err": err, "repeat_bit_identical": same, "padded_columns_zero": zero}
            if not (ok and same and zero):
                emit(row)
                raise SystemExit(f"flash_headdim_probe: {name} is wrong at {row['case']}")
        emit(row)


def time_shapes(shapes, libs: dict, passes: int, yardsticks: bool, routes=None) -> None:
    """``libs`` by name, each launched on ``routes[name]`` (default the
    ``"wgmma"`` route of this checkout's numbering)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    routes = routes or {}
    for what, B, H, Kv, S, D, v_dim, kw in shapes:
        q, k, v = operands(B, H, Kv, S, D, v_dim, True, seed=S + D + 1)
        names = list(libs)
        times = {n: [] for n in names}
        plain, library = [], []
        for _ in range(passes):
            for n in names + names[::-1]:
                r = routes.get(n, WGMMA)
                times[n].append(cs.cuda_ms(lambda: launch(libs[n], q, k, v, route=r, **kw), 10))
            if yardsticks:
                plain.append(cs.cuda_ms(lambda: flash_attention_ref(q, k, v, **kw), 3))
                library.append(cs.cuda_ms(lambda: sdpa(q, k, v, is_causal=True, scale=kw.get("scale"),
                                                       enable_gqa=True), 10))
        bound_ms, bound_by, pairs = cs._flash_bound(B, H, Kv, S, D, kw.get("window", 0))
        row = {"shape": what, "B_H_Kv_S_D": [B, H, Kv, S, D], "kwargs": kw, "ms": times,
               "range_ms": {n: [min(t), max(t)] for n, t in times.items()},
               "bound_ms": bound_ms, "bound_by": bound_by, "visible_pairs_per_head": pairs}
        if yardsticks:
            row.update(plain_ms=plain, library_ms=library,
                       library="scaled_dot_product_attention(is_causal=True, enable_gqa=True)")
        emit(row)


def split_call(shapes) -> None:
    """One call at each shape three ways: ``flash_attention_cuda`` (the
    wrapper: the custom op, the route, the ctypes call), a bare ctypes
    launch of the package's library, each the median of 20 CUDA-event
    timings of 10 back-to-back calls; and the kernel's device time, the
    sum of the ``flash_fwd`` kernels' CUDA time over 50 bare launches in
    ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    package = fa._lib()
    for what, B, H, Kv, S, D, v_dim, kw in shapes:
        q, k, v = operands(B, H, Kv, S, D, v_dim, True, seed=S + D + 1)

        def wrapper():
            for _ in range(10):
                fa.flash_attention_cuda(q, k, v, bq=None, bk=None, **kw)

        def bare():
            for _ in range(10):
                launch(package, q, k, v, **kw)

        wrapper_ms, bare_ms = cs.cuda_ms(wrapper, 20) / 10, cs.cuda_ms(bare, 20) / 10
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(50):
                launch(package, q, k, v, **kw)
            torch.cuda.synchronize()
        kernel_us = sum(e.device_time_total for e in prof.key_averages() if "flash_fwd" in e.key)
        emit({"split": what, "B_H_Kv_S_D": [B, H, Kv, S, D], "wrapper_ms": wrapper_ms, "bare_launch_ms": bare_ms,
              "kernel_device_ms": kernel_us / 50 / 1e3 if kernel_us else None,
              "profiled_kernels": [e.key for e in prof.key_averages() if "flash_fwd" in e.key]})


def small(args, shipped: str) -> None:
    """``--small``: head_dim 16 and 32, the variants against each other
    and the ``"mma"`` route."""
    sources = {name: variant_source(shipped, **knobs) for name, knobs in SMALL_VARIANTS.items()}
    if not args.parent:
        raise SystemExit('flash_headdim_probe: --small needs --parent DIR, a checkout with the "mma" route')
    sources["parent"] = (pathlib.Path(args.parent) / "src/repro_torch/csrc/flash_attention.cu").read_text()
    mma_route = routes_of(pathlib.Path(args.parent)).index("mma")
    t0 = time.perf_counter()
    _, built = build(sources)
    mma = built.pop("parent")
    emit({"built_seconds": time.perf_counter() - t0})
    check(built, SMALL_CASES)
    check({"mma": mma}, SMALL_CASES, routes={"mma": mma_route})
    time_shapes(SMALL_SHAPES, {"mma": mma, **built}, args.passes, yardsticks=True, routes={"mma": mma_route})
    split_call(SMALL_SHAPES[:CAPTURED])


def main() -> None:
    global _sink
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--parent", default="", help="a checkout root whose flash kernel is timed at head_dim 256 "
                    "(with --small: whose \"mma\" route is timed)")
    ap.add_argument("--wide-only", action="store_true", help="time head_dim 160 and 192 only")
    ap.add_argument("--small", action="store_true", help="head_dim 16 and 32 against the \"mma\" route instead")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "flash_headdim_probe.jsonl"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("flash_headdim_probe: needs a CUDA device")
    pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    _sink = open(args.out, "w")
    emit({"device": torch.cuda.get_device_name(0), "nvidia_smi": cs.nvidia_smi()})
    shipped = (_build.CSRC / "flash_attention.cu").read_text()
    if args.small:
        small(args, shipped)
        _sink.close()
        return
    sources = {name: variant_source(shipped, **knobs) for name, knobs in VARIANTS.items()}
    if args.parent:
        sources["parent"] = (pathlib.Path(args.parent) / "src/repro_torch/csrc/flash_attention.cu").read_text()
    t0 = time.perf_counter()
    package, built = build(sources)
    emit({"built_seconds": time.perf_counter() - t0})
    parent = built.pop("parent", None)
    check(built)
    time_shapes(WIDE_SHAPES, {"package": package, **built}, args.passes, yardsticks=True)
    if not args.wide_only:
        routes = {"parent": routes_of(pathlib.Path(args.parent)).index("wgmma")} if parent else {}
        time_shapes(HEAD256_SHAPES, {"package": package, **({"parent": parent} if parent else {})}, args.passes,
                    yardsticks=False, routes=routes)
    _sink.close()


if __name__ == "__main__":
    main()
