"""Time flash_attention's "wgmma" route at head_dim 160 and 192 in its design variants on one NVIDIA H100.

    python3 tools/flash_headdim_probe.py [--passes 3] [--parent DIR] [--wide-only]
                                         [--out chiprun_out/flash_headdim_probe.jsonl]

Run on a machine with the card, from the root of a checkout.  The kernel
serves head_dim 160 (stablelm-12b) and 192 (deepseek-v2's MLA scores, ``v``
zero-padded from 128) with ``wg::WIDE_STAGES`` K/V tiles in flight
(``csrc/flash_attention.cu``).  Two other settings exist only here: D =
160's P V at n = 192 over the zero-filled third panel instead of n = 160,
and the blocks' order with the query tiles of ``head_chunk`` (b, head)
pairs side by side (heaviest tile first within a chunk) instead of all
heads of one query tile, so that under MHA (MLA's H = Kv, where no two
heads share K/V) the blocks in flight share their K/V tiles in L2.  This
probe compiles this checkout's source once per setting in ``VARIANTS``
(the lines rewritten, each must match as often as ``_edit`` is told) with
the package's flags under ``build/flash_headdim_probe/``, all ``nvcc``
processes at once, and with ``--parent DIR`` also the source of the
checkout unpacked at ``DIR`` (its route numbering and C interface must be
this one's).  Then it

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

Every result is a JSON line on standard output and in ``--out``; the card's
name and power limit come first.
"""

from __future__ import annotations

import argparse
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

# name: (WIDE_STAGES, P V over the padded width, head_chunk; 0 keeps the shipped order)
VARIANTS = {
    "stages 2, pv n=D": (2, False, 0),
    "stages 3, pv n=D": (3, False, 0),
    "stages 3, pv n=192": (3, True, 0),
    "stages 3, pv n=D, heads in chunks of 16": (3, False, 16),
}
_STAGES = "constexpr int WIDE_STAGES = "
_PADDED_PV = [  # (shipped, variant, occurrences): the accumulator and P V at n = DP
    ("float o[D / 2];", "float o[L::DP / 2];", 1),
    ("for (int e = 0; e < D / 2; ++e)", "for (int e = 0; e < L::DP / 2; ++e)", 2),
    ("issue_pv<D>(", "issue_pv<L::DP>(", 2),
]
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


def variant_source(shipped: str, stages: int, padded: bool, head_chunk: int) -> str:
    lines = [ln for ln in shipped.splitlines(keepends=True) if ln.startswith(_STAGES)]
    if len(lines) != 1:
        raise SystemExit(f"flash_headdim_probe: {_STAGES!r} starts {len(lines)} lines, not one")
    src = shipped.replace(lines[0], f"{_STAGES}{stages};\n")
    for old, new, count in _PADDED_PV if padded else []:
        src = _edit(src, old, new, count)
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
        emit({"build": name, "seconds": time.perf_counter() - t0,
              "ptxas": [ln.strip() for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln or "entry function" in ln]})
        lib = ctypes.CDLL(str(path))
        lib.flash_attention.argtypes = package.flash_attention.argtypes
        lib.flash_attention.restype = ctypes.c_int
        libs[name] = lib
    return package, libs


def launch(lib, q, k, v, causal=True, window=0, softcap=0.0, scale=None):
    B, H, Sq, D = q.shape
    Kv, Sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    err = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *strides, B, H, Kv, Sq, Sk, D,
        float(D ** -0.5 if scale is None else scale), float(softcap), int(causal), int(window), 1, WGMMA,
        torch.cuda.current_stream().cuda_stream,
    )
    if err != 0:
        raise SystemExit(f"flash_headdim_probe: the wgmma route refused the launch (cudaError {err})")
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


def check(libs: dict) -> None:
    for B, H, Kv, S, D, v_dim, kw, views in CASES:
        q, k, v = operands(B, H, Kv, S, D, v_dim, views, seed=S + D)
        want = flash_attention_ref(q.contiguous(), k.contiguous(), v.contiguous(), **kw)
        row = {"case": [B, H, Kv, S, D, v_dim, kw, views]}
        for name, lib in libs.items():
            got, again = launch(lib, q, k, v, **kw), launch(lib, q, k, v, **kw)
            torch.cuda.synchronize()
            ok, err = cs._close(got, want, 2e-2)
            same = torch.equal(got, again)
            zero = not got[..., v_dim:].any()
            row[name] = {"ok": ok, "max_abs_err": err, "repeat_bit_identical": same, "padded_columns_zero": zero}
            if not (ok and same and zero):
                emit(row)
                raise SystemExit(f"flash_headdim_probe: {name} is wrong at {row['case']}")
        emit(row)


def time_shapes(shapes, libs: dict, passes: int, yardsticks: bool) -> None:
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for what, B, H, Kv, S, D, v_dim, kw in shapes:
        q, k, v = operands(B, H, Kv, S, D, v_dim, True, seed=S + D + 1)
        names = list(libs)
        times = {n: [] for n in names}
        plain, library = [], []
        for _ in range(passes):
            for n in names + names[::-1]:
                times[n].append(cs.cuda_ms(lambda: launch(libs[n], q, k, v, **kw), 10))
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


def main() -> None:
    global _sink
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--parent", default="", help="a checkout root whose flash kernel is timed at head_dim 256")
    ap.add_argument("--wide-only", action="store_true", help="time head_dim 160 and 192 only")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "flash_headdim_probe.jsonl"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("flash_headdim_probe: needs a CUDA device")
    pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    _sink = open(args.out, "w")
    emit({"device": torch.cuda.get_device_name(0), "nvidia_smi": cs.nvidia_smi()})
    shipped = (_build.CSRC / "flash_attention.cu").read_text()
    sources = {name: variant_source(shipped, *knobs) for name, knobs in VARIANTS.items()}
    if args.parent:
        sources["parent"] = (pathlib.Path(args.parent) / "src/repro_torch/csrc/flash_attention.cu").read_text()
    t0 = time.perf_counter()
    package, built = build(sources)
    emit({"built_seconds": time.perf_counter() - t0})
    parent = built.pop("parent", None)
    check(built)
    time_shapes(WIDE_SHAPES, {"package": package, **built}, args.passes, yardsticks=True)
    if not args.wide_only:
        time_shapes(HEAD256_SHAPES, {"package": package, **({"parent": parent} if parent else {})}, args.passes,
                    yardsticks=False)
    _sink.close()


if __name__ == "__main__":
    main()
