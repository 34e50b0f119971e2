"""Time flash_attention's "wgmma" route with and without K/V multicast on one NVIDIA H100.

    python3 tools/flash_mqa_probe.py [--passes 3] [--out chiprun_out/flash_mqa_probe.jsonl]

Run on a machine with the card.  Under MQA every query head of a KV head
reads the same K/V tiles.  This probe builds a variant of
``csrc/flash_attention.cu`` in which the blocks of two query heads of one
KV head (same batch row and query tile) form a cluster of two: each block
loads half of every K/V tile's 64-column panels and the TMA multicasts them
into both blocks, so each tile is read from L2 once for the pair.  A stage
is refilled only once the consumers of both blocks have released it.  A
group with an odd head count is padded: the padding block repeats the last
head's work for its partner's loads and stores nothing.

The variant is made from this checkout's source by the exact edits in
``EDITS`` (each must match once, so a changed kernel fails loudly here)
and compiled with the package's flags under ``build/flash_mqa_probe/``.
Its route 3 is the multicast kernel and its route 2 the shipped one.  The
probe then

1. holds route 3 against the plain version at bf16 tolerance (2e-2) on
   small cases (MQA, an odd group count, ragged lengths, a window, softcap,
   the model's transposed views), launched twice (bit-identical), and at
   the serve shape against ``chip_smoke.py``'s own check;
2. times, at the serve shape (B=4, H=10, Kv=1, Sq=Sk=4096, D=256, bf16,
   causal, window 2048), the package's ``"wgmma"`` route, the variant's
   route 2 and its route 3, interleaved (a, b, c, c, b, a) ``--passes``
   times, 10 launches each.

Every result is a JSON line on standard output and in ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch import _build  # noqa: E402
from repro_torch.kernels.ref import flash_attention_ref  # noqa: E402

# the module, not the function of the same name that the package exports
fa = importlib.import_module("repro_torch.kernels.flash_attention")
OUT_DIR = ROOT / "build" / "flash_mqa_probe"

_CLUSTER_HELPERS = r"""
// Arrives on the mbarrier at shared address `bar` of block `rank` of the cluster.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t rank) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(bar),
      "r"(rank)
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  return rank;
}

// Every thread of every block of the cluster.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The same box into the same shared address of every block of the cluster
// in `mask`, completing on each one's mbarrier at `bar`.
__device__ __forceinline__ void tma_load_4d_multicast(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                                      int c1, int c2, int c3, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
      "[%0], [%1, {%3, %4, %5, %6}], [%2], %7;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "h"(mask)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes.
"""

# (shipped text, variant text): each shipped text must occur exactly once.
EDITS = [
    ("\n// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes.\n", _CLUSTER_HELPERS),
    ("template <int D, bool CAP>\n__global__", "template <int D, bool CAP, int CLUSTER>\n__global__"),
    ("                    Problem p, int BH) {", "                    Problem p, int B) {"),
    (
        "  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / BH) * BM;\n"
        "  const int bh = static_cast<int>(blockIdx.x) % BH;\n"
        "  const int b = bh / p.H, head = bh % p.H, kvh = head / p.G;\n",
        "  const int G2 = (p.G + CLUSTER - 1) / CLUSTER * CLUSTER;  // heads of a KV group, padded\n"
        "  const int per_qt = B * (p.H / p.G) * G2;\n"
        "  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / per_qt) * BM;\n"
        "  const int rest = static_cast<int>(blockIdx.x) % per_qt;\n"
        "  const int g = rest % G2, kvh = rest / G2 % (p.H / p.G), b = rest / G2 / (p.H / p.G);\n"
        "  const int head = kvh * p.G + min(g, p.G - 1);\n"
        "  const bool store = g < p.G;\n",
    ),
    (
        "      mbar_init(k_empty + 8 * s, 8);  // lane 0 of every consumer warp\n"
        "      mbar_init(v_empty + 8 * s, 8);\n",
        "      mbar_init(k_empty + 8 * s, 8 * CLUSTER);  // lane 0 of every consumer warp of the cluster\n"
        "      mbar_init(v_empty + 8 * s, 8 * CLUSTER);\n",
    ),
    (
        "  }\n  __syncthreads();\n\n  if (threadIdx.x >= 256) {",
        "  }\n"
        "  if constexpr (CLUSTER > 1) {\n"
        "    cluster_sync();  // every block's barriers exist before any block loads into it\n"
        "  } else {\n"
        "    __syncthreads();\n"
        "  }\n"
        "  const uint32_t rank = CLUSTER > 1 ? cluster_rank() : 0;\n\n"
        "  if (threadIdx.x >= 256) {",
    ),
    (
        "        mbar_expect_tx(full, L::TILE);\n"
        "        for (int c = 0; c < L::DP / 64; ++c) tma_load_4d(dst + c * PANEL, map, full, 64 * c, k0, kvh, b);\n",
        "        mbar_expect_tx(full, L::TILE);  // the whole tile lands here, whichever block loaded a panel\n"
        "        for (int c = rank; c < L::DP / 64; c += CLUSTER) {\n"
        "          if constexpr (CLUSTER > 1) {\n"
        "            tma_load_4d_multicast(dst + c * PANEL, map, full, 64 * c, k0, kvh, b, (1u << CLUSTER) - 1);\n"
        "          } else {\n"
        "            tma_load_4d(dst + c * PANEL, map, full, 64 * c, k0, kvh, b);\n"
        "          }\n"
        "        }\n",
    ),
    (
        "        load(ks + L::TILE, &tmV, v_full + 8 * s, (t_lo + i) * BN);\n      }\n",
        "        load(ks + L::TILE, &tmV, v_full + 8 * s, (t_lo + i) * BN);\n      }\n"
        "      if constexpr (CLUSTER > 1) {\n"
        "        // Stay until every consumer of the cluster has released every\n"
        "        // stage: they arrive on this block's barriers to the last tile.\n"
        "        for (int i = n_tiles; i < n_tiles + L::STAGES; ++i) {\n"
        "          const uint32_t free_parity = ((i / L::STAGES) & 1) ^ 1;\n"
        "          mbar_wait(k_empty + 8 * (i % L::STAGES), free_parity);\n"
        "          mbar_wait(v_empty + 8 * (i % L::STAGES), free_parity);\n"
        "        }\n"
        "      }\n",
    ),
    (
        "      if (lane == 0) mbar_arrive(empty + 8 * (i % L::STAGES));\n",
        "      if (lane == 0) {\n"
        "        if constexpr (CLUSTER > 1) {\n"
        "#pragma unroll\n"
        "          for (int r = 0; r < CLUSTER; ++r) mbar_arrive_cluster(empty + 8 * (i % L::STAGES), r);\n"
        "        } else {\n"
        "          mbar_arrive(empty + 8 * (i % L::STAGES));\n"
        "        }\n"
        "      }\n",
    ),
    ("      if (row >= p.Sq) continue;\n      __nv_bfloat16* dst = Ob",
     "      if (!store || row >= p.Sq) continue;\n      __nv_bfloat16* dst = Ob"),
    ("template <int D>\nint launch_wgmma(", "template <int D, int CLUSTER>\nint launch_wgmma("),
    (
        "  auto kernel = p.softcap > 0.0f ? wg::flash_fwd_wgmma<D, true> : wg::flash_fwd_wgmma<D, false>;",
        "  auto kernel = p.softcap > 0.0f ? wg::flash_fwd_wgmma<D, true, CLUSTER> : wg::flash_fwd_wgmma<D, false, CLUSTER>;",
    ),
    (
        "  const long long blocks = (long long)((p.Sq + wg::BM - 1) / wg::BM) * B * p.H;\n",
        "  const int G2 = (p.G + CLUSTER - 1) / CLUSTER * CLUSTER;\n"
        "  const long long blocks = (long long)((p.Sq + wg::BM - 1) / wg::BM) * B * Kv * G2;\n",
    ),
    (
        "  kernel<<<static_cast<unsigned>(blocks), wg::THREADS, L::BYTES, s>>>(static_cast<__nv_bfloat16*>(o), tmQ, tmK,\n"
        "                                                                       tmV, p, B * p.H);\n"
        "  return static_cast<int>(cudaGetLastError());\n",
        "  cudaLaunchConfig_t cfg = {};\n"
        "  cfg.gridDim = dim3(static_cast<unsigned>(blocks));\n"
        "  cfg.blockDim = dim3(wg::THREADS);\n"
        "  cfg.dynamicSmemBytes = L::BYTES;\n"
        "  cfg.stream = s;\n"
        "  cudaLaunchAttribute attr[1];\n"
        "  attr[0].id = cudaLaunchAttributeClusterDimension;\n"
        "  attr[0].val.clusterDim.x = CLUSTER;\n"
        "  attr[0].val.clusterDim.y = 1;\n"
        "  attr[0].val.clusterDim.z = 1;\n"
        "  cfg.attrs = attr;\n"
        "  cfg.numAttrs = CLUSTER > 1 ? 1 : 0;\n"
        "  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, static_cast<__nv_bfloat16*>(o), tmQ, tmK, tmV, p, B));\n",
    ),
    ("  if (route == 2) {\n", "  if (route == 2 || route == 3) {  // route 3: K/V shared in clusters of two\n"),
]
for _d in (64, 128, 160, 192, 256):
    EDITS.append((
        f"      case {_d}: return launch_wgmma<{_d}>(q, k, v, out, p, B, Kv, s);\n",
        f"      case {_d}: return route == 2 ? launch_wgmma<{_d}, 1>(q, k, v, out, p, B, Kv, s)\n"
        f"                                   : launch_wgmma<{_d}, 2>(q, k, v, out, p, B, Kv, s);\n",
    ))

# (B, H, Kv, Sq, Sk, D, kwargs) at bf16, as chip_smoke's flash cases
CASES = [
    (1, 10, 1, 130, 130, 256, dict(causal=True, window=70, scale=0.0625)),  # MQA, a window
    (2, 3, 1, 97, 161, 256, dict(causal=True, window=50)),  # an odd group count, ragged
    (1, 2, 1, 190, 190, 256, dict(causal=True, softcap=30.0)),
    (2, 10, 1, 333, 333, 256, dict(causal=True, window=100, scale=0.0625)),
    (1, 4, 2, 128, 128, 128, dict(causal=True)),  # GQA at head_dim 128
    (1, 2, 2, 128, 128, 64, dict(causal=False)),
]


def variant_source(shipped: str) -> str:
    for old, new in EDITS:
        n = shipped.count(old)
        if n != 1:
            raise SystemExit(f"flash_mqa_probe: an edit matches {n} times, not once:\n{old}")
        shipped = shipped.replace(old, new)
    return shipped


def build_variant() -> ctypes.CDLL:
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    src = OUT_DIR / "flash_attention_mqa.cu"
    src.write_text(variant_source((_build.CSRC / "flash_attention.cu").read_text()))
    lib = OUT_DIR / "libflash_attention_mqa.so"
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)]
    res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        raise SystemExit(f"flash_mqa_probe: nvcc failed:\n{res.stdout}")
    emit({"build": [ln.strip() for ln in res.stdout.splitlines() if "registers" in ln or "spill" in ln]})
    out = ctypes.CDLL(str(lib))
    out.flash_attention.argtypes = fa._lib().flash_attention.argtypes
    out.flash_attention.restype = ctypes.c_int
    return out


_sink = None


def emit(obj) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    if _sink is not None:
        _sink.write(line + "\n")
        _sink.flush()


def launch(lib, route, q, k, v, causal=True, window=0, softcap=0.0, scale=None):
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
        raise SystemExit(f"flash_mqa_probe: route {route} refused the launch (cudaError {err})")
    return out


def main() -> None:
    global _sink
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "flash_mqa_probe.jsonl"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("flash_mqa_probe: needs a CUDA device")
    pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    _sink = open(args.out, "w")
    emit({"device": torch.cuda.get_device_name(0), "nvidia_smi": cs.nvidia_smi()})
    shipped, variant = fa._lib(), build_variant()

    for B, H, Kv, Sq, Sk, D, kw in CASES:
        q, k, v = cs._flash_operands(B, H, Kv, Sq, Sk, D, torch.bfloat16, seed=Sq + D)
        want = flash_attention_ref(q, k, v, **kw)
        got, again = launch(variant, 3, q, k, v, **kw), launch(variant, 3, q, k, v, **kw)
        torch.cuda.synchronize()
        ok, err = cs._close(got, want, 2e-2)
        emit({"case": [B, H, Kv, Sq, Sk, D, kw], "multicast_ok": ok, "max_abs_err": err,
              "repeat_bit_identical": torch.equal(got, again)})
        if not ok or not torch.equal(got, again):
            raise SystemExit("flash_mqa_probe: the multicast variant is wrong")
    g = torch.Generator(device="cuda").manual_seed(5)
    B, S, H, D = 2, 300, 10, 256
    q = (0.3 * torch.randn(B, S, H, D, generator=g, device="cuda")).bfloat16().transpose(1, 2)
    k = (0.3 * torch.randn(B, S, 1, D, generator=g, device="cuda")).bfloat16().transpose(1, 2)
    v = torch.randn(B, S, 1, D, generator=g, device="cuda").bfloat16().transpose(1, 2)
    ok, err = cs._close(launch(variant, 3, q, k, v, window=90),
                        flash_attention_ref(q.contiguous(), k.contiguous(), v.contiguous(), causal=True, window=90), 2e-2)
    emit({"views": [B, H, 1, S, S, D], "multicast_ok": ok, "max_abs_err": err})
    if not ok:
        raise SystemExit("flash_mqa_probe: the multicast variant is wrong on the model's views")

    cfg = cs.get_config(cs.SERVE_ARCH)
    q, k, v = cs._flash_operands(cs.SERVE_BATCH, cfg.num_heads, cfg.num_kv_heads, cs.SERVE_PROMPT, cs.SERVE_PROMPT,
                                 cfg.head_dim, torch.bfloat16, seed=7)
    kw = dict(causal=True, window=cfg.window, scale=cfg.query_scale)
    check = cs._check_serve_flash(launch(variant, 3, q, k, v, **kw), q, k, v, dict(kw, softcap=0.0), "mqa probe")
    emit({"serve_check": {k2: v2 for k2, v2 in check.items() if k2 != "max_abs_err_vs_fp32"}})
    runs = {"package wgmma": (shipped, 2), "variant cluster 1": (variant, 2), "variant cluster 2 (multicast)": (variant, 3)}
    names = list(runs)
    times = {n: [] for n in names}
    for _ in range(args.passes):
        for n in names + names[::-1]:
            lib, route = runs[n]
            times[n].append(cs.cuda_ms(lambda: launch(lib, route, q, k, v, **kw), 10))
    emit({"serve_shape": list(q.shape) + [k.shape[1]], "ms": times,
          "range_ms": {n: [min(t), max(t)] for n, t in times.items()}})
    _sink.close()


if __name__ == "__main__":
    main()
