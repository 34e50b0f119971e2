// flash_attention.cu — online-softmax attention, written by hand for Hopper
// (sm_90a), with a plain C entry point loaded through ctypes.
//
// Replaces src/repro/kernels/flash_attention.py:93 (flash_attention_pallas,
// body _kernel at :31): O = softmax(mask(softcap(scale · Q Kᵀ))) · V with
// GQA/MQA (query head h reads KV head h / (H/Kv)), causal and sliding-window
// masks over queries right-aligned to the keys (row i at position
// i + Sk − Sq), fp32 running max, sum and accumulator, P cast to V's dtype
// before the second product, output acc / max(l, 1e-30).  float32 and
// bfloat16; any (b, h, s) strides with a contiguous last dim.
//
// What bounds it on an H100.  Per (b, h) it does 4·D operations for every
// visible (query, key) pair: at the serving shape (B=4, H=10, Kv=1,
// Sq=Sk=4096, D=256, window 2048, bf16) that is 2.58e11 operations, 0.26 ms
// at 989 TFLOP/s, against 185 MB of Q, K, V and O, 0.055 ms at 3.35 TB/s:
// bound by the tensor cores.  MQA makes the ten query heads read one K/V
// head: K and V are re-read once per query tile and head, from L2.
//
// What the design does about it (route "wgmma": bf16, D of 16, 32, 64,
// 128, 160, 192 or 256, every pointer 16-byte aligned and every stride a
// positive multiple of 8 elements).  The TPU kernel walks the KV blocks of one
// query block in order on one core, carrying m, l and acc in VMEM scratch;
// here one block owns 128 query rows of one (b, h) and walks its visible
// 64-key tiles in order, carrying m, l and the 64 x D accumulator of each
// consumer warpgroup in registers (D/2 fp32 a thread).
//  * Warp roles: 384 threads.  Warpgroups 0 and 1 consume, 64 rows each,
//    and share every K/V tile, which halves the L2 traffic of 64-row
//    blocks; warpgroup 2 produces, one thread issuing TMA loads (128-byte
//    swizzle, 64 x 64 boxes) of Q once and of K and V tiles into a 2-stage
//    ring.  K and V have their own full and empty mbarriers, so Q Kᵀ starts
//    before V lands and a K slot is refilled while its V is still read.
//    setmaxnreg gives the consumers 240 registers and the producer 24:
//    ptxas counts a 288-thread block as 384 and capped the accumulator's
//    threads at 168 registers, which spilled.  A split needs every
//    register it hands out to have been given at launch, or the consumers
//    wait forever: the wrapper refuses a library whose ptxas gave fewer
//    (flash_attention_wgmma_registers).
//  * Both products are wgmma: S = Q Kᵀ as m64n64k16 with Q and K K-major
//    in shared memory; O += P V as m64nDk16 with P from registers (the
//    accumulator's layout is the A operand's, so P is packed to bf16 in
//    place) and V MN-major (the transpose bit set; descriptor LBO one
//    64-column panel, 8192 bytes, SBO 8 keys, 1024 bytes, as
//    matmul_update's B).
//  * A warpgroup issues S of tile i and P V of tile i - 1 back to back and
//    runs the softmax of tile i while P V runs; the other warpgroup's
//    products fill the rest.  The softmax is compiled in four versions
//    (mask or not, softcap or not): only diagonal, window-edge and ragged
//    last tiles mask, and a runtime test for either in the tile loop halved
//    the kernel's speed on the card.
//  * At D = 256 shared memory holds Q (64 KB) and two stages of K and V
//    (128 KB): one block per SM.  D = 192 (deepseek-v2's MLA scores) is
//    three whole panels, Q (48 KB) and three stages (144 KB); D = 160
//    (stablelm-12b) is stored as 192, TMA zero-filling the last 32 columns
//    of every tile, while Q Kᵀ stops at column 160 and P V runs n = 160
//    (wg::Layout).  D = 16 and 32 (the smoke models; the reference's MQA
//    case) are one 64-column panel, TMA zero-filling columns D .. 63,
//    P V at n = D, two blocks an SM (setmaxnreg 104 / 24 of 80 at
//    launch): with 4·D = 64 or 128 tensor-core operations a (query, key)
//    pair against one exponential, the softmax, not the tensor cores,
//    sets the time, and a second block's warps hide its latency (25 %
//    faster at B 4, H 32, S 4,096).
//    Blocks run the heaviest query tiles first, the heads
//    of one (b, query tile) side by side so they read the same K/V tiles
//    from L2.  Tiles wholly outside a block's visible key range are never
//    loaded (the TPU kernel's block skip); ragged Sq and Sk come from TMA's
//    zero fill and masked stores.  The tensor maps take
//    the (b, h, s) strides as given, so the model's transposed views are
//    read without a copy; they are encoded on the host at every launch
//    through cudaGetDriverEntryPoint (no -lcuda).
//  * Tried and not kept (PERF.md): ordering the two warpgroups' products
//    by named barriers, 80-key tiles, and clusters of two query heads
//    sharing each K/V tile by TMA multicast all timed within the runs'
//    spread or slower.

// Rules every route keeps.  A masked logit contributes exactly 0 to l and
// acc (not exp(−2e38 − m)), so rows of a tile that see none of its keys —
// the window's first tiles — keep no terms, whatever order tiles are
// visited in.  A row that sees no key at all (causal with Sq > Sk) would
// get 0, but ops.flash_attention refuses that shape before dispatch.
//
// Route "rows" (float32, and bf16 that "wgmma" does not take): one warp
// per query row, each lane holding D/32 of the row's features, walking the
// visible keys one at a time (float32 stays full fp32, never TF32).  The
// wrapper picks the route from the operands (flash_attention_route); this
// entry refuses a route they do not allow.
//
// The kernels launch on the caller's stream, do not synchronise and
// allocate nothing.  The entry returns the launch's cudaError_t.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -2.0e38f;

struct Strides {  // element strides of the (b, h, s) dims; the last dim is contiguous
  long long b, h, s;
};

struct Problem {
  Strides q, k, v, o;
  int H, G, Sq, Sk, D;
  float scale, softcap;
  int causal, window;
};

// The visible key range [lo, hi] of query positions [qlo, qhi].
__device__ __forceinline__ void key_range(const Problem& p, int qlo, int qhi, int& lo, int& hi) {
  lo = 0;
  hi = p.Sk - 1;
  if (p.causal) hi = min(hi, qhi);
  if (p.window > 0) lo = max(lo, qlo - p.window + 1);
}

__device__ __forceinline__ bool visible(const Problem& p, int qpos, int key) {
  return key < p.Sk && (!p.causal || key <= qpos) && (p.window <= 0 || key > qpos - p.window);
}

__device__ __forceinline__ float cap_logit(const Problem& p, float s) {
  s *= p.scale;
  if (p.softcap > 0.0f) s = p.softcap * tanhf(s / p.softcap);
  return s;
}

// ----------------------------------------------------------- plain warp rows

constexpr int ROWS_PER_BLOCK = 4, MAXC = 8;  // D <= 32 * MAXC

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_to(float v, float*) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(32 * ROWS_PER_BLOCK)
    flash_fwd_rows(const T* __restrict__ Q, const T* __restrict__ K, const T* __restrict__ V,
                   T* __restrict__ O, Problem p) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= p.Sq) return;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H, kvh = h / p.G;
  const T* q = Q + b * p.q.b + h * p.q.h + (long long)row * p.q.s;
  const T* Kb = K + b * p.k.b + kvh * p.k.h;
  const T* Vb = V + b * p.v.b + kvh * p.v.h;
  const int qpos = row + p.Sk - p.Sq;
  int lo, hi;
  key_range(p, qpos, qpos, lo, hi);

  float qv[MAXC], acc[MAXC];
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    const int d = lane + 32 * c;
    qv[c] = d < p.D ? to_f32(q[d]) : 0.0f;
    acc[c] = 0.0f;
  }
  float m = NEG, l = 0.0f;
  for (int key = lo; key <= hi; ++key) {
    const T* kr = Kb + (long long)key * p.k.s;
    float part = 0.0f;
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      const int d = lane + 32 * c;
      if (d < p.D) part = fmaf(qv[c], to_f32(kr[d]), part);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    const float s = cap_logit(p, part);
    const float m_new = fmaxf(m, s);
    const float alpha = expf(m - m_new);
    const float pe = expf(s - m_new);
    l = l * alpha + pe;
    const float pv = round_to(pe, static_cast<T*>(nullptr));  // P in V's dtype
    const T* vr = Vb + (long long)key * p.v.s;
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      const int d = lane + 32 * c;
      if (d < p.D) acc[c] = fmaf(pv, to_f32(vr[d]), acc[c] * alpha);
    }
    m = m_new;
  }
  const float inv = 1.0f / fmaxf(l, 1e-30f);
  T* o = O + b * p.o.b + h * p.o.h + (long long)row * p.o.s;
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    const int d = lane + 32 * c;
    if (d < p.D) store(o + d, acc[c] * inv);
  }
}

template <typename T>
int launch_rows(const void* q, const void* k, const void* v, void* o, const Problem& p, int B,
                 cudaStream_t s) {
  dim3 grid((p.Sq + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK, B * p.H);
  flash_fwd_rows<T><<<grid, 32 * ROWS_PER_BLOCK, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), p);
  return static_cast<int>(cudaGetLastError());
}

// --------------------------------------- wgmma + TMA, warp-specialised (route "wgmma")

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One 4-D TMA box global -> shared, completing on `bar`'s transaction count.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                            int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from touching the accumulators across an async wgmma.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 64, fp32, 32 a thread) = A (64 x 16) * B (16 x 64) + scale_d * D,
// both K-major in shared memory, through their descriptors.
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 16, fp32, 8 a thread) = A (64 x 16, bf16 in registers, in the
// accumulator's layout) * B (16 x 16, MN-major in shared memory) + scale_d * D.
__device__ __forceinline__ void wgmma_rs_m64n16k16(float (&d)[8], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D (64 x 32, fp32, 16 a thread) = A (64 x 16, bf16 in registers, in the
// accumulator's layout) * B (16 x 32, MN-major in shared memory) + scale_d * D.
__device__ __forceinline__ void wgmma_rs_m64n32k16(float (&d)[16], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D (64 x 64, fp32, 32 a thread) = A (64 x 16, bf16 in registers, in the
// accumulator's layout) * B (16 x 64, MN-major in shared memory) + scale_d * D.
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D (64 x 128, fp32, 64 a thread) = A (64 x 16, bf16 in registers, in the
// accumulator's layout) * B (16 x 128, MN-major in shared memory) + scale_d * D.
__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[64], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D (64 x 160, fp32, 80 a thread) = A (64 x 16, bf16 in registers, in the
// accumulator's layout) * B (16 x 160, MN-major in shared memory) + scale_d * D.
__device__ __forceinline__ void wgmma_rs_m64n160k16(float (&d)[80], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, "
      "{%80, %81, %82, %83}, %84, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D (64 x 192, fp32, 96 a thread) = A (64 x 16, bf16 in registers, in the
// accumulator's layout) * B (16 x 192, MN-major in shared memory) + scale_d * D.
__device__ __forceinline__ void wgmma_rs_m64n192k16(float (&d)[96], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D (64 x 256, fp32, 128 a thread) = A (64 x 16, bf16 in registers, in the
// accumulator's layout) * B (16 x 256, MN-major in shared memory) + scale_d * D.
__device__ __forceinline__ void wgmma_rs_m64n256k16(float (&d)[128], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_pv(float (&o)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 256) {
    wgmma_rs_m64n256k16(o, a, db, 1);
  } else if constexpr (N == 192) {
    wgmma_rs_m64n192k16(o, a, db, 1);
  } else if constexpr (N == 160) {
    wgmma_rs_m64n160k16(o, a, db, 1);
  } else if constexpr (N == 128) {
    wgmma_rs_m64n128k16(o, a, db, 1);
  } else if constexpr (N == 64) {
    wgmma_rs_m64n64k16(o, a, db, 1);
  } else if constexpr (N == 32) {
    wgmma_rs_m64n32k16(o, a, db, 1);
  } else {
    static_assert(N == 16, "P V runs n = 16, 32, 64, 128, 160, 192 or 256");
    wgmma_rs_m64n16k16(o, a, db, 1);
  }
}

namespace wg {

constexpr int BM = 128;          // query rows of a block: two consumer warpgroups of 64
constexpr int BN = 64;           // keys of one K/V tile
constexpr int THREADS = 384;     // two consumer warpgroups, then the producer warpgroup
constexpr int PANEL = 64 * 128;  // 64 rows of one 64-column (128-byte) panel: one TMA box
constexpr float LOG2E = 1.4426950408889634f;
// K/V tiles in flight at head_dim 160 and 192 (stablelm-12b; deepseek-v2's
// MLA scores): 3 fill 197 KB, as D = 256's two do, and ran 7 % faster
// than 2 at MLA's prefill shape (tools/flash_headdim_probe.py).
constexpr int WIDE_STAGES = 3;
// Head dims 16 and 32 (the smoke models' D 16; the reference's MQA case at
// D 32) are one panel, TMA zero-filling columns D .. 63 of every tile: Q Kᵀ
// runs D/16 k16 steps and P V n = D (m64n16k16, m64n32k16).  A block's 49
// KB of shared memory (2 stages) would let four share an SM; SMALL_BLOCKS
// an SM are what the registers allow (setmaxnreg's split shrinks with it).
// At B 4, H 32, Kv 8, S 4,096 two blocks ran 25 % faster than one
// (tools/flash_headdim_probe.py --small).
constexpr int SMALL_BLOCKS = 2;

// Shared memory from a 1024-byte aligned base: Q of both warpgroups, then
// STAGES x (K tile, V tile), then the mbarriers q_full, k_full[STAGES],
// v_full[STAGES], k_empty[STAGES], v_empty[STAGES].  A tile of 64 rows x D
// is stored as DP/64 panels of 64 rows x 128 bytes in TMA's 128-byte
// swizzle, DP being D rounded up to whole panels: at D = 160 the third
// panel's columns 160-191 are TMA's zero fill (the tensor maps' inner dim
// is D), which neither Q Kᵀ nor P V (n = D) reads; at D = 16 and 32 the
// one panel's columns D .. 63 are.  The consumers' and the producer's
// registers (setmaxnreg) split what 384 threads get at launch with
// MIN_BLOCKS blocks an SM; flash_attention_wgmma_registers says whether
// ptxas gave them enough.
template <int D>
struct Layout {
  static constexpr int DP = (D + 63) / 64 * 64;
  static constexpr int STAGES = (D == 160 || D == 192) ? WIDE_STAGES : 2;
  static constexpr int MIN_BLOCKS = D <= 32 ? SMALL_BLOCKS : 1;
  static constexpr int PRODUCER_REGS = 24;
  static constexpr int CONSUMER_REGS = MIN_BLOCKS == 1 ? 240 : 104;  // 256 x 104 + 128 x 24 <= 384 x 80
  static constexpr int TILE = DP / 64 * PANEL;
  static constexpr int Q = 0;
  static constexpr int KV = 2 * TILE;
  static constexpr int BARS = KV + STAGES * 2 * TILE;
  static constexpr int BYTES = BARS + (1 + 4 * STAGES) * 8 + 1024;
};

// S = Q Kᵀ for one warpgroup: 64 rows x 64 keys, D/16 k16 steps, Q and K
// K-major (a k16 step is 32 bytes along a panel's swizzled rows; at D = 160
// the steps stop at column 160, short of the zero-filled rest of the
// third panel).  Issued, committed, not waited for.
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[32], uint32_t qs, uint32_t ks) {
#pragma unroll
  for (int e = 0; e < 32; ++e) sc[e] = 0.0f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * PANEL + (kk % 4) * 32;
    wgmma_ss_m64n64k16(sc, smem_desc(qs + off, 16, 1024), smem_desc(ks + off, 16, 1024), 1);
  }
  wgmma_commit();
}

// O += P V over n = N columns: P from registers, V MN-major (16 keys =
// 2048 bytes down a step; LBO one 64-column panel).  Issued, committed, not
// waited for.
template <int N>
__device__ __forceinline__ void issue_pv(float (&o)[N / 2], const uint32_t (&pa)[4][4], uint32_t vs) {
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) wgmma_pv<N>(o, pa[kc], smem_desc(vs + kc * 2048, PANEL, 1024));
  wgmma_commit();
}

// Scale, softcap and mask the logits of one tile (keys k0 .. k0 + 63), fold
// them into the running max m and sum l of this thread's two rows, and
// leave the weights exp(s - m) in sc (a masked logit weighs exactly 0, not
// exp(-2e38 - m)).  Returns, in alpha, the factors the accumulator's rows
// must be scaled by.  MASK and CAP are compile-time: a tile that every row
// sees in full runs no mask code, and a call without softcap no tanh (with
// either in the loop's code the kernel ran at half speed).
template <bool MASK, bool CAP>
__device__ __forceinline__ void softmax_tile(const Problem& p, float (&sc)[32], int k0, const int (&qpos)[2],
                                             int tq, float (&m)[2], float (&l)[2], float (&alpha)[2]) {
  uint32_t keep = 0xffffffffu;
  float mx[2] = {NEG, NEG};
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int r = (e >> 1) & 1;
    float x = sc[e] * p.scale;
    if constexpr (CAP) x = p.softcap * tanhf(x / p.softcap);
    if constexpr (MASK) {
      if (!visible(p, qpos[r], k0 + 8 * (e >> 2) + 2 * tq + (e & 1))) {
        x = NEG;
        keep &= ~(1u << e);
      }
    }
    sc[e] = x;
    mx[r] = fmaxf(mx[r], x);
  }
  float ms[2];  // the new max, times log2(e)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = exp2f((m[r] - m_new) * LOG2E);
    m[r] = m_new;
    ms[r] = m_new * LOG2E;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int r = (e >> 1) & 1;
    float pe = exp2f(fmaf(sc[e], LOG2E, -ms[r]));
    if constexpr (MASK) pe = ((keep >> e) & 1u) ? pe : 0.0f;
    sc[e] = pe;
    l[r] += pe;  // this thread's columns; the quad's partial sums meet at the end
  }
}

// The weights as bf16 A fragments: the accumulator's layout is the A
// operand's, so fragment kc (keys 16 kc .. 16 kc + 15) packs elements
// 8 kc .. 8 kc + 7 in order.
__device__ __forceinline__ void pack_p(const float (&sc)[32], uint32_t (&pa)[4][4]) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
    for (int q = 0; q < 4; ++q) pa[kc][q] = pack_bf16(sc[8 * kc + 2 * q], sc[8 * kc + 2 * q + 1]);
  }
}

// One block: query rows [q0, q0 + 128) of one (b, head).  Warpgroups 0
// and 1 own 64 rows each; warpgroup 2 loads (one thread).  Thread (warp w
// of its warpgroup, lane l) holds rows 16 w + l/4 and 16 w + l/4 + 8 of its
// warpgroup's 64, in wgmma's accumulator layout: element 4 j + 2 r + e is
// row l/4 + 8 r, column 8 j + 2 (l % 4) + e.  A warpgroup issues
// S = Q K_iᵀ and then P V of tile i - 1 before it runs the softmax of tile
// i, so its own P V runs while it computes exponentials.
template <int D, bool CAP>
__global__ void __launch_bounds__(THREADS, Layout<D>::MIN_BLOCKS)
    flash_fwd_wgmma(__nv_bfloat16* __restrict__ O, const __grid_constant__ CUtensorMap tmQ,
                    const __grid_constant__ CUtensorMap tmK, const __grid_constant__ CUtensorMap tmV,
                    Problem p, int BH) {
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + L::BARS;
  const uint32_t k_full = q_full + 8, v_full = k_full + 8 * L::STAGES;  // stage s is 8 s on
  const uint32_t k_empty = v_full + 8 * L::STAGES, v_empty = k_empty + 8 * L::STAGES;

  // Heaviest query tiles first (under a causal mask the last tiles see the
  // most keys); the heads of one (b, query tile) run side by side, so they
  // read the same K/V tiles from L2.
  const int n_qt = (p.Sq + BM - 1) / BM;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / BH) * BM;
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int b = bh / p.H, head = bh % p.H, kvh = head / p.G;
  const int q_off = p.Sk - p.Sq;
  int lo, hi;
  key_range(p, q0 + q_off, min(q0 + BM, p.Sq) - 1 + q_off, lo, hi);
  const int t_lo = lo / BN;
  const int n_tiles = hi >= lo ? hi / BN - t_lo + 1 : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);  // the producer's expect_tx
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 8);  // lane 0 of every consumer warp
      mbar_init(v_empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(L::PRODUCER_REGS) : "memory");
    if (threadIdx.x == 256) {
      // Out-of-range rows (past Sq or Sk) are zero-filled and count in full.
      mbar_expect_tx(q_full, 2 * L::TILE);
      for (int w = 0; w < 2; ++w) {
        for (int c = 0; c < L::DP / 64; ++c) {
          tma_load_4d(base + L::Q + w * L::TILE + c * PANEL, &tmQ, q_full, 64 * c, q0 + 64 * w, head, b);
        }
      }
      auto load = [&](uint32_t dst, const CUtensorMap* map, uint32_t full, int k0) {
        mbar_expect_tx(full, L::TILE);
        for (int c = 0; c < L::DP / 64; ++c) tma_load_4d(dst + c * PANEL, map, full, 64 * c, k0, kvh, b);
      };
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % L::STAGES;
        const uint32_t free_parity = ((i / L::STAGES) & 1) ^ 1;  // the first pass finds every stage free
        const uint32_t ks = base + L::KV + 2 * s * L::TILE;
        mbar_wait(k_empty + 8 * s, free_parity);
        load(ks, &tmK, k_full + 8 * s, (t_lo + i) * BN);
        mbar_wait(v_empty + 8 * s, free_parity);
        load(ks + L::TILE, &tmV, v_full + 8 * s, (t_lo + i) * BN);
      }
    }
  } else {
    // -------------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(L::CONSUMER_REGS) : "memory");
    const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int tq = lane % 4;
    const int row0 = q0 + 64 * wg + 16 * warp + lane / 4;  // and row0 + 8
    const int qpos[2] = {row0 + q_off, row0 + 8 + q_off};
    const int wlo = q0 + 64 * wg + q_off;                      // the warpgroup's first query position
    const int whi = min(q0 + 64 * wg + 64, p.Sq) - 1 + q_off;  // and its last
    const uint32_t qs = base + L::Q + wg * L::TILE;
    auto k_tile = [&](int i) { return base + L::KV + 2 * (i % L::STAGES) * L::TILE; };
    auto parity = [](int i) { return static_cast<uint32_t>((i / L::STAGES) & 1); };
    auto release = [&](uint32_t empty, int i) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * (i % L::STAGES));
    };

    float o[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) o[e] = 0.0f;
    float m[2] = {NEG, NEG}, l[2] = {0.0f, 0.0f}, alpha[2];
    float sc[32];
    uint32_t pa[4][4];
    // Only diagonal, window-edge and ragged last tiles mask: the others are
    // seen in full by every row of the warpgroup.
    auto softmax = [&](int k0) {
      if ((!p.causal || k0 + BN - 1 <= wlo) && (p.window <= 0 || k0 > whi - p.window) && k0 + BN <= p.Sk) {
        softmax_tile<false, CAP>(p, sc, k0, qpos, tq, m, l, alpha);
      } else {
        softmax_tile<true, CAP>(p, sc, k0, qpos, tq, m, l, alpha);
      }
    };
    mbar_wait(q_full, 0);

    if (n_tiles > 0) {
      mbar_wait(k_full, 0);
      issue_qk<D>(sc, qs, k_tile(0));
      wgmma_wait<0>();
      fence_acc(sc);
      release(k_empty, 0);
      softmax(t_lo * BN);
      pack_p(sc, pa);
    }
    for (int i = 1; i < n_tiles; ++i) {
      mbar_wait(k_full + 8 * (i % L::STAGES), parity(i));
      issue_qk<D>(sc, qs, k_tile(i));
      mbar_wait(v_full + 8 * ((i - 1) % L::STAGES), parity(i - 1));
      issue_pv<D>(o, pa, k_tile(i - 1) + L::TILE);
      wgmma_wait<1>();  // S of tile i is done; P V of tile i - 1 may run on
      fence_acc(sc);
      release(k_empty, i);
      softmax((t_lo + i) * BN);
      wgmma_wait<0>();
      fence_acc(o);
      release(v_empty, i - 1);
#pragma unroll
      for (int e = 0; e < D / 2; ++e) o[e] *= alpha[(e >> 1) & 1];
      pack_p(sc, pa);
    }
    if (n_tiles > 0) {
      mbar_wait(v_full + 8 * ((n_tiles - 1) % L::STAGES), parity(n_tiles - 1));
      issue_pv<D>(o, pa, k_tile(n_tiles - 1) + L::TILE);
      wgmma_wait<0>();
      fence_acc(o);
      release(v_empty, n_tiles - 1);
    }

    // Normalise and store rows row0 and row0 + 8.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const float inv[2] = {1.0f / fmaxf(l[0], 1e-30f), 1.0f / fmaxf(l[1], 1e-30f)};
    __nv_bfloat16* Ob = O + b * p.o.b + head * p.o.h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= p.Sq) continue;
      __nv_bfloat16* dst = Ob + (long long)row * p.o.s + 2 * tq;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]);
      }
    }
  }
}

}  // namespace wg

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#endif
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A (B, heads, S, D) bf16 tensor with element strides st (last dim
// contiguous) as a 4-D map of dims (D, S, heads, B), boxes of 64 columns x
// 64 rows of one (b, head).  The strides need not be ordered: the model's
// transposed (B, S, H, D) views map as they are.
bool tensor_map_4d(CUtensorMap* map, const void* ptr, int D, int S, int heads, int B, const Strides& st) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.s) * 2, static_cast<cuuint64_t>(st.h) * 2,
                                 static_cast<cuuint64_t>(st.b) * 2};
  const cuuint32_t box[4] = {64, 64, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, const Problem& p, int B, int Kv,
                 cudaStream_t s) {
  using L = wg::Layout<D>;
  auto kernel = p.softcap > 0.0f ? wg::flash_fwd_wgmma<D, true> : wg::flash_fwd_wgmma<D, false>;
  // Set at every launch: the attribute belongs to the current device.
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap tmQ, tmK, tmV;
  if (!tensor_map_4d(&tmQ, q, D, p.Sq, p.H, B, p.q) || !tensor_map_4d(&tmK, k, D, p.Sk, Kv, B, p.k) ||
      !tensor_map_4d(&tmV, v, D, p.Sk, Kv, B, p.v)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = (long long)((p.Sq + wg::BM - 1) / wg::BM) * B * p.H;
  if (blocks >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), wg::THREADS, L::BYTES, s>>>(static_cast<__nv_bfloat16*>(o), tmQ, tmK,
                                                                       tmV, p, B * p.H);
  return static_cast<int>(cudaGetLastError());
}

// The registers ptxas gave a thread of the "wgmma" kernel at head_dim D
// (the fewer of its two instantiations), and in *need the fewest its
// setmaxnreg split holds with.
template <int D>
int wgmma_registers(int* need) {
  using L = wg::Layout<D>;
  *need = (256 * L::CONSUMER_REGS + 128 * L::PRODUCER_REGS + wg::THREADS - 1) / wg::THREADS;
  const void* kernels[2] = {(const void*)wg::flash_fwd_wgmma<D, false>, (const void*)wg::flash_fwd_wgmma<D, true>};
  int regs = 1 << 30;
  for (const void* kernel : kernels) {
    cudaFuncAttributes a;
    const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
    if (err != cudaSuccess) return -static_cast<int>(err);
    if (a.numRegs < regs) regs = a.numRegs;
  }
  return regs;
}

}  // namespace

// q (B,H,Sq,D), k/v (B,Kv,Sk,D), out like q, each with element strides
// (b, h, s) and a contiguous last dim, on the current device; dtype 0 =
// float32, 1 = bfloat16; route 0 = "rows", 1 = "wgmma"; stream
// is a cudaStream_t.  Returns the launch's cudaError_t (0 = launched).
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out,
                               long long qsb, long long qsh, long long qss, long long ksb,
                               long long ksh, long long kss, long long vsb, long long vsh,
                               long long vss, long long osb, long long osh, long long oss, int B,
                               int H, int Kv, int Sq, int Sk, int D, float scale, float softcap,
                               int causal, int window, int dtype, int route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || Kv <= 0 || H % Kv || Sq <= 0 || Sk <= 0 || D <= 0 || D > 32 * MAXC)
    return static_cast<int>(cudaErrorInvalidValue);
  Problem p{{qsb, qsh, qss}, {ksb, ksh, kss}, {vsb, vsh, vss}, {osb, osh, oss},
            H, H / Kv, Sq, Sk, D, scale, softcap, causal, window};
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out);
  const long long strides = qsb | qsh | qss | ksb | ksh | kss | vsb | vsh | vss | osb | osh | oss;
  const bool aligned = dtype == 1 && (ptrs & 15) == 0 && (strides & 7) == 0;
  const bool positive = qsb > 0 && qsh > 0 && qss > 0 && ksb > 0 && ksh > 0 && kss > 0 && vsb > 0 &&
                        vsh > 0 && vss > 0;
  if (route == 1) {
    if (!aligned || !positive) return static_cast<int>(cudaErrorInvalidValue);
    switch (D) {
      case 16: return launch_wgmma<16>(q, k, v, out, p, B, Kv, s);
      case 32: return launch_wgmma<32>(q, k, v, out, p, B, Kv, s);
      case 64: return launch_wgmma<64>(q, k, v, out, p, B, Kv, s);
      case 128: return launch_wgmma<128>(q, k, v, out, p, B, Kv, s);
      case 160: return launch_wgmma<160>(q, k, v, out, p, B, Kv, s);
      case 192: return launch_wgmma<192>(q, k, v, out, p, B, Kv, s);
      case 256: return launch_wgmma<256>(q, k, v, out, p, B, Kv, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (route != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) return launch_rows<__nv_bfloat16>(q, k, v, out, p, B, s);
  if (dtype == 0) return launch_rows<float>(q, k, v, out, p, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of the "wgmma" route's kernel at head_dim D, in
// bytes (0 for another D); ptxas -v does not report it.
extern "C" int flash_attention_wgmma_smem(int D) {
  switch (D) {
    case 16: return wg::Layout<16>::BYTES;
    case 32: return wg::Layout<32>::BYTES;
    case 64: return wg::Layout<64>::BYTES;
    case 128: return wg::Layout<128>::BYTES;
    case 160: return wg::Layout<160>::BYTES;
    case 192: return wg::Layout<192>::BYTES;
    case 256: return wg::Layout<256>::BYTES;
    default: return 0;
  }
}

// The registers a thread of the "wgmma" kernel at head_dim D got from
// ptxas, and in *need the fewest that its setmaxnreg split holds with: a
// block is given 384 x that many at launch, and the consumers'
// setmaxnreg.inc waits until 256 x CONSUMER_REGS of them are free, forever
// if they never are.  Returns 0 for another D, -cudaError when the runtime
// cannot say.
extern "C" int flash_attention_wgmma_registers(int D, int* need) {
  *need = 0;
  switch (D) {
    case 16: return wgmma_registers<16>(need);
    case 32: return wgmma_registers<32>(need);
    case 64: return wgmma_registers<64>(need);
    case 128: return wgmma_registers<128>(need);
    case 160: return wgmma_registers<160>(need);
    case 192: return wgmma_registers<192>(need);
    case 256: return wgmma_registers<256>(need);
    default: return 0;
  }
}
