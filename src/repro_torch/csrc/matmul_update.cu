// matmul_update.cu — the paper's panel update C += A·B, written by hand for
// Hopper (sm_90a), with a plain C entry point loaded through ctypes.
//
// Replaces src/repro/kernels/matmul_update.py:49 (matmul_update_pallas, body
// _kernel at :30): C (M,N) += A (M,K) · B (K,N), fp32 accumulation seeded
// from C, cast back to C's dtype, C updated in place (the Pallas kernel
// aliases C in->out).  float32 and bfloat16, all row-major.
//
// What bounds it on an H100.  It does 2·M·N·K operations and must move
// A, B and C once in and C once out: 2·(M·K + K·N + 2·M·N) bytes in bf16.
// At 989 TFLOP/s (bf16 tensor cores) over 3.35 TB/s the card needs about
// 295 operations per byte before the tensor cores, not memory, are the
// limit.  The DFPA panels (M = 32·units rows, N = K = 16384) sit on both
// sides of that line: the 32-row panel must still read all of B (537 MB)
// and is bound by bytes (0.16 ms); the 2048-row panel is bound by
// operations (1.11 ms).  That nonlinearity is the speed function DFPA
// estimates.
//
// What the design does about it (route "wgmma": bf16, N and K multiples
// of 8, every operand 16-byte aligned).  One block owns one 64x128 output
// tile and walks K in 64-deep slices inside the block (the TPU's
// sequential K grid axis).  A producer warp's one thread issues TMA loads
// of the A (64 x 64) and B (64 x 128) slices into a ring of 8 shared-memory
// stages of 24 KB with 128-byte swizzle, each stage guarded by a
// full/empty mbarrier pair; one consumer warpgroup runs wgmma.mma_async
// m64n128k16 bf16 -> fp32 straight from those tiles into 64 register
// accumulators a thread, seeded from C, and releases a stage once the
// products that read it have completed (one wgmma group stays in flight).
// Two blocks with the same rows and neighbouring columns form a cluster and
// share each A slice: each loads half of its rows and the TMA multicasts
// them into both, so a stage is refilled only once both blocks' consumers
// have released it.  Blocks walk M fastest, so blocks running at once
// share B's column panel in L2.  No split-K: every C element has one
// owner, and the result is bit-identical from launch to launch.
//
// Why 64x128 tiles.  DFPA estimates the time of a panel as a function of
// its rows, and a tiled kernel's time is a staircase: one more wave of
// blocks on the 132 SMs costs a whole tile's time.  A wave covers
// 132 x (tile area) / N rows: 66 rows here (two 32-row units at N = 16384),
// 264 rows with 128x256 tiles.  128x256 tiles run the 2048-row panel about
// 1.5x faster, but their steps (up to a quarter of a small panel's time)
// left DFPA at eps 0.1 unconverged in about a third of its runs on the
// card, and 128x128 tiles (132 rows) in half of them; over 64x128 tiles it
// converged in every run.  A small tile reads more of A and B from L2 per
// product, and the large panels are bound by that traffic: sharing A
// across the cluster cuts it by a sixth.  The tile also puts 128 blocks,
// each streaming its own columns of B, on the byte-bound 32-row panel.
//
// Where trouble is likely, and what the code does about it:
//  * B is (K, N) row-major, MN-major for wgmma: the instruction's
//    transpose bit for B is set, and B's descriptor steps 1024 bytes per 8
//    K rows (SBO) and 8192 bytes per 64 N columns (LBO), matching two
//    64 x 64 TMA boxes laid side by side.  A is K-major: one 128-byte row per
//    M row, 1024 bytes per 8 rows, and the k16 slices start 32 bytes apart.
//  * Ragged shapes: TMA zero-fills what lies outside A and B (rows past M,
//    columns past N, K past a multiple of 64), and the C seed and store are
//    masked by row and column.  The grid's columns round up to whole
//    clusters; a block past N loads its half of A for its partner and
//    stores nothing.
//  * Clusters: every block's barriers are initialised before a cluster-wide
//    barrier, so no multicast reaches one that does not exist yet, and no
//    block exits before a last cluster-wide barrier, since its partner's
//    consumers arrive on its empty barriers until their last slice.
//  * The tensor maps are encoded on the host at every launch (a few
//    microseconds; the DFPA loop launches tens to hundreds of times a phase), through
//    cudaGetDriverEntryPoint, so the library needs no -lcuda.  They reach the
//    kernel as __grid_constant__ parameters.
//  * mbarrier phases: a lost or repeated stage would still give plausible
//    numbers, so the checks hold two launches bit-identical and show that a
//    result missing one 64-deep K slice fails the parity check.
//  * Build time: inline PTX only, no CUTLASS or CuTe headers, so the source
//    builds in seconds like the others.
//
// Route "tile" (float32, or bf16 with N or K not a multiple of 8, or an
// operand not 16-byte aligned): a plain shared-memory FMA tile kernel (64x64
// tiles, 4x4 outputs per thread) with the same contract; float32 there is
// full fp32, never TF32.  The wrapper picks the route (matmul_update_route)
// and this entry refuses a route its operands do not allow.
//
// The kernels launch on the caller's stream, do not synchronise and
// allocate nothing.  The entry returns the launch's cudaError_t.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ------------------------------------------------------- wgmma + TMA tiles

constexpr int WBM = 64;                             // rows of one output tile
constexpr int WBN = 128;                            // columns of one output tile
constexpr int WBK = 64;                             // K depth of one stage (128 bytes of bf16)
constexpr int STAGES = 8;
constexpr int CLUSTER_N = 2;                        // blocks along N that share each A slice
constexpr int A_SLICE_ROWS = WBM / CLUSTER_N;       // the rows of A each block of a cluster loads
constexpr int WG_THREADS = 160;                     // one consumer warpgroup + one producer warp
constexpr int A_BYTES = WBM * 128;                  // 64 rows of 64 bf16
constexpr int B_BOX_BYTES = WBK * 128;              // one 64 (K) x 64 (N) bf16 box of B
constexpr int B_BYTES = (WBN / 64) * B_BOX_BYTES;   // two boxes side by side
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;      // 24 KB
constexpr int WGMMA_SMEM_BYTES = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;  // + alignment

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

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

// Every thread of every block of the cluster (divergent warps allowed).
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::: "memory");
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

// One 2-D TMA box global -> shared, completing on `bar`'s transaction count.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// The same box into the same shared address of every block in `mask`,
// completing on each one's mbarrier at `bar`.
__device__ __forceinline__ void tma_load_2d_multicast(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                                      int c0, int c1, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
      "[%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "h"(mask)
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

// D (64 x 128, fp32, 64 a thread) += A (64 x 16, K-major) * B (16 x 128, MN-major),
// both from shared memory through their descriptors; scale-d = 1 (accumulate).
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// Warps 0-3 (one warpgroup) compute the tile; warp 4 loads it.  The
// CLUSTER_N blocks of a cluster own neighbouring tiles along N: each loads
// A_SLICE_ROWS rows of the A slice into all of them, and a stage is
// refilled only once the consumers of every block have released it.
__global__ void __cluster_dims__(1, CLUSTER_N, 1) __launch_bounds__(WG_THREADS, 1)
    matmul_update_wgmma(__nv_bfloat16* __restrict__ C, const __grid_constant__ CUtensorMap tmA,
                        const __grid_constant__ CUtensorMap tmB, int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment: the 128-byte swizzle repeats every 8 rows of 128 B.
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full0 = base + STAGES * STAGE_BYTES;
  const uint32_t empty0 = full0 + STAGES * 8;

  const int nk = (K + WBK - 1) / WBK;
  const int m0 = blockIdx.x * WBM;  // M fastest: neighbouring blocks share B's panel
  const int n0 = blockIdx.y * WBN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);   // the producer's expect_tx
      mbar_init(empty0 + 8 * s, 4 * CLUSTER_N);  // lane 0 of every consumer warp of the cluster
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // every block's barriers exist before any block loads into it
  const uint32_t rank = cluster_rank();

  if (threadIdx.x >= 128) {
    // ------------------------------------------------------------ producer
    if (threadIdx.x == 128) {
      int s = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(empty0 + 8 * s, phase ^ 1);  // the first pass finds every stage free
        const uint32_t full = full0 + 8 * s;
        const uint32_t sa = base + s * STAGE_BYTES;
        mbar_expect_tx(full, STAGE_BYTES);  // out-of-range boxes count in full (zero-filled)
        tma_load_2d_multicast(sa + rank * A_SLICE_ROWS * 128, &tmA, full, kt * WBK,
                              m0 + rank * A_SLICE_ROWS, (1u << CLUSTER_N) - 1);
#pragma unroll
        for (int j = 0; j < WBN / 64; ++j) {
          tma_load_2d(sa + A_BYTES + j * B_BOX_BYTES, &tmB, full, n0 + 64 * j, kt * WBK);
        }
        if (++s == STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    const int t = threadIdx.x;
    const int lane = t % 32;
    // accumulator fragment: d[4j + 2h + e] is row 16 w + l/4 + 8h, column 8j + 2(l%4) + e
    const int row0 = m0 + 16 * (t / 32) + lane / 4;
    const int col0 = n0 + 2 * (lane % 4);
    float acc[WBN / 2];
#pragma unroll
    for (int j = 0; j < WBN / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h, col = col0 + 8 * j;
        float2 v = make_float2(0.0f, 0.0f);
        if (row < M && col < N) {  // N % 8 == 0: col < N implies col + 1 < N
          v = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(C + static_cast<long long>(row) * N + col));
        }
        acc[4 * j + 2 * h] = v.x;
        acc[4 * j + 2 * h + 1] = v.y;
      }
    }
    fence_acc(acc);

    int s = 0, prev = -1;
    uint32_t phase = 0;
    for (int kt = 0; kt < nk; ++kt) {
      mbar_wait(full0 + 8 * s, phase);
      const uint32_t sa = base + s * STAGE_BYTES;
      const uint32_t sb = sa + A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WBK / 16; ++kk) {
        // A: K-major, the k16 slice 32 bytes along the swizzled row.
        // B: MN-major, the k16 slice 16 rows (2048 bytes) down.
        wgmma_m64n128k16(acc, smem_desc(sa + 32 * kk, 16, 1024), smem_desc(sb + 2048 * kk, B_BOX_BYTES, 1024));
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous slice's products are done with their stage
      fence_acc(acc);
      if (prev >= 0 && lane == 0) {
#pragma unroll
        for (int r = 0; r < CLUSTER_N; ++r) mbar_arrive_cluster(empty0 + 8 * prev, r);
      }
      prev = s;
      if (++s == STAGES) {
        s = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);

#pragma unroll
    for (int j = 0; j < WBN / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h, col = col0 + 8 * j;
        if (row < M && col < N) {
          *reinterpret_cast<__nv_bfloat162*>(C + static_cast<long long>(row) * N + col) =
              __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
    }
  }
  cluster_sync();  // no block leaves while another may still arrive on its barriers
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#endif
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major (rows, cols) bf16 matrix, boxes of box_rows x 64 columns.
bool tensor_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch_wgmma(__nv_bfloat16* C, const void* A, const void* B, int M, int N, int K, cudaStream_t s) {
  // Set at every launch: the attribute belongs to the current device.
  const cudaError_t err =
      cudaFuncSetAttribute(matmul_update_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, WGMMA_SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap tmA, tmB;
  if (!tensor_map(&tmA, A, M, K, A_SLICE_ROWS) || !tensor_map(&tmB, B, K, N, WBK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_tiles = (N + WBN - 1) / WBN;  // rounded up to whole clusters; the extra blocks store nothing
  dim3 grid((M + WBM - 1) / WBM, (n_tiles + CLUSTER_N - 1) / CLUSTER_N * CLUSTER_N);
  matmul_update_wgmma<<<grid, WG_THREADS, WGMMA_SMEM_BYTES, s>>>(C, tmA, tmB, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------- plain FMA tiles

constexpr int SB = 64, SK = 16, SIMT_THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Any shape: every load is bounds-checked.  Thread (ty, tx) owns rows
// m0 + ty + 16 i and columns n0 + tx + 16 j, i, j in 0..3.
template <typename T>
__global__ void __launch_bounds__(SIMT_THREADS)
    matmul_update_simt(T* __restrict__ C, const T* __restrict__ A, const T* __restrict__ B, int M,
                       int N, int K) {
  __shared__ float As[SK][SB + 4];  // As[k][m]
  __shared__ float Bs[SK][SB + 4];  // Bs[k][n]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long m0 = (long long)blockIdx.y * SB;
  const long long n0 = (long long)blockIdx.x * SB;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long r = m0 + ty + 16 * i, c = n0 + tx + 16 * j;
      acc[i][j] = (r < M && c < N) ? to_f32(C[r * N + c]) : 0.0f;
    }
  }

  for (long long k0 = 0; k0 < K; k0 += SK) {
    for (int idx = tid; idx < SB * SK; idx += SIMT_THREADS) {
      const int row = idx / SK, kk = idx % SK;
      const long long gr = m0 + row, gk = k0 + kk;
      As[kk][row] = (gr < M && gk < K) ? to_f32(A[gr * K + gk]) : 0.0f;
    }
    for (int idx = tid; idx < SK * SB; idx += SIMT_THREADS) {
      const int kk = idx / SB, col = idx % SB;
      const long long gk = k0 + kk, gc = n0 + col;
      Bs[kk][col] = (gk < K && gc < N) ? to_f32(B[gk * N + gc]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < SK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long r = m0 + ty + 16 * i, c = n0 + tx + 16 * j;
      if (r < M && c < N) store_f32(&C[r * N + c], acc[i][j]);
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  route: 0 = "tile", 1 = "wgmma" (bf16
// only, N and K multiples of 8, C, A and B 16-byte aligned).  Row-major
// contiguous C (M,N), A (M,K), B (K,N) on the current device; stream is a
// cudaStream_t.  Returns the launch's cudaError_t (0 = launched).
extern "C" int matmul_update(void* c, const void* a, const void* b, int M, int N, int K, int dtype,
                             int route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (route == 1) {
    const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
                           reinterpret_cast<uintptr_t>(c);
    if (dtype != 1 || N % 8 || K % 8 || (ptrs & 15)) return static_cast<int>(cudaErrorInvalidValue);
    return launch_wgmma(static_cast<__nv_bfloat16*>(c), a, b, M, N, K, s);
  }
  if (route != 0) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((N + SB - 1) / SB, (M + SB - 1) / SB);
  if (dtype == 1) {
    matmul_update_simt<__nv_bfloat16><<<grid, SIMT_THREADS, 0, s>>>(
        static_cast<__nv_bfloat16*>(c), static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b), M, N, K);
  } else if (dtype == 0) {
    matmul_update_simt<float><<<grid, SIMT_THREADS, 0, s>>>(
        static_cast<float*>(c), static_cast<const float*>(a), static_cast<const float*>(b), M, N, K);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of the "wgmma" route's kernel, in bytes; ptxas -v
// does not report it.
extern "C" int matmul_update_wgmma_smem() { return WGMMA_SMEM_BYTES; }
