// matmul_update.cu — the paper's panel update C += A·B, written by hand for
// Hopper (sm_90a), with a plain C entry point loaded through ctypes.
//
// Replaces src/repro/kernels/matmul_update.py:49 (matmul_update_pallas, body
// _kernel at :30): C (M,N) += A (M,K) · B (K,N), fp32 accumulation seeded
// from C, cast back to C's dtype, C updated in place (the Pallas kernel
// aliases C in->out).  float32 and bfloat16.
//
// What bounds it on an H100.  It does 2·M·N·K operations and must move
// A, B and C once in and C once out: 2·(M·K + K·N + 2·M·N) bytes in bf16.
// At 989 TFLOP/s (bf16 tensor cores) over 3.35 TB/s the card needs about
// 295 operations per byte before the tensor cores, not memory, are the
// limit.  The DFPA panels sit on both sides of that line: a panel of a few
// 32-row units must still read all of B (K·N) and is bound by bytes; a panel
// of hundreds of rows is bound by operations.  That nonlinearity is exactly
// the speed function DFPA estimates.
//
// What the design does about it.  Each block owns one 128x128 output tile
// and loops over K inside the block (the TPU's sequential K grid axis
// becomes that loop): A and B tiles of depth 32 stream into shared memory
// with cp.async, double-buffered, so each tile is read from device memory
// once per block and the next tile's copy overlaps the current tile's
// products; eight warps each run mma.sync m16n8k16 bf16 tensor-core
// products over a 64x32 sub-tile, fed by ldmatrix from padded (bank-
// conflict-free) rows, accumulating in fp32 registers seeded from C.  A
// panel of at most 128 rows reads B exactly once.  wgmma/TMA and a
// persistent schedule are later work.  Shapes the tensor-core path cannot
// take (float32, or bf16 with K or N not a multiple of 8, or operands not
// 16-byte aligned) run a plain shared-memory FMA tile kernel (64x64 tiles,
// 4x4 outputs per thread) with the same contract; float32 there is full
// fp32, never TF32.
//
// The kernel launches on the caller's stream, does not synchronise and
// allocates nothing.  The entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------- tensor cores

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int MMA_THREADS = 256;
constexpr int A_STRIDE = BK + 8;  // 80-byte rows: 8 ldmatrix rows hit 8 distinct bank groups
constexpr int B_STRIDE = BN + 8;  // 272-byte rows: likewise

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy global -> shared; zero-fills when !valid (nothing is read).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// D (16x8 fp32) += A (16x16 bf16, row) · B (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Requires K % 8 == 0, N % 8 == 0 and 16-byte aligned A and B (each 16-byte
// chunk of a row is then wholly inside or outside the matrix).
__global__ void __launch_bounds__(MMA_THREADS)
    matmul_update_bf16_mma(__nv_bfloat16* __restrict__ C, const __nv_bfloat16* __restrict__ A,
                           const __nv_bfloat16* __restrict__ B, int M, int N, int K) {
  __shared__ __align__(128) __nv_bfloat16 As[2][BM * A_STRIDE];
  __shared__ __align__(128) __nv_bfloat16 Bs[2][BK * B_STRIDE];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 2;  // 2 warps along M: 64-row slabs
  const int wn = warp & 3;   // 4 warps along N: 32-column slabs
  const int g = lane >> 2;   // mma fragment row group
  const int t = lane & 3;    // mma fragment column pair
  const long long m0 = (long long)blockIdx.y * BM;
  const long long n0 = (long long)blockIdx.x * BN;

  // Seed the fp32 accumulator from C (the reference's first-K-block init).
  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const long long col = n0 + wn * 32 + nt * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = m0 + wm * 64 + mt * 16 + g + 8 * h;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          acc[mt][nt][2 * h + e] = (row < M && col + e < N)
                                       ? __bfloat162float(C[row * N + col + e])
                                       : 0.0f;
        }
      }
    }
  }

  auto load_tile = [&](int stage, int kt) {
    const long long k0 = (long long)kt * BK;
    for (int i = tid; i < BM * (BK / 8); i += MMA_THREADS) {
      const int row = i / (BK / 8), ch = i % (BK / 8);
      const long long gr = m0 + row, gk = k0 + ch * 8;
      const bool ok = gr < M && gk < K;
      cp_async16(&As[stage][row * A_STRIDE + ch * 8], ok ? A + gr * K + gk : A, ok);
    }
    for (int i = tid; i < BK * (BN / 8); i += MMA_THREADS) {
      const int row = i / (BN / 8), ch = i % (BN / 8);
      const long long gk = k0 + row, gn = n0 + ch * 8;
      const bool ok = gk < K && gn < N;
      cp_async16(&Bs[stage][row * B_STRIDE + ch * 8], ok ? B + gk * N + gn : B, ok);
    }
  };

  const int nkt = (K + BK - 1) / BK;
  load_tile(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nkt; ++kt) {
    if (kt + 1 < nkt) {
      load_tile((kt + 1) & 1, kt + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* as = As[kt & 1];
    const __nv_bfloat16* bs = Bs[kt & 1];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int row = wm * 64 + mt * 16 + (lane & 15);
        ldmatrix_x4(af[mt], as + row * A_STRIDE + kk + (lane >> 4) * 8);
      }
      // x4.trans over a 16(k) x 16(n) block: regs {b0,b1} of two n-tiles.
      uint32_t bfr[2][4];
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int krow = kk + (lane & 15);
        ldmatrix_x4_trans(bfr[np], bs + krow * B_STRIDE + wn * 32 + np * 16 + (lane >> 4) * 8);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          mma_bf16(acc[mt][nt], af[mt], bfr[nt >> 1][(nt & 1) * 2], bfr[nt >> 1][(nt & 1) * 2 + 1]);
        }
      }
    }
    __syncthreads();
  }

  // Cast back to C's dtype, in place.
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const long long col = n0 + wn * 32 + nt * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = m0 + wm * 64 + mt * 16 + g + 8 * h;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (row < M && col + e < N) {
            C[row * N + col + e] = __float2bfloat16(acc[mt][nt][2 * h + e]);
          }
        }
      }
    }
  }
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

// dtype: 0 = float32, 1 = bfloat16.  Row-major contiguous C (M,N), A (M,K),
// B (K,N) on the current device; stream is a cudaStream_t.  Returns the
// launch's cudaError_t (0 = launched).
extern "C" int matmul_update(void* c, const void* a, const void* b, int M, int N, int K,
                             int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & 15) == 0;
  if (dtype == 1) {
    auto* C = static_cast<__nv_bfloat16*>(c);
    auto* A = static_cast<const __nv_bfloat16*>(a);
    auto* B = static_cast<const __nv_bfloat16*>(b);
    if (K % 8 == 0 && N % 8 == 0 && aligned) {
      dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
      matmul_update_bf16_mma<<<grid, MMA_THREADS, 0, s>>>(C, A, B, M, N, K);
    } else {
      dim3 grid((N + SB - 1) / SB, (M + SB - 1) / SB);
      matmul_update_simt<__nv_bfloat16><<<grid, SIMT_THREADS, 0, s>>>(C, A, B, M, N, K);
    }
  } else if (dtype == 0) {
    dim3 grid((N + SB - 1) / SB, (M + SB - 1) / SB);
    matmul_update_simt<float><<<grid, SIMT_THREADS, 0, s>>>(
        static_cast<float*>(c), static_cast<const float*>(a), static_cast<const float*>(b), M, N, K);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
