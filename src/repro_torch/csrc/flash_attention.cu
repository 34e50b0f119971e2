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
// head: K and V are re-read once per query head (from L2, mostly).
//
// What the design does about it.  The TPU kernel walks the KV blocks of one
// query block in order on one core, carrying m, l and acc in VMEM scratch;
// here one block of 4 warps owns 64 query rows of one (b, h) and walks its
// visible 64-key tiles in order inside the block, carrying m, l and the
// 16 x D accumulator of each warp in registers.  Both products run on the
// tensor cores (mma.sync m16n8k16 bf16, fp32 accumulation, fed by ldmatrix
// from padded shared-memory rows).  K and V tiles stream in with cp.async
// in separate groups, so the V tile's copy overlaps the QKᵀ product and the
// next K tile's copy overlaps the PV product.  At D = 256 the Q, K and V
// tiles take 101,376 bytes of shared memory (dynamic, opted in), two blocks
// per SM.  Tiles wholly outside a block's visible key range [first query −
// window + 1, last query] are never visited (the TPU kernel's block skip).
// A masked logit contributes exactly 0 to l and acc (not exp(−2e38 − m)),
// so rows of a tile that see none of its keys — the window's first tiles —
// keep no terms, whatever order tiles are visited in.  A row that sees no
// key at all (causal with Sq > Sk) would get 0, but ops.flash_attention
// refuses that shape before dispatch.  wgmma, TMA and warp specialisation
// are later work.
//
// float32 inputs, bf16 with D not one of 16/32/64/128/256, and operands not
// 16-byte aligned run a plain kernel with the same contract: one warp per
// query row, each lane holding D/32 of the row's features, walking the
// visible keys one at a time (float32 stays full fp32, never TF32).
//
// The kernels launch on the caller's stream, do not synchronise and
// allocate nothing.  The entry returns cudaGetLastError().

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

// ---------------------------------------------------------------- tensor cores

constexpr int BM = 64, BN = 64, MMA_THREADS = 128;

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
constexpr int smem_bytes() {
  return (BM + 2 * BN) * (D + 8) * 2;
}

// Copy `rows` rows of D bf16 starting at row r0 of a (.., S, D) slab into
// shared rows of stride D + 8; rows at or past `limit` are zero-filled.
template <int D>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long row_stride, int r0, int rows, int limit) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < rows * CH; c += MMA_THREADS) {
    const int r = c / CH, col = (c % CH) * 8;
    const bool ok = r0 + r < limit;
    cp_async16(dst + r * (D + 8) + col, ok ? src + (long long)(r0 + r) * row_stride + col : src, ok);
  }
}

// Each warp owns 16 query rows of the block's 64: thread (g = lane/4,
// t = lane%4) holds rows g and g + 8 of the warp's slab, columns 2t, 2t+1 of
// every 8-wide tile (the mma accumulator layout).
template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
    flash_fwd_bf16_mma(const __nv_bfloat16* __restrict__ Q, const __nv_bfloat16* __restrict__ K,
                       const __nv_bfloat16* __restrict__ V, __nv_bfloat16* __restrict__ O,
                       Problem p) {
  constexpr int STR = D + 8;
  constexpr int DT = D / 8;  // 8-wide output tiles per row
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BM * STR;
  __nv_bfloat16* Vs = Ks + BN * STR;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H, kvh = h / p.G;
  const int q0 = blockIdx.x * BM;
  const int q_off = p.Sk - p.Sq;
  const __nv_bfloat16* Qb = Q + b * p.q.b + h * p.q.h;
  const __nv_bfloat16* Kb = K + b * p.k.b + kvh * p.k.h;
  const __nv_bfloat16* Vb = V + b * p.v.b + kvh * p.v.h;

  int lo, hi;
  key_range(p, q0 + q_off, min(q0 + BM, p.Sq) - 1 + q_off, lo, hi);
  const int t_lo = lo / BN, t_hi = (hi >= lo) ? hi / BN : t_lo - 1;

  // Q and the first K tile in one group, the first V tile in the next.
  load_rows<D>(Qs, Qb, p.q.s, q0, BM, p.Sq);
  if (t_lo <= t_hi) load_rows<D>(Ks, Kb, p.k.s, t_lo * BN, BN, p.Sk);
  cp_async_commit();
  if (t_lo <= t_hi) load_rows<D>(Vs, Vb, p.v.s, t_lo * BN, BN, p.Sk);
  cp_async_commit();

  const int qpos[2] = {q0 + warp * 16 + g + q_off, q0 + warp * 16 + g + 8 + q_off};
  float m[2] = {NEG, NEG}, l[2] = {0.0f, 0.0f};
  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.0f;

  for (int tile = t_lo; tile <= t_hi; ++tile) {
    const int k0 = tile * BN;
    cp_async_wait<1>();  // Q and this K tile have landed (V may be in flight)
    __syncthreads();

    // S = Q Kᵀ for this warp's 16 rows x 64 keys: 8 key tiles of 8.
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, Qs + (warp * 16 + (lane & 15)) * STR + kk + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bf[4];
        ldmatrix_x4(bf, Ks + (np * 16 + ((lane >> 4) << 3) + (lane & 7)) * STR + kk +
                            (((lane >> 3) & 1) << 3));
        mma_bf16(s[2 * np], a, bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], a, bf[2], bf[3]);
      }
    }
    __syncthreads();  // every warp is done with Ks: the next K tile may land there
    if (tile < t_hi) load_rows<D>(Ks, Kb, p.k.s, k0 + BN, BN, p.Sk);
    cp_async_commit();

    // Scale, softcap, mask; the online softmax update of rows g and g + 8.
    uint32_t keep = 0;
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, key = k0 + nt * 8 + 2 * t + (e & 1);
        const float x = cap_logit(p, s[nt][e]);
        const bool ok = visible(p, qpos[r], key);
        s[nt][e] = ok ? x : NEG;
        keep |= (ok ? 1u : 0u) << (nt * 4 + e);
        mx[r] = fmaxf(mx[r], s[nt][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float pe = ((keep >> (nt * 4 + e)) & 1u) ? expf(s[nt][e] - m[r]) : 0.0f;
        s[nt][e] = pe;
        l[r] += pe;  // this thread's columns; the quad's partial sums meet at the end
      }
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }

    cp_async_wait<1>();  // this V tile has landed (the next K may be in flight)
    __syncthreads();
    // acc += P V: P from registers (the accumulator layout is the A layout),
    // V through ldmatrix.trans.
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      a[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      a[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      a[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, Vs + (kc * 16 + (lane & 15)) * STR + dp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], a, bf[0], bf[1]);
        mma_bf16(acc[2 * dp + 1], a, bf[2], bf[3]);
      }
    }
    __syncthreads();  // every warp is done with Vs
    if (tile < t_hi) load_rows<D>(Vs, Vb, p.v.s, k0 + BN, BN, p.Sk);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // Normalise and store rows g and g + 8.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float inv[2] = {1.0f / fmaxf(l[0], 1e-30f), 1.0f / fmaxf(l[1], 1e-30f)};
  __nv_bfloat16* Ob = O + b * p.o.b + h * p.o.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= p.Sq) continue;
    __nv_bfloat16* dst = Ob + (long long)row * p.o.s + 2 * t;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      *reinterpret_cast<__nv_bfloat162*>(dst + dt * 8) =
          __floats2bfloat162_rn(acc[dt][2 * r] * inv[r], acc[dt][2 * r + 1] * inv[r]);
    }
  }
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

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o, const Problem& p, int B,
               cudaStream_t s) {
  constexpr int bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16_mma<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.Sq + BM - 1) / BM, B * p.H);
  flash_fwd_bf16_mma<D><<<grid, MMA_THREADS, bytes, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), p);
  return 0;
}

template <typename T>
void launch_rows(const void* q, const void* k, const void* v, void* o, const Problem& p, int B,
                 cudaStream_t s) {
  dim3 grid((p.Sq + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK, B * p.H);
  flash_fwd_rows<T><<<grid, 32 * ROWS_PER_BLOCK, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), p);
}

}  // namespace

// q (B,H,Sq,D), k/v (B,Kv,Sk,D), out like q, each with element strides
// (b, h, s) and a contiguous last dim, on the current device; dtype 0 =
// float32, 1 = bfloat16; stream is a cudaStream_t.  Returns the launch's
// cudaError_t (0 = launched).
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out,
                               long long qsb, long long qsh, long long qss, long long ksb,
                               long long ksh, long long kss, long long vsb, long long vsh,
                               long long vss, long long osb, long long osh, long long oss, int B,
                               int H, int Kv, int Sq, int Sk, int D, float scale, float softcap,
                               int causal, int window, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || Kv <= 0 || H % Kv || Sq <= 0 || Sk <= 0 || D <= 0 || D > 32 * MAXC)
    return static_cast<int>(cudaErrorInvalidValue);
  Problem p{{qsb, qsh, qss}, {ksb, ksh, kss}, {vsb, vsh, vss}, {osb, osh, oss},
            H, H / Kv, Sq, Sk, D, scale, softcap, causal, window};
  if (dtype == 1) {
    const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                           reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out);
    const long long strides = qsb | qsh | qss | ksb | ksh | kss | vsb | vsh | vss | osb | osh | oss;
    const bool aligned = (ptrs & 15) == 0 && (strides & 7) == 0;
    int err = -1;
    if (aligned) {
      switch (D) {
        case 16: err = launch_mma<16>(q, k, v, out, p, B, s); break;
        case 32: err = launch_mma<32>(q, k, v, out, p, B, s); break;
        case 64: err = launch_mma<64>(q, k, v, out, p, B, s); break;
        case 128: err = launch_mma<128>(q, k, v, out, p, B, s); break;
        case 256: err = launch_mma<256>(q, k, v, out, p, B, s); break;
        default: break;
      }
    }
    if (err > 0) return err;
    if (err < 0) launch_rows<__nv_bfloat16>(q, k, v, out, p, B, s);
  } else if (dtype == 0) {
    launch_rows<float>(q, k, v, out, p, B, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
