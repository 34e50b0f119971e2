// rglru_scan.cu — the RG-LRU linear recurrence, written by hand for Hopper
// (sm_90a), with a plain C entry point loaded through ctypes.
//
// Replaces src/repro/kernels/rglru.py:48 (rglru_scan_pallas, body _kernel at
// :26): h_t = exp(log_a_t) · h_{t-1} + b_t along S for (B, S, D) float32,
// from an optional initial state h0 (B, D) — the Pallas kernel fixes h0 = 0;
// the model's cache carries one, so this kernel takes it.
//
// What bounds it on an H100.  It reads log_a and b and writes h once:
// 3 · B · S · D · 4 bytes, 503 MB at the serving shape (B=4, S=4096,
// D=2560), 0.15 ms at 3.35 TB/s, against 2 operations and one exp per
// element: bound by bytes.
//
// What the design does about it (route "chunked").  The TPU kernel walks
// sequence blocks in order on one core, carrying the state in VMEM
// scratch; CUDA blocks run in no order, and a thread per channel walking
// all of S (route "serial" below) leaves the card short of parallel work
// (10,240 threads at the serving shape).  Here S is cut into chunks of
// CHUNK = 64 steps, and a block owns one chunk of TILE = 128 neighbouring
// channels of one batch row: every warp load and store is one 128-byte
// line, and the serving shape has 5,120 blocks.  Each thread, for its
// channel:
//   1. loads the chunk's log_a and b once, into registers (all 128 loads
//      issued before the first use);
//   2. computes the chunk's aggregate from zero: A = Π exp(log_a_t) and the
//      local end state Bl, each multiply and add rounded separately (no FMA
//      contraction), as the plain version rounds them;
//   3. takes its carry — h0 for the first chunk, else the end state the
//      block of the previous chunk published — and publishes its own end
//      state A · carry + Bl for the next chunk at once;
//   4. replays the chunk from the carry, out of the registers, and writes h.
// So log_a and b are read once and h written once: the bytes of the bound,
// plus 4 bytes a channel a chunk of published state (0.5 %).
//
// Order and determinism.  Blocks take a ticket from an atomic counter and
// own the chunk the ticket names, chunks in order: a block waits only on a
// block that took an earlier ticket, so it is running or done, and no
// block waits on one that is not resident.  Each chunk waits for its
// predecessor's published end state and never folds in the aggregates of
// earlier chunks (the decoupled look-back of a parallel prefix sum would
// combine however many it finds ready, and the sums would be rounded in an
// order that changes from launch to launch).  Every carry is therefore one
// fixed expression, and two launches on the same inputs give the same bits.
// The chain's cost is one publish-and-observe a chunk (64 a sequence at the
// serving shape), overlapped with the loads of the chunks behind it.
//
// Numerics.  Only the carry into each chunk is reassociated (A · carry + Bl
// instead of 64 sequential steps); every step inside a chunk is the
// sequential recurrence from that carry, and with 0 < a < 1 an error in the
// carry decays along the chunk.
//
// Scratch (the wrapper allocates it; the kernel allocates nothing):
// `flags`, int32, zeroed, 1 + tiles · chunks: the ticket counter, then one
// flag a (chunk, tile) set once its end state is published; `state`,
// float32, tiles · chunks · TILE: the published end states.
//
// Route "serial" (the kernel of the first port, kept for the before/after
// timing in one run): one thread owns one (b, d) channel and walks all of
// S, loads 16 steps ahead of the recurrence.
//
// The kernels launch on the caller's stream, do not synchronise and
// allocate nothing.  The entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128, CHUNK = 64;

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

__global__ void __launch_bounds__(TILE)
    rglru_scan_chunked(const float* __restrict__ log_a, const float* __restrict__ b,
                       const float* __restrict__ h0, float* __restrict__ out, int* __restrict__ flags,
                       float* __restrict__ state, int B, int S, int D, int d_tiles, int chunks) {
  __shared__ int ticket;
  if (threadIdx.x == 0) ticket = atomicAdd(flags, 1);
  __syncthreads();
  const int tiles = B * d_tiles;
  const int chunk = ticket / tiles, tile = ticket % tiles;
  const int bb = tile / d_tiles;
  const int d = (tile % d_tiles) * TILE + threadIdx.x;
  const int t0 = chunk * CHUNK;
  const int steps = min(CHUNK, S - t0);
  const bool live = d < D;
  const long long base = ((long long)bb * S + t0) * D + d;

  // 1. the chunk's inputs; steps past S (and dead channels) hold a = 1, b = 0
  float a[CHUNK], x[CHUNK];
#pragma unroll
  for (int u = 0; u < CHUNK; ++u) {
    const bool ok = live && u < steps;
    a[u] = ok ? __ldg(log_a + base + (long long)u * D) : 0.0f;
    x[u] = ok ? __ldg(b + base + (long long)u * D) : 0.0f;
  }
  // 2. the aggregate from zero
  float A = 1.0f, Bl = 0.0f;
#pragma unroll
  for (int u = 0; u < CHUNK; ++u) {
    a[u] = expf(a[u]);
    A = __fmul_rn(A, a[u]);
    Bl = __fadd_rn(__fmul_rn(a[u], Bl), x[u]);
  }
  // 3. the carry, then this chunk's end state for the next
  const int slot = chunk * tiles + tile;
  float carry;
  if (chunk == 0) {
    carry = (h0 != nullptr && live) ? h0[(long long)bb * D + d] : 0.0f;
  } else {
    const int prev = slot - tiles;
    if (threadIdx.x == 0) {
      while (ld_acquire(flags + 1 + prev) == 0) __nanosleep(32);
    }
    __syncthreads();
    carry = __ldcg(state + (long long)prev * TILE + threadIdx.x);
  }
  if (chunk + 1 < chunks) {
    __stcg(state + (long long)slot * TILE + threadIdx.x, __fadd_rn(__fmul_rn(A, carry), Bl));
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) st_release(flags + 1 + slot, 1);
  }
  // 4. the replay
  if (!live) return;
  float h = carry;
#pragma unroll
  for (int u = 0; u < CHUNK; ++u) {
    h = __fadd_rn(__fmul_rn(a[u], h), x[u]);
    if (u < steps) out[base + (long long)u * D] = h;
  }
}

constexpr int SERIAL_THREADS = 128, AHEAD = 16;

__global__ void __launch_bounds__(SERIAL_THREADS)
    rglru_scan_serial(const float* __restrict__ log_a, const float* __restrict__ b,
                      const float* __restrict__ h0, float* __restrict__ out, int B, int S, int D) {
  const long long ch = (long long)blockIdx.x * SERIAL_THREADS + threadIdx.x;
  if (ch >= (long long)B * D) return;
  const long long bb = ch / D, d = ch % D;
  const long long base = bb * S * D + d;
  const float* la = log_a + base;
  const float* bv = b + base;
  float* o = out + base;
  float h = h0 != nullptr ? h0[bb * D + d] : 0.0f;

  int t = 0;
  for (; t + AHEAD <= S; t += AHEAD) {
    float a[AHEAD], x[AHEAD];
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      a[u] = __ldg(la + (long long)(t + u) * D);
      x[u] = __ldg(bv + (long long)(t + u) * D);
    }
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      h = __fadd_rn(__fmul_rn(expf(a[u]), h), x[u]);
      o[(long long)(t + u) * D] = h;
    }
  }
  for (; t < S; ++t) {
    h = __fadd_rn(__fmul_rn(expf(__ldg(la + (long long)t * D)), h), __ldg(bv + (long long)t * D));
    o[(long long)t * D] = h;
  }
}

}  // namespace

// Steps of one chunk and channels of one tile of the "chunked" route (the
// wrapper sizes the scratch from them).
extern "C" int rglru_scan_chunk_steps() { return CHUNK; }
extern "C" int rglru_scan_tile_channels() { return TILE; }

// log_a, b, out (B,S,D) and h0 (B,D) or null: contiguous float32 on the
// current device.  route 0 = "chunked" (flags: n_flags zeroed int32, state:
// n_state float32, as above), 1 = "serial" (flags and state unused).
// stream is a cudaStream_t.  Returns the launch's cudaError_t (0 = launched).
extern "C" int rglru_scan(const void* log_a, const void* b, const void* h0, void* out, void* flags,
                          void* state, long long n_flags, long long n_state, int B, int S, int D,
                          int route, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 0) {
    const int d_tiles = (D + TILE - 1) / TILE, chunks = (S + CHUNK - 1) / CHUNK;
    const long long blocks = (long long)B * d_tiles * chunks;
    if (flags == nullptr || state == nullptr || n_flags < 1 + blocks || n_state < blocks * TILE ||
        blocks >= (1ll << 31))
      return static_cast<int>(cudaErrorInvalidValue);
    rglru_scan_chunked<<<static_cast<unsigned>(blocks), TILE, 0, s>>>(
        static_cast<const float*>(log_a), static_cast<const float*>(b), static_cast<const float*>(h0),
        static_cast<float*>(out), static_cast<int*>(flags), static_cast<float*>(state), B, S, D, d_tiles,
        chunks);
  } else if (route == 1) {
    const long long channels = (long long)B * D;
    const unsigned blocks = static_cast<unsigned>((channels + SERIAL_THREADS - 1) / SERIAL_THREADS);
    rglru_scan_serial<<<blocks, SERIAL_THREADS, 0, s>>>(
        static_cast<const float*>(log_a), static_cast<const float*>(b), static_cast<const float*>(h0),
        static_cast<float*>(out), B, S, D);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
