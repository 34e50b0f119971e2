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
// What the design does about it.  The TPU kernel walks sequence blocks in
// order on one core, carrying the state in VMEM scratch, with a log-depth
// scan inside each block; CUDA blocks run in no order, so here the carry is
// a loop inside each thread.  One thread owns one (b, d) channel and walks
// S, neighbouring threads on neighbouring d, so every load and store of a
// warp is one 128-byte line.  Loads run 16 steps ahead of the recurrence
// (a register buffer per step group) to keep enough bytes in flight.  The
// multiply and the add are rounded separately (no FMA contraction), as the
// plain version rounds them.  At B=4, D=2560 that is only 10,240 threads —
// 80 blocks for 132 SMs — so the card's memory rate is out of reach; a
// chunked two-pass scan (per-chunk partial products and sums, then a pass
// that carries the chunk states) is the later redesign.
//
// The kernel launches on the caller's stream, does not synchronise and
// allocates nothing.  The entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128, AHEAD = 16;

__global__ void __launch_bounds__(THREADS)
    rglru_scan_kernel(const float* __restrict__ log_a, const float* __restrict__ b,
                      const float* __restrict__ h0, float* __restrict__ out, int B, int S, int D) {
  const long long ch = (long long)blockIdx.x * THREADS + threadIdx.x;
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

// log_a, b, out (B,S,D) and h0 (B,D) or null: contiguous float32 on the
// current device; stream is a cudaStream_t.  Returns the launch's
// cudaError_t (0 = launched).
extern "C" int rglru_scan(const void* log_a, const void* b, const void* h0, void* out, int B,
                          int S, int D, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long channels = (long long)B * D;
  const unsigned blocks = static_cast<unsigned>((channels + THREADS - 1) / THREADS);
  rglru_scan_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(log_a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(out), B, S, D);
  return static_cast<int>(cudaGetLastError());
}
