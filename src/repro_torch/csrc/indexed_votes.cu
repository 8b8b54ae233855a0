// Falsification-index votes (paper Eq. 4 in matmul form) for Hopper, sm_90a.
//
// Replaces the TPU kernel repro.kernels.indexed._indexed_votes_kernel
// (src/repro/kernels/indexed.py:103, pallas_call at :158):
//
//   votes[b, i] = -sum_j [ exists k: pos[i, j, k] != -1 and lit[b, k] == 0 ] * pol[j]
//
// Inputs: pos (m, n, L) int32 with -1 where clause j of class i excludes
// literal k; lit (B, L) uint8 literal truth values; pol (n,) int32 +-1.
// Output: out (B, m) int32, zeroed by the caller.
//
// What bounds it on an H100: reading pos. At the MNIST width (m=10, n=2000,
// L=1568) pos is 125.4 MB against 50 KB of literals, so the least time is
// pos over the memory rate (about 37 us at 3.35 TB/s), whatever the batch.
// The TPU grid re-reads pos once per 8-row batch tile; here pos is read once
// per 32 samples, so once for every serving bucket (B <= 32):
//
//   1. pack_false_literals turns the batch into one uint32 per literal whose
//      bit b says "literal k is false in sample b" (32 samples per word);
//   2. indexed_votes_kernel gives each warp a few clause rows of one class.
//      The lanes stream a row of pos in coalesced 16-byte loads (evict-first:
//      pos is read once), OR the false-literal word of every member literal
//      into a register, and one warp OR-reduction yields the falsified bit of
//      every sample at once. Lane b then owns sample b's vote. Votes reduce
//      in shared memory and land with one int32 atomicAdd per (sample, class)
//      per block: integer sums, so the result is exact and deterministic.
//
// Ragged edges are masked in the kernel: no padded copy of pos is made.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kClausesPerWarp = 4;
constexpr int kClauseTile = kWarps * kClausesPerWarp;  // clauses per block
constexpr int kLitTile = 2048;  // false-literal words staged per pass (8 KB)

// fl[c, k]: bit b set iff sample 32c+b exists and lit[32c+b, k] == 0.
__global__ void pack_false_literals(const uint8_t* __restrict__ lit,
                                    uint32_t* __restrict__ fl, int B, int L) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int c = blockIdx.y;
  if (k >= L) return;
  const int b0 = c * 32;
  const int nb = min(32, B - b0);
  uint32_t word = 0;
  for (int b = 0; b < nb; ++b)
    word |= static_cast<uint32_t>(lit[static_cast<size_t>(b0 + b) * L + k] == 0) << b;
  fl[static_cast<size_t>(c) * L + k] = word;
}

// Grid: (ceil(n / kClauseTile), m, ceil(B / 32)). VEC = 4 needs L % 4 == 0
// and a 16-byte aligned pos; VEC = 1 takes any L.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
indexed_votes_kernel(const int32_t* __restrict__ pos,
                     const uint32_t* __restrict__ fl,
                     const int32_t* __restrict__ pol,
                     int32_t* __restrict__ out, int m, int n, int L, int B) {
  __shared__ __align__(16) uint32_t fl_s[kLitTile];
  __shared__ int votes_s[32];
  const int i = blockIdx.y;
  const int c = blockIdx.z;
  const int j0 = blockIdx.x * kClauseTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) votes_s[threadIdx.x] = 0;

  uint32_t acc[kClausesPerWarp];
#pragma unroll
  for (int q = 0; q < kClausesPerWarp; ++q) acc[q] = 0u;

  const uint32_t* flc = fl + static_cast<size_t>(c) * L;
  for (int k0 = 0; k0 < L; k0 += kLitTile) {
    const int kn = min(kLitTile, L - k0);
    __syncthreads();  // the previous tile is consumed (and votes_s is set)
    for (int t = threadIdx.x; t < kn; t += kThreads) fl_s[t] = flc[k0 + t];
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kClausesPerWarp; ++q) {
      const int j = j0 + warp * kClausesPerWarp + q;
      if (j < n) {  // uniform across the warp
        const int32_t* row = pos + (static_cast<size_t>(i) * n + j) * L + k0;
        uint32_t a = 0u;
        if (VEC == 4) {
          const int4* row4 = reinterpret_cast<const int4*>(row);
          const uint4* fl4 = reinterpret_cast<const uint4*>(fl_s);
          const int kn4 = kn >> 2;
#pragma unroll 4
          for (int u = lane; u < kn4; u += 32) {
            const int4 p = __ldcs(row4 + u);
            const uint4 f = fl4[u];
            a |= (p.x != -1 ? f.x : 0u) | (p.y != -1 ? f.y : 0u) |
                 (p.z != -1 ? f.z : 0u) | (p.w != -1 ? f.w : 0u);
          }
        } else {
#pragma unroll 4
          for (int u = lane; u < kn; u += 32) {
            const int32_t p = __ldcs(row + u);
            a |= (p != -1) ? fl_s[u] : 0u;
          }
        }
        acc[q] |= a;
      }
    }
  }

  // lane b accumulates sample (32c + b)'s vote over this warp's clauses
  int v = 0;
#pragma unroll
  for (int q = 0; q < kClausesPerWarp; ++q) {
    const int j = j0 + warp * kClausesPerWarp + q;
    if (j < n) {
      const uint32_t falsified = __reduce_or_sync(0xffffffffu, acc[q]);
      if ((falsified >> lane) & 1u) v -= pol[j];
    }
  }
  if (v != 0) atomicAdd(&votes_s[lane], v);
  __syncthreads();
  const int b = c * 32 + static_cast<int>(threadIdx.x);
  if (threadIdx.x < 32 && b < B && votes_s[threadIdx.x] != 0)
    atomicAdd(&out[static_cast<size_t>(b) * m + i], votes_s[threadIdx.x]);
}

}  // namespace

// fl: (ceil(B/32), L) uint32 scratch; out: (B, m) int32, zero-filled.
// Returns cudaGetLastError() after the launches.
extern "C" int indexed_votes_launch(const void* pos, const void* lit,
                                    const void* pol, void* fl, void* out,
                                    int m, int n, int L, int B, int vec4,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunks = (B + 31) / 32;
  const dim3 pack_grid((L + 255) / 256, chunks);
  pack_false_literals<<<pack_grid, 256, 0, s>>>(
      static_cast<const uint8_t*>(lit), static_cast<uint32_t*>(fl), B, L);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kClauseTile - 1) / kClauseTile, m, chunks);
  if (vec4) {
    indexed_votes_kernel<4><<<grid, kThreads, 0, s>>>(
        static_cast<const int32_t*>(pos), static_cast<const uint32_t*>(fl),
        static_cast<const int32_t*>(pol), static_cast<int32_t*>(out), m, n, L, B);
  } else {
    indexed_votes_kernel<1><<<grid, kThreads, 0, s>>>(
        static_cast<const int32_t*>(pos), static_cast<const uint32_t*>(fl),
        static_cast<const int32_t*>(pol), static_cast<int32_t*>(out), m, n, L, B);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* indexed_votes_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
