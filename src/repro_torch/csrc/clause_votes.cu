// Bit-packed clause evaluation fused with the polarity vote, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel repro.kernels.clause_eval._votes_kernel
// (src/repro/kernels/clause_eval.py:45, pallas_call at :101):
//
//   votes[b, i] = sum_j [ for all w: inc[i, j, w] & ~lit[b, w] == 0 ] * pol[j]
//
// Inputs: inc (m, n, W) packed include words, lit (B, W) packed literal
// words (32-bit words, bit-identical to the reference's uint32), pol (n,)
// int32 +-1. An empty clause counts as true. Include bits beyond 2o are 0.
// Output: out (B, m) int32, zeroed by the caller.
//
// What bounds it on an H100: at the MNIST width and B=32, the and-not-or
// work (one LOP3 per include word per sample, 31.4 M, about 1.9 us at 64
// logic results per clock per SM) just above reading inc (3.9 MB, about
// 1.2 us at 3.35 TB/s). At that size the launch and the latency of one
// block's serial walk dominate, which this first version accepts.
//
// Design: one block per (32 clauses of one class, 32 samples). The block
// stages its samples' literal words in shared memory, transposed so that
// lane b reads sample b without bank conflicts. Each warp takes clause rows;
// the lanes load 32 include words of a row in one coalesced access and pass
// them round with shuffles, while lane b ORs inc & ~lit for sample b. Lane b
// then adds the clause's polarity to sample b's vote if nothing was
// violated. Votes reduce in shared memory and land with one int32 atomicAdd
// per (sample, class) per block: exact and deterministic.
//
// Ragged edges are masked in the kernel: no padded copy of inc is made.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kClausesPerWarp = 4;
constexpr int kClauseTile = kWarps * kClausesPerWarp;  // clauses per block
constexpr int kWordTile = 128;  // literal words staged per pass

// Grid: (ceil(n / kClauseTile), m, ceil(B / 32)).
__global__ void __launch_bounds__(kThreads)
clause_votes_kernel(const uint32_t* __restrict__ inc,
                    const uint32_t* __restrict__ lit,
                    const int32_t* __restrict__ pol,
                    int32_t* __restrict__ out, int m, int n, int W, int B) {
  __shared__ uint32_t lit_s[kWordTile][33];  // [word][sample], padded row
  __shared__ int votes_s[32];
  const int i = blockIdx.y;
  const int b0 = blockIdx.z * 32;
  const int nb = min(32, B - b0);
  const int j0 = blockIdx.x * kClauseTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) votes_s[threadIdx.x] = 0;

  uint32_t viol[kClausesPerWarp];
#pragma unroll
  for (int q = 0; q < kClausesPerWarp; ++q) viol[q] = 0u;

  for (int w0 = 0; w0 < W; w0 += kWordTile) {
    const int wn = min(kWordTile, W - w0);
    __syncthreads();  // the previous tile is consumed (and votes_s is set)
    for (int t = threadIdx.x; t < 32 * wn; t += kThreads) {
      const int b = t / wn;
      const int w = t - b * wn;
      // absent samples read as all-true literals: never violated, never stored
      lit_s[w][b] = b < nb ? lit[static_cast<size_t>(b0 + b) * W + w0 + w]
                           : 0xffffffffu;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kClausesPerWarp; ++q) {
      const int j = j0 + warp * kClausesPerWarp + q;
      if (j < n) {  // uniform across the warp
        const uint32_t* row = inc + (static_cast<size_t>(i) * n + j) * W + w0;
        uint32_t v = 0u;
        for (int ws = 0; ws < wn; ws += 32) {
          const int cnt = min(32, wn - ws);
          const uint32_t mine = lane < cnt ? __ldg(row + ws + lane) : 0u;
          for (int t = 0; t < cnt; ++t) {
            const uint32_t iw = __shfl_sync(0xffffffffu, mine, t);
            v |= iw & ~lit_s[ws + t][lane];
          }
        }
        viol[q] |= v;
      }
    }
  }

  int vote = 0;
#pragma unroll
  for (int q = 0; q < kClausesPerWarp; ++q) {
    const int j = j0 + warp * kClausesPerWarp + q;
    if (j < n && viol[q] == 0u) vote += pol[j];
  }
  if (vote != 0) atomicAdd(&votes_s[lane], vote);
  __syncthreads();
  if (threadIdx.x < 32 && static_cast<int>(threadIdx.x) < nb &&
      votes_s[threadIdx.x] != 0)
    atomicAdd(&out[static_cast<size_t>(b0 + threadIdx.x) * m + i],
              votes_s[threadIdx.x]);
}

}  // namespace

// out: (B, m) int32, zero-filled. Returns cudaGetLastError() after launch.
extern "C" int clause_votes_launch(const void* inc, const void* lit,
                                   const void* pol, void* out, int m, int n,
                                   int W, int B, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + kClauseTile - 1) / kClauseTile, m, (B + 31) / 32);
  clause_votes_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const uint32_t*>(inc), static_cast<const uint32_t*>(lit),
      static_cast<const int32_t*>(pol), static_cast<int32_t*>(out), m, n, W, B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* clause_votes_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
