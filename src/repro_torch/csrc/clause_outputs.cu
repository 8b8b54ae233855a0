// Per-clause outputs of bit-packed clauses, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro.kernels.clause_eval._outputs_kernel
// (src/repro/kernels/clause_eval.py:121, pallas_call at :147):
//
//   out[b, i, j] = 1  iff  for all w: inc[i, j, w] & ~lit[b, w] == 0
//
// Inputs: inc (m, n, W) packed include words, lit (B, W) packed literal
// words (32-bit words, bit-identical to the reference's uint32). An empty
// clause gives 1. Output: out (B, m, n) int8, every element written.
//
// What bounds it on an H100: on the training path it runs once per class
// round at (B, m) = (1, 1): 2000 clauses of 49 words at the MNIST width,
// 0.39 MB of include words, 0.12 us at 3.35 TB/s. That is far below one
// launch and the two dependent loads each warp waits for, so it is latency
// bound. At (B, m) = (32, 10) the and-not-or work (one LOP3 per include
// word per sample, 31.4 M, 1.9 us at 64 logic results per clock per SM)
// bounds it.
//
// Design: one warp per (b, i, j) clause, so B = 1 keeps every lane busy
// (a lane per sample, as clause_votes.cu has it, would idle 31 of 32). The
// lanes stride over the row's W words in coalesced loads, each ORs
// inc & ~lit into a register, and __any_sync reduces the violation across
// the warp; lane 0 writes the byte. The warp index runs j fastest, matching
// the (B, m, n) output, so neighbouring warps read neighbouring include rows
// and the same sample's literal words (which stay in L1). Any (B, m, n, W)
// works: the clause count rounds up to whole blocks, surplus warps return
// before the vote, and nothing is padded or copied.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// Grid: ceil(B·m·n / kWarps) blocks of kWarps warps; warp g is clause g of
// the flattened (B, m, n) output.
__global__ void __launch_bounds__(kThreads)
clause_outputs_kernel(const uint32_t* __restrict__ inc,
                      const uint32_t* __restrict__ lit,
                      int8_t* __restrict__ out, long long clauses, int mn,
                      int W) {
  const long long g =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (g >= clauses) return;  // the whole warp: g is uniform across it
  const int lane = threadIdx.x & 31;
  const long long b = g / mn;
  const long long ij = g - b * mn;  // i * n + j
  const uint32_t* row = inc + ij * W;
  const uint32_t* lw = lit + b * W;
  uint32_t v = 0u;
  for (int w = lane; w < W; w += 32) v |= __ldg(row + w) & ~__ldg(lw + w);
  const bool falsified = __any_sync(0xffffffffu, v != 0u);
  if (lane == 0) out[g] = falsified ? 0 : 1;
}

}  // namespace

// out: (B, m, n) int8. Returns cudaGetLastError() after the launch.
extern "C" int clause_outputs_launch(const void* inc, const void* lit,
                                     void* out, long long clauses, int mn,
                                     int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long blocks = (clauses + kWarps - 1) / kWarps;
  clause_outputs_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, s>>>(
      static_cast<const uint32_t*>(inc), static_cast<const uint32_t*>(lit),
      static_cast<int8_t*>(out), clauses, mn, W);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* clause_outputs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
