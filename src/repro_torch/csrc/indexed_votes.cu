// Falsification-index votes (paper Eq. 4) for Hopper, sm_90a: a walk of the
// false literals' inclusion lists.
//
// Replaces the TPU kernel repro.kernels.indexed._indexed_votes_kernel
// (src/repro/kernels/indexed.py:103, pallas_call at :158), which computes
//
//   votes[b, i] = -sum_j [ exists k: clause j of class i includes literal k
//                          and lit[b, k] == 0 ] * pol[j]
//
// from the dense position matrix. This kernel computes the same function
// the way the paper does: it visits only the inclusion lists of literals
// that are false in some sample, and only their used prefixes.
//
// Inputs (the ClauseIndex and a batch): lists (m, L, cap) int32 clause ids,
// counts (m, L) int32 exact list lengths, pos (m, n, L) int32 (-1 where
// clause j excludes literal k), lit (B, L) uint8, pol (n,) int32 (+-1, 0 on
// padding rows). Output: out (B, m) int32; zeroed by the caller when n
// spans more than one clause window (the windows add into it).
//
// What bounds it on an H100: the list entries it reads (4 B each), which at
// the paper's widths total a few MB against the 125-160 MB of pos that the
// dense form streams. At that size launch latency, and the latency of the
// dependent loads (lit and counts, then the lists), set its time: the
// design keeps many loads in flight and makes one launch.
//
// Design. Block (r, i, z) of a thread-block cluster of K blocks along x
// takes class i, batch word c (32 samples) and clause window w (z = c *
// n_windows + w); the cluster's K blocks split the literal axis (32-literal
// groups dealt round-robin, so positive and negated literals mix).
//   1. A block builds, for each of its literals, the false-literal word f
//      (bit b: literal false in sample 32c + b) and keeps the literals with
//      f != 0 and a non-empty list (the paper's saving).
//   2. Each warp takes kGroup kept lists at a time and lays their used
//      prefixes min(counts, cap) end to end, so that its lanes keep 32 *
//      kUnroll coalesced loads in flight however short the lists are (IMDb's
//      average about 23 ids). Each id ORs f into the block's shared bitmask
//      of the window's clauses (one uint32 per clause: bit b says
//      "falsified in sample 32c + b") with a shared-memory atomicOr, skipped
//      when the bits are already set.
//   3. A list the walk cannot trust is covered from pos instead, by a scan
//      of the column pos[i, :, k] != -1: one whose count exceeds the
//      capacity (ids past the capacity were dropped from the list but stay
//      in pos), or one with a hole (an id that is -1 or out of range) in its
//      used prefix, which the batched event replay leaves in a list that
//      once overflowed. Both are decided here, from counts and the entries
//      read: the host never looks. List order is never assumed.
//   4. After cluster.sync(), block r ORs its 1/K slice of the window's
//      clauses across the K blocks' bitmasks through distributed shared
//      memory and sums -pol[j] over each sample's set bits (lane b owns
//      sample 32c + b). After a second cluster.sync(), block 0 adds the K
//      blocks' sums through distributed shared memory and writes out (one
//      window: a plain store, so no memset launch is needed; more: one
//      int32 atomicAdd per (sample, class, window)). A third keeps every
//      block's shared memory alive until block 0 has read it.
// All integer: the result is exact and deterministic. Empty clauses and
// padding rows are in no list and never falsified, as in the dense form.
// Any n: the bitmask covers a window of clause ids (the launch's `window`),
// and a grid axis takes the windows, each walking the lists again and
// keeping only its ids.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kWarps * 32;  // literals staged per pass: a group per warp
constexpr int kGroup = 8;           // kept lists a warp walks at once
constexpr int kUnroll = 4;          // loads in flight per lane
constexpr int kMaxGridZ = 65535;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ void mark(uint32_t* word, uint32_t f) {
  // bits are only ever set, so a stale read can only cause a needless atomic
  if ((*reinterpret_cast<volatile uint32_t*>(word) & f) != f) atomicOr(word, f);
}

__global__ void __launch_bounds__(kThreads)
indexed_walk_kernel(const int32_t* __restrict__ lists,
                    const int32_t* __restrict__ counts,
                    const int32_t* __restrict__ pos,
                    const uint8_t* __restrict__ lit,
                    const int32_t* __restrict__ pol,
                    int32_t* __restrict__ out,
                    int m, int n, int L, int B, int cap, int window,
                    int n_windows) {
  extern __shared__ uint32_t fmask[];  // falsified bits of the window's clauses
  __shared__ int act_k[kTile];
  __shared__ uint32_t act_f[kTile];
  __shared__ int act_cnt[kTile];
  __shared__ int n_act;
  __shared__ int votes_s[32];

  cg::cluster_group cluster = cg::this_cluster();
  const int K = static_cast<int>(cluster.num_blocks());
  const int r = static_cast<int>(cluster.block_rank());
  const int i = blockIdx.y;
  const int c = blockIdx.z / n_windows;
  const int w0 = (blockIdx.z % n_windows) * window;
  const int wn = min(window, n - w0);
  const int b0 = c * 32;
  const int nb = min(32, B - b0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int u = threadIdx.x; u < wn; u += kThreads) fmask[u] = 0u;
  if (threadIdx.x < 32) votes_s[threadIdx.x] = 0;

  const int groups = (L + 31) / 32;
  const int32_t* counts_i = counts + static_cast<size_t>(i) * L;
  // the loop bound depends on r and q0 only: every thread of the block
  // takes the same number of passes, so the barriers inside are safe
  for (int q0 = 0; r + K * q0 < groups; q0 += kWarps) {
    if (threadIdx.x == 0) n_act = 0;
    __syncthreads();
    // -- stage: warp takes group g; lane takes literal k
    const int g = r + K * (q0 + warp);
    const int k = g * 32 + lane;
    uint32_t f = 0u;
    int cnt = 0;
    if (g < groups && k < L) {
      const uint8_t* lk = lit + static_cast<size_t>(b0) * L + k;
      for (int b = 0; b < nb; ++b)
        f |= static_cast<uint32_t>(__ldg(lk + static_cast<size_t>(b) * L) == 0) << b;
      cnt = __ldg(counts_i + k);
    }
    const bool keep = f != 0u && cnt > 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    int base = 0;
    if (lane == 0 && ballot != 0u) base = atomicAdd(&n_act, __popc(ballot));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (keep) {
      const int slot = base + __popc(ballot & ((1u << lane) - 1u));
      act_k[slot] = k;
      act_f[slot] = f;
      act_cnt[slot] = cnt;
    }
    __syncthreads();
    // -- walk: a warp takes kGroup kept lists at a time and lays their used
    // prefixes end to end, so its lanes keep 32 * kUnroll loads in flight
    // however short the lists are
    const int na = n_act;
    for (int a0 = warp * kGroup; a0 < na; a0 += kWarps * kGroup) {
      int k_l = 0, cnt_l = 0;
      uint32_t f_l = 0u;
      bool scan_l = false;
      if (lane < kGroup && a0 + lane < na) {
        k_l = act_k[a0 + lane];
        f_l = act_f[a0 + lane];
        const int ca = act_cnt[a0 + lane];
        scan_l = ca > cap;
        cnt_l = scan_l ? 0 : ca;
      }
      int end = cnt_l;  // inclusive prefix over lanes 0..kGroup-1
#pragma unroll
      for (int d = 1; d < kGroup; d <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, end, d);
        if (lane >= d) end += t;
      }
      const int start = end - cnt_l;
      int ends[kGroup];
#pragma unroll
      for (int v = 0; v < kGroup; ++v) ends[v] = __shfl_sync(0xffffffffu, end, v);
      const int total = ends[kGroup - 1];
      unsigned holes = 0u;  // bit v: list v of the group has a hole
      for (int e0 = 0; e0 < total; e0 += 32 * kUnroll) {
        int id[kUnroll], g[kUnroll];
        uint32_t fu[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int e = e0 + u * 32 + lane;
          int h = 0;
#pragma unroll
          for (int v = 0; v < kGroup - 1; ++v) h += e >= ends[v];
          g[u] = h;
          const int s = e - __shfl_sync(0xffffffffu, start, h);
          const int kk = __shfl_sync(0xffffffffu, k_l, h);
          fu[u] = __shfl_sync(0xffffffffu, f_l, h);
          id[u] = e < total
                      ? __ldg(lists + (static_cast<size_t>(i) * L + kk) * cap + s)
                      : 0;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (e0 + u * 32 + lane < total) {
            const int j = id[u];
            if (j < 0 || j >= n) {
              holes |= 1u << g[u];
            } else {
              const unsigned d = static_cast<unsigned>(j - w0);
              if (d < static_cast<unsigned>(wn)) mark(&fmask[d], fu[u]);
            }
          }
        }
      }
      // lists the walk cannot trust: every member from pos's column
      unsigned scan = __reduce_or_sync(0xffffffffu, holes) |
                      __ballot_sync(0xffffffffu, scan_l);
      while (scan != 0u) {  // uniform across the warp
        const int v = __ffs(scan) - 1;
        scan &= scan - 1u;
        const int kk = __shfl_sync(0xffffffffu, k_l, v);
        const uint32_t fv = __shfl_sync(0xffffffffu, f_l, v);
        const int32_t* col = pos + (static_cast<size_t>(i) * n + w0) * L + kk;
        for (int d = lane; d < wn; d += 32)
          if (__ldg(col + static_cast<size_t>(d) * L) != -1) mark(&fmask[d], fv);
      }
    }
    __syncthreads();  // the staged lists are consumed before the next pass
  }

  // -- combine across the cluster, then vote
  cluster.sync();
  const int per = (wn + K - 1) / K;
  const int lo = r * per;
  const int hi = min(wn, lo + per);
  for (int d = lo + static_cast<int>(threadIdx.x); d < hi; d += kThreads) {
    uint32_t v = 0u;
    for (int q = 0; q < K; ++q) v |= *cluster.map_shared_rank(&fmask[d], q);
    fmask[d] = v;  // this block's own slice: no other block reads it
  }
  __syncthreads();
  int v = 0;
  for (int d = lo + warp; d < hi; d += kWarps)
    if ((fmask[d] >> lane) & 1u) v -= __ldg(pol + w0 + d);
  if (v != 0) atomicAdd(&votes_s[lane], v);
  cluster.sync();  // every block's votes are in; no bitmask is read again
  if (r == 0 && static_cast<int>(threadIdx.x) < nb) {
    int total = 0;
    for (int q = 0; q < K; ++q)
      total += *cluster.map_shared_rank(&votes_s[threadIdx.x], q);
    int32_t* o = out + static_cast<size_t>(b0 + threadIdx.x) * m + i;
    if (n_windows == 1) {
      *o = total;  // the only writer of this cell
    } else if (total != 0) {
      atomicAdd(o, total);
    }
  }
  cluster.sync();  // block 0 has read every block's votes
}

}  // namespace

// out: (B, m) int32, zero-filled when n > window. window: clause ids per
// bitmask (its shared bytes are 4 * window); cluster: blocks per cluster
// (1..16).
// Launches over batch slices so that the grid's z stays within its limit.
// Returns cudaGetLastError() after the launches.
extern "C" int indexed_votes_launch(const void* lists, const void* counts,
                                    const void* pos, const void* lit,
                                    const void* pol, void* out, int m, int n,
                                    int L, int B, int cap, int window,
                                    int cluster, void* stream) {
  // per device, the attributes only ever grow: set them when a launch needs
  // more (once, so that a launch under stream capture sets nothing)
  static int smem_set[kMaxDevices] = {};
  static bool wide_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  const int n_windows = (n + window - 1) / window;
  const size_t smem = static_cast<size_t>(window) * sizeof(uint32_t);
  if (static_cast<int>(smem) > smem_set[dev]) {
    err = cudaFuncSetAttribute(indexed_walk_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[dev] = static_cast<int>(smem);
  }
  if (cluster > 8 && !wide_set[dev]) {
    err = cudaFuncSetAttribute(indexed_walk_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    wide_set[dev] = true;
  }
  const int words = (B + 31) / 32;
  const int words_per_launch = kMaxGridZ / n_windows;
  if (words_per_launch < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  for (int c0 = 0; c0 < words; c0 += words_per_launch) {
    const int wc = min(words_per_launch, words - c0);
    const int b_start = c0 * 32;
    const int b_len = min(B - b_start, wc * 32);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster, m, wc * n_windows);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(
        &cfg, indexed_walk_kernel, static_cast<const int32_t*>(lists),
        static_cast<const int32_t*>(counts), static_cast<const int32_t*>(pos),
        static_cast<const uint8_t*>(lit) + static_cast<size_t>(b_start) * L,
        static_cast<const int32_t*>(pol),
        static_cast<int32_t*>(out) + static_cast<size_t>(b_start) * m, m, n, L,
        b_len, cap, window, n_windows);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* indexed_votes_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
