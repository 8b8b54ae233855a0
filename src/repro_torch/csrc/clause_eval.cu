// Bit-packed clause evaluation for Hopper (sm_90a): one core, two epilogues.
//
//   falsified(b, i, j) = any_w( inc[i, j, w] & ~lit[b, w] ) != 0
//   outputs(b, i, j)   = !falsified(b, i, j)            (an empty clause is true)
//   votes(b, i)        = sum_j outputs(b, i, j) * pol[j]
//
// Replaces the TPU kernels of src/repro/kernels/clause_eval.py:
//   * clause_votes_launch   -> _votes_kernel   (:45, pallas_call at :101)
//   * clause_outputs_launch -> _outputs_kernel (:121, pallas_call at :147)
// A third entry, round_vote_launch (at the end of this file), reads a class
// row's TA states instead of packed include words: the learning round's vote
// half in one launch (its own note below).
//
// Operands: inc (m, n, W) packed include words, lit (B, W) packed literal
// words (32-bit words, bit-identical to the reference's uint32), pol (n,)
// int32 in {-1, 0, +1} (0 marks padding rows, which vote nothing). Include
// bits beyond 2o are 0; literal bits beyond 2o may be anything. Outputs:
// votes (B, m) int32, zeroed by the caller; or outputs (B, m, n) int8, every
// element written.
//
// What bounds it on an H100: the test is a boolean product with an OR
// reduction, one LOP3 (v |= inc & ~lit) per include word per sample:
// B*m*n*W of them, 31.4 M at the MNIST width and B = 32, 1.87 us at 64 logic
// results per clock per SM. The include words are read once (3.9 MB,
// 1.2 us at 3.35 TB/s), so the logic rate is the bound. At B = 1 and 2 an
// include word serves one or two samples: the work is a read of the include
// words and a launch's latency is the floor.
//
// Design. The launch plan is chosen in Python (kernels/clause_eval.py
// launch_plan) and passed in; tests/test_torch_kernels.py mirrors the index
// math below on the CPU. Two routes share the core, v |= inc & ~lit over a
// row's words with the violation words in registers, and the epilogues.
//
// Tiled route (B >= 3; the register-tiled boolean product):
//   * A block takes a tile of ct clause rows of one class and bt = 8*SG
//     samples. Each warp serves one sample group of 8 samples (sg = warp mod
//     SG) and 32 clauses, one per lane; a thread keeps a 1 x 8 tile of
//     violation words in registers: clause cg (its lane in the warp's 32),
//     samples sg*8 + s. Per word it loads one include word and 8 literal
//     words from shared memory and does 8 LOP3s. The literal words are two
//     16-byte loads that every lane of the warp shares (a broadcast, one
//     wavefront), and the 32 lanes read 32 rows of one word, in distinct
//     banks when the row stride is odd (it is W mod 4, so odd for odd W, as
//     at the MNIST width). The loop then runs at the logic rate, not at the
//     rate of shuffles or shared-memory wavefronts. (Thread tiles of 2 or 4
//     clauses, and of 1 sample, ran no faster at the main path's shapes and
//     were dropped; see PERF.md.)
//   * cp.async staging, double-buffered. Each tile's include rows are copied
//     into shared memory with cp.async: 16-byte copies for the aligned body,
//     4-byte copies for the ragged head and tail (a row is 4*W bytes, 196 at
//     the MNIST width, so rows do not all start on a 16-byte line). When one
//     chunk holds a row and the stride is W, the tile is one contiguous range
//     in both memories and the whole block copies it at once; otherwise a
//     warp copies each row. The tile starts at its source's offset in its
//     16-byte line and the stride is W mod 4, so every 16-byte copy is
//     aligned at both ends. Blocks are persistent over clause tiles (grid =
//     one wave of resident blocks, blockIdx.y = sample tile); the next
//     stage's copy is issued before this stage's LOP3s and lands in the other
//     buffer. Nothing is padded or copied on the host.
//   * Word chunks. A row is staged wc words at a time, so any W fits in
//     shared memory; the violation words stay in registers across chunks.
//     When one chunk holds the row (W <= wc), the block's literal words are
//     staged once, transposed to [word][sample] (a warp reads one sample's
//     row, coalesced); otherwise with each chunk. No index takes an integer
//     division per element.
// Direct route (B <= 2): an include word serves at most two samples, so
//   staging it in shared memory buys no reuse and costs a round trip
//   (scripts/sweep_clause_eval.py times both routes at B = 1). Instead KS lanes
//   share a clause row (KS = 16 at W = 49, so a lane has 3-4 words), load
//   its words and the matching literal words straight into registers in
//   coalesced 64-byte runs; one warp ballot per sample then tells each lane
//   group whether any of its lanes saw a violation. Every lane works; one
//   global round trip feeds the whole row.
// Both routes read every word: there is no early exit once a cell is
// falsified, so the time does not depend on the data (bitpack is the
// exhaustive baseline of the paper's indexed engine).
// Epilogues. Outputs: each cell's int8 is written once, 32 consecutive
// clauses of one sample per warp store. Votes: each thread sums pol[j] over
// its true clauses per sample, warp shuffles reduce over the clause lanes,
// shared atomics over the warps, and one int32 atomicAdd per (sample, class)
// per block tile lands in global memory: integer addition, exact in any
// order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kSamples = 8;  // tiled route: samples per thread
constexpr int kGroup = 4;  // direct route: words a lane loads before its LOP3s

// What kernels/clause_eval.py::launch_plan decided, per launch.
struct Geometry {
  int m, n, W, B;
  int groups_log2;  // tiled: sample groups per block; direct: lanes per clause
  int wc;        // words of a row per staged chunk
  int stride;    // shared words per staged row: >= wc, = W mod 4
  int n_ctiles;  // clause tiles per class
  int n_chunks;  // chunks per row
};

// One stage of the tiled route: one word chunk of one clause tile.
struct Stage {
  int i, j0, rows;       // class, first clause, rows present (<= ct)
  int w0, wn;            // first word, words
  int shift;             // word offset of src in its 16-byte line
  const uint32_t* src;   // inc[i, j0, w0]
  bool last;             // last chunk of its tile
};

__device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

__device__ __forceinline__ int quad_phase(const uint32_t* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t* dst, const uint32_t* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(shared_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(shared_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// All groups but the one committed last have landed (this thread's copies).
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Copy words [0, count) from src to dst (same offset in their 16-byte
// lines): 4-byte head and tail, 16-byte body; `part` of `parts` copiers.
__device__ __forceinline__ void copy_run(uint32_t* dst, const uint32_t* src, int count,
                                         int part, int parts) {
  const int head = min((4 - quad_phase(src)) & 3, count);
  const int quads = (count - head) >> 2;
  const int tail = head + 4 * quads;
  for (int q = part; q < quads; q += parts) cp_async16(dst + head + 4 * q, src + head + 4 * q);
  if (part < head) cp_async4(dst + part, src + part);
  if (part < count - tail) cp_async4(dst + tail + part, src + tail + part);
}

// Stage st of this block: its k-th tile (blockIdx.x + k*gridDim.x), chunk c.
__device__ __forceinline__ Stage stage_at(const Geometry& g, const uint32_t* inc,
                                          int st, int ct) {
  const int k = st / g.n_chunks;
  const int c = st - k * g.n_chunks;
  const int tile = blockIdx.x + k * gridDim.x;
  Stage s;
  s.i = tile / g.n_ctiles;
  s.j0 = (tile - s.i * g.n_ctiles) * ct;
  s.rows = min(ct, g.n - s.j0);
  s.w0 = c * g.wc;
  s.wn = min(g.wc, g.W - s.w0);
  s.src = inc + (static_cast<size_t>(s.i) * g.n + s.j0) * g.W + s.w0;
  s.shift = quad_phase(s.src);
  s.last = c == g.n_chunks - 1;
  return s;
}

// Votes of one block tile: each lane's per-sample sums over its clauses,
// reduced over the warp, then over the block in `votes_s` (zeroed, one slot
// per sample of the tile), then one atomicAdd per sample into out[b0 + t, i].
template <int NS>
__device__ __forceinline__ void add_votes(int (&vote)[NS], int* votes_s, int slot0,
                                          int32_t* out, const Geometry& g, int b0,
                                          int samples, int i) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1)
#pragma unroll
    for (int x = 0; x < NS; ++x) vote[x] += __shfl_xor_sync(0xffffffffu, vote[x], off);
  if (lane == 0)
#pragma unroll
    for (int x = 0; x < NS; ++x)
      if (vote[x] != 0) atomicAdd(&votes_s[slot0 + x], vote[x]);
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < samples) {
    const int total = votes_s[threadIdx.x];
    votes_s[threadIdx.x] = 0;
    if (total != 0 && b0 + static_cast<int>(threadIdx.x) < g.B)
      atomicAdd(out + static_cast<size_t>(b0 + threadIdx.x) * g.m + i, total);
  }
}

// Tiled route. Shared memory, in 32-bit words: two include buffers of
// round4(ct*stride + 3) (rows start at offset shift + r*stride), the literal
// words (one buffer of round4(wc*(bt + 4)) when one chunk holds a row, else
// two), then bt vote slots.
template <bool VOTES>
__global__ void __launch_bounds__(kMaxThreads)
clause_eval_kernel(const uint32_t* __restrict__ inc, const uint32_t* __restrict__ lit,
                   const int32_t* __restrict__ pol, void* __restrict__ out, Geometry g) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int sg = warp & ((1 << g.groups_log2) - 1);
  const int cg = ((warp >> g.groups_log2) << 5) + lane;
  const int ct = blockDim.x >> g.groups_log2;
  const int bt = kSamples << g.groups_log2;
  const int b0 = blockIdx.y * bt;
  const bool resident = g.n_chunks == 1;
  const bool flat = resident && g.stride == g.W;  // tiles contiguous in both
  const int ls = bt + 4;  // shared words per staged literal word (16-byte rows)
  const int inc_words = round4(ct * g.stride + 3);
  const int lit_words = round4(g.wc * ls);
  uint32_t* inc_s = smem;
  uint32_t* lit_s = smem + 2 * inc_words;
  int* votes_s = reinterpret_cast<int*>(lit_s + (resident ? 1 : 2) * lit_words);

  const int tiles = g.m * g.n_ctiles;
  const int n_blocks = static_cast<int>(gridDim.x);
  const int stages =
      (tiles - static_cast<int>(blockIdx.x) + n_blocks - 1) / n_blocks * g.n_chunks;

  // literal words [w0, w0 + wn) of the block's samples, transposed to
  // [word][sample] (ls words apart: a warp's writes of one sample's 32 words
  // fall in 8 banks); a warp per sample, so each reads a contiguous row.
  // Absent samples are not copied (their cells are never stored).
  auto stage_lit = [&](uint32_t* dst, int w0, int wn) {
    for (int b = warp; b < bt && b0 + b < g.B; b += n_warps) {
      const uint32_t* src = lit + static_cast<size_t>(b0 + b) * g.W + w0;
      for (int w = lane; w < wn; w += 32) cp_async4(dst + w * ls + b, src + w);
    }
  };
  auto stage_inc = [&](uint32_t* buf, const Stage& s) {
    if (flat) {  // one run for the whole block
      copy_run(buf + s.shift, s.src, s.rows * g.W, tid, blockDim.x);
      return;
    }
    for (int r = warp; r < s.rows; r += n_warps)  // a warp per row
      copy_run(buf + s.shift + r * g.stride, s.src + static_cast<size_t>(r) * g.W, s.wn,
               lane, 32);
  };
  auto issue = [&](int st) {
    const Stage s = stage_at(g, inc, st, ct);
    stage_inc(inc_s + (st & 1) * inc_words, s);
    if (!resident) stage_lit(lit_s + (st & 1) * lit_words, s.w0, s.wn);
  };

  if (VOTES && tid < bt) votes_s[tid] = 0;
  if (resident) stage_lit(lit_s, 0, g.W);
  if (stages > 0) issue(0);
  cp_async_commit();

  uint32_t v[kSamples];
#pragma unroll
  for (int x = 0; x < kSamples; ++x) v[x] = 0u;

  for (int st = 0; st < stages; ++st) {
    if (st + 1 < stages) issue(st + 1);
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();

    const Stage s = stage_at(g, inc, st, ct);
    const uint32_t* lp = lit_s + (resident ? 0 : (st & 1) * lit_words) + sg * kSamples;
    const uint32_t* rp = inc_s + (st & 1) * inc_words + s.shift + cg * g.stride;
#pragma unroll 4
    for (int w = 0; w < s.wn; ++w) {
      const uint32_t a = rp[w];
      const uint4 lo = *reinterpret_cast<const uint4*>(lp + w * ls);
      const uint4 hi = *reinterpret_cast<const uint4*>(lp + w * ls + 4);
      const uint32_t l[kSamples] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int x = 0; x < kSamples; ++x) v[x] |= a & ~l[x];
    }

    if (s.last) {  // uniform across the block
      const int j = s.j0 + cg;
      if constexpr (VOTES) {
        int vote[kSamples];
        const int p = j < g.n ? __ldg(pol + j) : 0;
#pragma unroll
        for (int x = 0; x < kSamples; ++x) vote[x] = v[x] == 0u ? p : 0;
        add_votes<kSamples>(vote, votes_s, sg * kSamples, static_cast<int32_t*>(out), g,
                            b0, bt, s.i);
      } else if (j < g.n) {
        int8_t* o = static_cast<int8_t*>(out);
#pragma unroll
        for (int x = 0; x < kSamples; ++x) {
          const int b = b0 + sg * kSamples + x;
          if (b < g.B) o[(static_cast<size_t>(b) * g.m + s.i) * g.n + j] = v[x] == 0u;
        }
      }
#pragma unroll
      for (int x = 0; x < kSamples; ++x) v[x] = 0u;
    }
    __syncthreads();  // this buffer is refilled by the next iteration's issue
  }
}

// Direct route, B = NB (1 or 2): block (x, i) takes clauses
// x*(threads/KS) + t/KS of class i; lane group of KS lanes per clause.
template <int NB, bool VOTES>
__global__ void __launch_bounds__(kMaxThreads)
clause_eval_direct_kernel(const uint32_t* __restrict__ inc,
                          const uint32_t* __restrict__ lit,
                          const int32_t* __restrict__ pol, void* __restrict__ out,
                          Geometry g) {
  __shared__ int votes_s[NB];
  const int tid = threadIdx.x;
  const int ks_log2 = g.groups_log2;
  const int kp = tid & ((1 << ks_log2) - 1);
  const int i = blockIdx.y;
  const int j = blockIdx.x * (blockDim.x >> ks_log2) + (tid >> ks_log2);
  if (VOTES && tid < NB) votes_s[tid] = 0;
  uint32_t v[NB];
#pragma unroll
  for (int x = 0; x < NB; ++x) v[x] = 0u;
  if (j < g.n) {
    const uint32_t* row = inc + (static_cast<size_t>(i) * g.n + j) * g.W;
    // kGroup words per lane at a time, all loads issued before any LOP3
    for (int w0 = kp; w0 < g.W; w0 += kGroup << ks_log2) {
      uint32_t a[kGroup], l[kGroup][NB];
#pragma unroll
      for (int t = 0; t < kGroup; ++t) {
        const int w = w0 + (t << ks_log2);
        const bool in = w < g.W;
        a[t] = in ? __ldg(row + w) : 0u;
#pragma unroll
        for (int x = 0; x < NB; ++x) l[t][x] = in ? __ldg(lit + x * g.W + w) : 0u;
      }
#pragma unroll
      for (int t = 0; t < kGroup; ++t)
#pragma unroll
        for (int x = 0; x < NB; ++x) v[x] |= a[t] & ~l[t][x];
    }
  }
  // one warp vote per sample: the clause's lane group as bits of the ballot
  const int ks = 1 << ks_log2;
  const unsigned group = ks == 32 ? 0xffffffffu : (1u << ks) - 1u;
  const int first = (tid & 31) & ~(ks - 1);
  bool falsified[NB];
#pragma unroll
  for (int x = 0; x < NB; ++x)
    falsified[x] = (__ballot_sync(0xffffffffu, v[x] != 0u) >> first) & group;
  const bool mine = kp == 0 && j < g.n;  // one lane stores the clause's cells
  if constexpr (VOTES) {
    int vote[NB];
    const int p = mine ? __ldg(pol + j) : 0;
#pragma unroll
    for (int x = 0; x < NB; ++x) vote[x] = falsified[x] ? 0 : p;
    __syncthreads();  // votes_s is zeroed
    add_votes<NB>(vote, votes_s, 0, static_cast<int32_t*>(out), g, 0, NB, i);
  } else if (mine) {
#pragma unroll
    for (int x = 0; x < NB; ++x)
      static_cast<int8_t*>(out)[(static_cast<size_t>(x) * g.m + i) * g.n + j] = !falsified[x];
  }
}

template <typename Kernel>
int launch_kernel(Kernel kernel, const void* inc, const void* lit, const void* pol,
                  void* out, const Geometry& g, int threads, int grid_x, int grid_y,
                  int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<dim3(grid_x, grid_y), threads, smem, stream>>>(
      static_cast<const uint32_t*>(inc), static_cast<const uint32_t*>(lit),
      static_cast<const int32_t*>(pol), out, g);
  return static_cast<int>(cudaGetLastError());
}

template <bool VOTES>
int launch(const void* inc, const void* lit, const void* pol, void* out, int m, int n,
           int W, int B, int direct, int groups_log2, int threads, int wc, int stride,
           int n_ctiles, int n_chunks, int grid_x, int grid_y, int smem, void* stream) {
  const Geometry g{m, n, W, B, groups_log2, wc, stride, n_ctiles, n_chunks};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto bad = static_cast<int>(cudaErrorInvalidValue);
  if (threads < 32 || threads % 32 != 0 || threads > kMaxThreads || grid_x < 1 ||
      grid_y < 1 || groups_log2 < 0)
    return bad;
  if (direct) {  // the plan's invariants the direct route relies on
    if (groups_log2 > 5 || grid_y != m ||
        static_cast<long long>(grid_x) * (threads >> groups_log2) < n)
      return bad;
    if (B == 1)
      return launch_kernel(clause_eval_direct_kernel<1, VOTES>, inc, lit, pol, out, g,
                           threads, grid_x, grid_y, 0, s);
    if (B == 2)
      return launch_kernel(clause_eval_direct_kernel<2, VOTES>, inc, lit, pol, out, g,
                           threads, grid_x, grid_y, 0, s);
    return bad;
  }
  // ... and the tiled route's
  if (groups_log2 > 2 || (threads >> 5) % (1 << groups_log2) != 0 || wc < 1 ||
      stride < wc || (stride - W) % 4 != 0 || n_chunks < 1 || grid_x > m * n_ctiles)
    return bad;
  return launch_kernel(clause_eval_kernel<VOTES>, inc, lit, pol, out, g, threads, grid_x,
                       grid_y, smem, s);
}

// ---------------------------------------------------------------------------
// round_vote: one learning round's clause outputs and partial vote, straight
// from the class row's int16 TA states.
//
//   falsified(j) = exists k < L: ta[j, k] > N and literal k is false
//   out[j]       = !falsified(j)                  (an empty clause is true)
//   vote         = sum_j out[j] * pol[j]          (int32)
//
// Operands: ta (n, L) int16 row-major (L = 2o), lit the sample's packed
// literal words read as bytes (byte k/8 holds literals k..k+7, little-endian
// words), pol (n,) int32 in {-1, 0, +1} (0 on padding rows). Outputs: out (n,)
// int8, every element written; vote, one int32, zeroed by the launcher.
//
// Replaces no TPU kernel: the reference's round packs the row's include mask
// and calls _outputs_kernel (clause_outputs_launch above), then sums the
// vote; here the pack, the test and the sum are one pass, and the include
// words never reach device memory.
//
// What bounds it on an H100: a stream over the row's n*L states (6.27 MB at
// the MNIST width, 40 MB at the IMDb width: 1.9 us and 11.9 us at 3.35 TB/s)
// if every clause is read to its end. A clause is read only until a
// falsifier turns up, so a trained row, whose clauses a sample mostly
// falsifies within their first few hundred literals, costs less: the true
// clauses are read whole and set the time, one dependent load round trip per
// kRoundUnroll loads a lane.
//
// Design. KS lanes (a power of two, chosen from L in
// kernels/clause_eval.py::round_vote_plan: enough that kRoundUnroll loads a
// lane cover a short row, else 32) share a clause; a warp holds 32/KS
// clauses, a block blockDim/KS. A unit is 8 states in one 16-byte load (8
// aligned literals share one byte of a literal word) when L % 8 == 0 and the
// row is 16-byte aligned, else one state in a 2-byte load (the scalar route).
// Each lane issues its kRoundUnroll loads of states and literal bytes before
// it tests them (`state > N` for 8 states by two-halfword SIMD compares, AND
// the literal's false bit); then a warp ballot marks the clauses with a
// falsifier, and the warp leaves the row once each of its clauses has one.
// Epilogue: one lane per clause stores its int8 and its polarity if true;
// the votes are summed over the warp (__reduce_add_sync), over the block in
// shared memory, and one int32 atomicAdd per block lands in `vote`: integer
// addition, exact in any order.
constexpr int kRoundUnroll = 8;

// Bit i set iff state i of the 8 int16 states in s is above N (nn: N in both
// halves of a word).
__device__ __forceinline__ unsigned included_byte(const uint4& s, unsigned nn) {
  const unsigned w[4] = {s.x, s.y, s.z, s.w};
  unsigned bits = 0u;
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const unsigned c = __vcmpgts2(w[h], nn);  // 0xffff in each half above N
    bits |= ((c & 1u) | ((c >> 15) & 2u)) << (2 * h);
  }
  return bits;
}

template <bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
round_vote_kernel(const int16_t* __restrict__ ta, const uint8_t* __restrict__ lit,
                  const int32_t* __restrict__ pol, int8_t* __restrict__ out,
                  int32_t* __restrict__ vote, int n, int L, int n_states, int ks_log2) {
  __shared__ int warp_votes[kMaxThreads / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int ks = 1 << ks_log2;
  const int kp = lane & (ks - 1);
  const int j = blockIdx.x * (blockDim.x >> ks_log2) + (tid >> ks_log2);
  const bool live = j < n;
  const unsigned group = (ks == 32 ? 0xffffffffu : (1u << ks) - 1u) << (lane & ~(ks - 1));
  const int units = VEC ? L >> 3 : L;
  const int16_t* row = ta + static_cast<size_t>(live ? j : 0) * L;
  const unsigned nn = (static_cast<unsigned>(n_states) & 0xffffu) * 0x10001u;

  bool done = !live;  // uniform over the clause's lanes: falsified, or no clause
  for (int u0 = 0; u0 < units; u0 += ks * kRoundUnroll) {
    unsigned hit = 0u;
    if (!done) {
      if constexpr (VEC) {
        const uint4* rv = reinterpret_cast<const uint4*>(row);
        uint4 s[kRoundUnroll];
        unsigned lb[kRoundUnroll];
#pragma unroll
        for (int t = 0; t < kRoundUnroll; ++t) {  // every load before any test
          const int u = u0 + t * ks + kp;
          const bool in = u < units;
          s[t] = in ? __ldg(rv + u) : make_uint4(0u, 0u, 0u, 0u);
          lb[t] = in ? __ldg(lit + u) : 0xffu;
        }
#pragma unroll
        for (int t = 0; t < kRoundUnroll; ++t) hit |= included_byte(s[t], nn) & ~lb[t];
      } else {
        int s[kRoundUnroll];
        unsigned lb[kRoundUnroll];
#pragma unroll
        for (int t = 0; t < kRoundUnroll; ++t) {
          const int k = u0 + t * ks + kp;
          const bool in = k < L;
          s[t] = in ? __ldg(row + k) : 0;
          lb[t] = in ? __ldg(lit + (k >> 3)) >> (k & 7) : 1u;
        }
#pragma unroll
        for (int t = 0; t < kRoundUnroll; ++t) hit |= (s[t] > n_states) & ~lb[t] & 1u;
      }
    }
    // every lane votes, done or not: a lane that skipped the ballot (as a
    // short-circuited `done || ...` would) leaves the others waiting for it
    const unsigned hits = __ballot_sync(0xffffffffu, hit != 0u);
    done = done || (hits & group) != 0u;
    if (__all_sync(0xffffffffu, done)) break;
  }

  int p = 0;
  if (live && kp == 0) {
    out[j] = done ? 0 : 1;
    p = done ? 0 : __ldg(pol + j);
  }
  p = __reduce_add_sync(0xffffffffu, p);
  if (lane == 0) warp_votes[tid >> 5] = p;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) total += warp_votes[w];
    if (total != 0) atomicAdd(vote, total);
  }
}

int round_vote(const void* ta, const void* lit, const void* pol, void* out, void* vote,
               int n, int L, int n_states, int vec, int ks_log2, int threads, int grid,
               void* stream) {
  const auto bad = static_cast<int>(cudaErrorInvalidValue);
  if (n < 1 || L < 0 || threads < 32 || threads % 32 != 0 || threads > kMaxThreads ||
      ks_log2 < 0 || ks_log2 > 5 ||
      static_cast<long long>(grid) * (threads >> ks_log2) < n ||
      (vec && (L % 8 != 0 || reinterpret_cast<uintptr_t>(ta) % 16 != 0)))
    return bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(vote, 0, sizeof(int32_t), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  auto kernel = vec ? &round_vote_kernel<true> : &round_vote_kernel<false>;
  kernel<<<grid, threads, 0, s>>>(static_cast<const int16_t*>(ta),
                                  static_cast<const uint8_t*>(lit),
                                  static_cast<const int32_t*>(pol), static_cast<int8_t*>(out),
                                  static_cast<int32_t*>(vote), n, L, n_states, ks_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// votes: (B, m) int32, zero-filled. Returns cudaGetLastError() after launch.
extern "C" int clause_votes_launch(const void* inc, const void* lit, const void* pol,
                                   void* out, int m, int n, int W, int B, int direct,
                                   int groups_log2, int threads, int wc, int stride,
                                   int n_ctiles, int n_chunks, int grid_x, int grid_y,
                                   int smem, void* stream) {
  return launch<true>(inc, lit, pol, out, m, n, W, B, direct, groups_log2, threads, wc,
                      stride, n_ctiles, n_chunks, grid_x, grid_y, smem, stream);
}

// outputs: (B, m, n) int8, every element written.
extern "C" int clause_outputs_launch(const void* inc, const void* lit, void* out, int m,
                                     int n, int W, int B, int direct, int groups_log2,
                                     int threads, int wc, int stride, int n_ctiles,
                                     int n_chunks, int grid_x, int grid_y, int smem,
                                     void* stream) {
  return launch<false>(inc, lit, nullptr, out, m, n, W, B, direct, groups_log2, threads,
                       wc, stride, n_ctiles, n_chunks, grid_x, grid_y, smem, stream);
}

// round_vote: out (n,) int8, every element written; vote one int32, zeroed
// here (cudaMemsetAsync on the stream) before the kernel adds into it.
extern "C" int round_vote_launch(const void* ta, const void* lit, const void* pol, void* out,
                                 void* vote, int n, int L, int n_states, int vec, int ks_log2,
                                 int threads, int grid, void* stream) {
  return round_vote(ta, lit, pol, out, vote, n, L, n_states, vec, ks_log2, threads, grid,
                    stream);
}

extern "C" const char* clause_eval_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
