// Causal attention core of multi-head latent attention (MLA), forward and
// backward, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no MLA. It replaces the dense
// core of the port's own repro_torch.models.attention._sdpa on the training
// and prefill path of an MLAConfig (mla_attend), which wrote the (H, S, S)
// scores of every sequence to device memory several times over: bf16, then
// float32, forward, in the recompute of the backward pass, and in the
// backward. Here the scores and the probabilities stay in registers and
// shared memory; the forward keeps one float per (b, h, row) for the
// backward.
//
// The function. For one batch row b and head h, with q (S, 192), k (S, 192),
// v (S, 128) and one position array pos (S,) shared by queries and keys:
//
//   t[r, c] = scale * <q[r], k[c]>           if 0 <= pos[c] <= pos[r]
//           = NEG_INF (-2**30)               otherwise (masked)
//   out[r]  = sum_c softmax_c(t[r]) v[c]
//
// exactly the mask and the masked value of _mask(pos, pos, "causal", None)
// and _sdpa: a row with no allowed key (pos[r] < 0) has every score at
// NEG_INF and attends uniformly to all S keys, as _sdpa's does. Scores are
// kept in base-2 units (t * log2 e) so that every exponential is one exp2f.
//
// Forward (FlashAttention-2's schedule): block = (128 query rows, h, b),
// 8 warps of 16 rows. The block walks the key tiles of 64 keys with an
// online softmax in float32 registers (running max and denominator), S =
// QK^T accumulated in float32 by mma.sync m16n8k16 (bf16 operands), P cast
// to bf16 for the PV product (as _sdpa casts its weights), the output
// accumulated in float32 and written in bf16. It writes lse[b, h, r] =
// max + log2(denominator) (base 2, scaled units), or NEG_INF for a row with
// no allowed key, for the backward.
//
// Backward: a small kernel computes D[b, h, r] = sum_d dO[r, d] O[r, d]
// (float32); the main kernel takes one key tile of 64 keys per block and
// walks the query tiles of 64 rows that can see it. It recomputes P from Q,
// K and lse, forms dP = dO V^T, dS = P * (dP - D) * scale in float32 and
// casts P and dS to bf16 for the three products that use them: dV += P^T dO
// and dK += dS^T Q accumulate in registers over the walk, dQ += dS K goes to
// a float32 buffer by atomicAdd (zeroed here, cast to bf16 by the caller).
// That is the precision of autograd through _sdpa: its softmax backward is
// float32 and its products bf16. A masked pair has zero gradient in dS (the
// torch.where of _sdpa passes none); in a row with no allowed key every P is
// 1/S, so dV still receives it.
//
// Skipping, exact for any positions: the kernels read per-granule (64
// positions) minima and maxima of pos (mla_stats_kernel). A (query tile, key
// tile) pair is skipped when every row of the query tile has a position >= 0
// and the key tile's smallest position exceeds the query tile's largest:
// every pair is masked and every row has an allowed key elsewhere, so its
// weights there are exp2(NEG_INF - max) = 0. A query tile holding a row at a
// negative position skips nothing (that row attends to every key). A pair
// whose keys are all in range with 0 <= pos[c] <= min pos[r] takes no mask at
// all. For positions 0..S-1 this halves the work and masks only the diagonal
// tiles. The forward gives its blocks the longest query tiles first and the
// backward the smallest key tiles first (the longest walks), so the short
// ones fill the last wave.
//
// What bounds it on an H100: tensor-core operations. Causal pairs at the
// training shape (B = 2, S = 4,096, H = 16): 2 * 16 * 8.4 M = 268.5 M; the
// forward does 2 * (192 + 128) FLOPs a pair (172 GFLOP, 0.174 ms at 989.4
// TFLOP/s dense bf16), the backward 2 * (192 + 128 + 128 + 192 + 192) (447
// GFLOP, 0.451 ms). Its bytes (q, k, v, dO, O once each, 10-50 MB) are
// under 0.02 ms at 3.35 TB/s. The design keeps the tensor cores fed the
// FlashAttention-2 way: tiles staged in shared memory by cp.async (double
// buffered, 16-byte copies, zero-filled past S), operands read by ldmatrix
// from rows padded by 16 bytes (400 and 272 B pitches: conflict-free), the
// softmax and the masks in registers between the two products; one block of
// 8 warps per SM (137 KB / 148 KB of shared memory, ~255 registers a
// thread). The backward pays besides for dQ: a third product and 192 float
// atomics (as float2) per query row per key tile, to L2. Hopper's own paths
// to the peak (wgmma, TMA, a bulk reduction of dQ tiles) are the next steps.
//
// Layout: q, k (B, S, H, 192), v and dO (B, S, H, 128), each with any
// element strides over b, s, h that are multiples of 8 (16-byte rows) and a
// unit last stride; O (B, S, H, 128) and the gradients contiguous; pos (B,
// S) int32 contiguous. One head-dim pair is compiled: 192 and 128.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kDqk = 192;        // qk_nope 128 + qk_rope 64
constexpr int kDv = 128;
constexpr int kLdQk = kDqk + 8;  // shared row pitch in elements: 400 B
constexpr int kLdV = kDv + 8;    // 272 B
constexpr int kGran = 64;        // positions per granule of the stats
constexpr int kThreads = 256;    // 8 warps
constexpr float kNegInf = -1073741824.0f;  // -2**30, the model's NEG_INF
constexpr int kMaxDevices = 64;

constexpr int kFq = 128;         // forward: query rows a block, 16 a warp
constexpr int kFk = 64;          // forward: keys a step
constexpr int kBq = 64;          // backward: query rows a step
constexpr int kBk = 64;          // backward: keys a block
constexpr int kLdP = kBk + 8;    // 144 B

constexpr int kFwdSmem = (kFq * kLdQk + 2 * kFk * kLdQk + 2 * kFk * kLdV) * 2;
constexpr int kBwdSmem =
    (kBk * kLdQk + kBk * kLdV + 2 * kBq * kLdQk + 2 * kBq * kLdV + 2 * kBq * kLdP) * 2;

static_assert(kFk == kGran && kBq == kGran && kBk == kGran && kFq % kGran == 0,
              "tiles are whole granules");

__device__ __forceinline__ float neg_infinity() { return __uint_as_float(0xff800000u); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when !ok (no byte is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), float32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as bf16, the first in the low half (the lower column)
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ void atomic_add2(float* p, float a, float b) {
#if defined(__CUDACC_VER_MAJOR__) && \
    (__CUDACC_VER_MAJOR__ > 12 || (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 1))
  atomicAdd(reinterpret_cast<float2*>(p), make_float2(a, b));
#else
  atomicAdd(p, a);
  atomicAdd(p + 1, b);
#endif
}

// R rows of D bf16 from global (row stride rs elements) into shared (pitch
// LD); rows at or past `rows` are zero-filled.
template <int R, int D, int LD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int64_t rs, int rows,
                                          int tid) {
  constexpr int kChunks = D / 8;
  static_assert((R * kChunks) % kThreads == 0, "whole copies per thread");
#pragma unroll
  for (int i = 0; i < R * kChunks / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const bool ok = r < rows;
    cp_async16(dst + r * LD + col, ok ? src + r * rs + col : src, ok);
  }
}

// min and max of the positions of granules [g0, g1)
__device__ __forceinline__ int2 span_stats(const int2* st, int g0, int g1) {
  int2 r = st[g0];
  for (int g = g0 + 1; g < g1; ++g) {
    const int2 t = st[g];
    r.x = min(r.x, t.x);
    r.y = max(r.y, t.y);
  }
  return r;
}

// some pair of the query tile (stats qs) and the key tile (ks) matters
__device__ __forceinline__ bool needed(int2 qs, int2 ks) { return qs.x < 0 || ks.x <= qs.y; }

// every pair is allowed: no mask
__device__ __forceinline__ bool unmasked(int2 qs, int2 ks, bool keys_in_range) {
  return keys_in_range && ks.x >= 0 && ks.y <= qs.x;
}

__global__ void mla_stats_kernel(const int* __restrict__ pos, int2* __restrict__ stats, int S,
                                 int n_gran) {
  const int b = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int* p = pos + static_cast<int64_t>(b) * S;
  for (int gi = warp; gi < n_gran; gi += kThreads / 32) {
    int lo = INT_MAX, hi = INT_MIN;
    for (int e = lane; e < kGran; e += 32) {
      const int s = gi * kGran + e;
      if (s < S) {
        const int v = p[s];
        lo = min(lo, v);
        hi = max(hi, v);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
    if (lane == 0) stats[static_cast<int64_t>(b) * n_gran + gi] = make_int2(lo, hi);
  }
}

struct Fwd {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  int64_t q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h;
  const int* pos;
  const int2* stats;
  bf16* o;
  float* lse;
  int B, S, H, n_gran;
  float scale_log2;
};

__global__ void __launch_bounds__(kThreads, 1) mla_fwd_kernel(const Fwd p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kFq * kLdQk;
  bf16* sV = sK + 2 * kFk * kLdQk;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int n_bh = p.B * p.H;
  const int n_qt = (p.S + kFq - 1) / kFq;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / n_bh;  // longest first
  const int bh = static_cast<int>(blockIdx.x) % n_bh;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = qt * kFq;
  const int n_kt = p.n_gran;
  const int2* st = p.stats + static_cast<int64_t>(b) * p.n_gran;
  const int* pos = p.pos + static_cast<int64_t>(b) * p.S;
  const int2 qs = span_stats(st, q0 / kGran, min(p.n_gran, (q0 + kFq) / kGran));

  const bf16* qg = p.q + b * p.q_b + static_cast<int64_t>(q0) * p.q_s + h * p.q_h;
  const bf16* kg = p.k + b * p.k_b + h * p.k_h;
  const bf16* vg = p.v + b * p.v_b + h * p.v_h;
  auto next_tile = [&](int j) {
    while (j < n_kt && !needed(qs, st[j])) ++j;
    return j;
  };
  auto load_kv = [&](int j, int buf) {
    const int k0 = j * kFk;
    load_tile<kFk, kDqk, kLdQk>(sK + buf * kFk * kLdQk, kg + k0 * p.k_s, p.k_s, p.S - k0, tid);
    load_tile<kFk, kDv, kLdV>(sV + buf * kFk * kLdV, vg + k0 * p.v_s, p.v_s, p.S - k0, tid);
  };

  load_tile<kFq, kDqk, kLdQk>(sQ, qg, p.q_s, p.S - q0, tid);
  int j = next_tile(0);
  if (j < n_kt) load_kv(j, 0);
  cp_async_commit();

  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const int qp0 = r0 < p.S ? pos[r0] : -1;
  const int qp1 = r1 < p.S ? pos[r1] : -1;

  uint32_t qf[kDqk / 16][4];
  float o[kDv / 8][4];
#pragma unroll
  for (int n = 0; n < kDv / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  bool first = true;
  int buf = 0;
  while (j < n_kt) {
    const int jn = next_tile(j + 1);
    if (jn < n_kt) load_kv(jn, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (first) {
#pragma unroll
      for (int ks = 0; ks < kDqk / 16; ++ks)
        ldsm_x4(qf[ks], sQ + (warp * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) * kLdQk +
                            ks * 16 + ((lane >> 4) << 3));
      first = false;
    }
    const bf16* Kb = sK + buf * kFk * kLdQk;
    const bf16* Vb = sV + buf * kFk * kLdV;

    // S = Q K^T: 16 rows x 64 keys a warp
    float s[kFk / 8][4];
#pragma unroll
    for (int n = 0; n < kFk / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kDqk / 16; ++ks) {
#pragma unroll
      for (int np = 0; np < kFk / 16; ++np) {
        uint32_t kb[4];
        ldsm_x4(kb, Kb + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLdQk + ks * 16 +
                        (((lane >> 3) & 1) << 3));
        mma(s[2 * np], qf[ks], kb[0], kb[1]);
        mma(s[2 * np + 1], qf[ks], kb[2], kb[3]);
      }
    }

    // scale, mask
    const int k0 = j * kFk;
    if (unmasked(qs, st[j], k0 + kFk <= p.S)) {
#pragma unroll
      for (int n = 0; n < kFk / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= p.scale_log2;
    } else {
#pragma unroll
      for (int n = 0; n < kFk / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = k0 + n * 8 + tg * 2 + e;
          const bool in = c < p.S;
          const int kp = in ? pos[c] : -1;
          const bool ok = kp >= 0;
          s[n][e] = !in ? neg_infinity() : (ok && kp <= qp0 ? s[n][e] * p.scale_log2 : kNegInf);
          s[n][e + 2] =
              !in ? neg_infinity() : (ok && kp <= qp1 ? s[n][e + 2] * p.scale_log2 : kNegInf);
        }
    }

    // online softmax (base 2)
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < kFk / 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float a0 = exp2f(m0 - mx0), a1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < kFk / 8; ++n) {
      s[n][0] = exp2f(s[n][0] - m0);
      s[n][1] = exp2f(s[n][1] - m0);
      s[n][2] = exp2f(s[n][2] - m1);
      s[n][3] = exp2f(s[n][3] - m1);
      rs0 += s[n][0] + s[n][1];
      rs1 += s[n][2] + s[n][3];
    }
    l0 = l0 * a0 + rs0;
    l1 = l1 * a1 + rs1;
#pragma unroll
    for (int n = 0; n < kDv / 8; ++n) {
      o[n][0] *= a0;
      o[n][1] *= a0;
      o[n][2] *= a1;
      o[n][3] *= a1;
    }

    // O += P V: P from the S accumulators, V by transposing loads
#pragma unroll
    for (int kk = 0; kk < kFk / 16; ++kk) {
      const uint32_t pa[4] = {pack(s[2 * kk][0], s[2 * kk][1]), pack(s[2 * kk][2], s[2 * kk][3]),
                              pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < kDv / 16; ++np) {
        uint32_t vb[4];
        ldsm_x4_t(vb, Vb + (kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) * kLdV + np * 16 +
                          ((lane >> 4) << 3));
        mma(o[2 * np], pa, vb[0], vb[1]);
        mma(o[2 * np + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // the buffer is free for the load after next
    j = jn;
    buf ^= 1;
  }
  cp_async_wait<0>();

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float i0 = 1.f / l0, i1 = 1.f / l1;
  const int64_t row_pitch = static_cast<int64_t>(p.H) * kDv;
  bf16* og = p.o + static_cast<int64_t>(b) * p.S * row_pitch + h * kDv + tg * 2;
  if (r0 < p.S) {
#pragma unroll
    for (int n = 0; n < kDv / 8; ++n)
      *reinterpret_cast<uint32_t*>(og + r0 * row_pitch + n * 8) =
          pack(o[n][0] * i0, o[n][1] * i0);
  }
  if (r1 < p.S) {
#pragma unroll
    for (int n = 0; n < kDv / 8; ++n)
      *reinterpret_cast<uint32_t*>(og + r1 * row_pitch + n * 8) =
          pack(o[n][2] * i1, o[n][3] * i1);
  }
  if (tg == 0) {
    float* lse = p.lse + static_cast<int64_t>(bh) * p.S;
    if (r0 < p.S) lse[r0] = m0 == kNegInf ? kNegInf : m0 + log2f(l0);
    if (r1 < p.S) lse[r1] = m1 == kNegInf ? kNegInf : m1 + log2f(l1);
  }
}

// D[b, h, s] = sum_d dO[b, s, h, d] O[b, s, h, d]: one warp a row
__global__ void mla_bwd_prep_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                                    int64_t do_b, int64_t do_s, int64_t do_h,
                                    float* __restrict__ delta, int B, int S, int H) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= static_cast<int64_t>(B) * S * H) return;
  const int lane = threadIdx.x & 31;
  const int h = static_cast<int>(row % H);
  const int64_t bs = row / H;
  const int s = static_cast<int>(bs % S), b = static_cast<int>(bs / S);
  const uint2 ov = *reinterpret_cast<const uint2*>(o + row * kDv + lane * 4);
  const uint2 dv =
      *reinterpret_cast<const uint2*>(dout + b * do_b + s * do_s + h * do_h + lane * 4);
  const float2 o01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ov.x));
  const float2 o23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ov.y));
  const float2 d01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&dv.x));
  const float2 d23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&dv.y));
  float acc = o01.x * d01.x + o01.y * d01.y + o23.x * d23.x + o23.y * d23.y;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[(static_cast<int64_t>(b) * H + h) * S + s] = acc;
}

struct Bwd {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  int64_t q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, do_b, do_s, do_h;
  const int* pos;
  const int2* stats;
  const float* lse;
  const float* delta;
  float* dq;  // (B, S, H, 192) float32, zeroed
  bf16* dk;   // (B, S, H, 192)
  bf16* dv;   // (B, S, H, 128)
  int B, S, H, n_gran;
  float scale, scale_log2, inv_s;
};

__global__ void __launch_bounds__(kThreads, 1) mla_bwd_kernel(const Bwd p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + kBk * kLdQk;
  bf16* sQ = sV + kBk * kLdV;        // 2 buffers
  bf16* sdO = sQ + 2 * kBq * kLdQk;  // 2 buffers
  bf16* sP = sdO + 2 * kBq * kLdV;
  bf16* sdS = sP + kBq * kLdP;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int n_bh = p.B * p.H;
  const int kt = static_cast<int>(blockIdx.x) / n_bh;  // smallest key tile first
  const int bh = static_cast<int>(blockIdx.x) % n_bh;
  const int b = bh / p.H, h = bh % p.H;
  const int k0 = kt * kBk;
  const int n_qt = p.n_gran;
  const int2* st = p.stats + static_cast<int64_t>(b) * p.n_gran;
  const int* pos = p.pos + static_cast<int64_t>(b) * p.S;
  const int2 ks = st[kt];
  const bool keys_in = k0 + kBk <= p.S;

  const bf16* qg = p.q + b * p.q_b + h * p.q_h;
  const bf16* dog = p.dout + b * p.do_b + h * p.do_h;
  load_tile<kBk, kDqk, kLdQk>(sK, p.k + b * p.k_b + static_cast<int64_t>(k0) * p.k_s + h * p.k_h,
                              p.k_s, p.S - k0, tid);
  load_tile<kBk, kDv, kLdV>(sV, p.v + b * p.v_b + static_cast<int64_t>(k0) * p.v_s + h * p.v_h,
                            p.v_s, p.S - k0, tid);
  auto next_tile = [&](int i) {
    while (i < n_qt && !needed(st[i], ks)) ++i;
    return i;
  };
  auto load_q = [&](int i, int buf) {
    const int q0 = i * kBq;
    load_tile<kBq, kDqk, kLdQk>(sQ + buf * kBq * kLdQk, qg + q0 * p.q_s, p.q_s, p.S - q0, tid);
    load_tile<kBq, kDv, kLdV>(sdO + buf * kBq * kLdV, dog + q0 * p.do_s, p.do_s, p.S - q0, tid);
  };
  int i = next_tile(0);
  if (i < n_qt) load_q(i, 0);
  cp_async_commit();

  // (a)-(c): query rows wq*16.., keys wk*32..; (d), (e): keys wr*16..,
  // columns wc*64.. of dV and wc*96.. of dK; (f): query rows wr*16..,
  // columns wc*96.. of dQ
  const int wq = warp & 3, wk = warp >> 2;
  const int wr = warp & 3, wc = warp >> 2;
  int kpos[4][2];
  bool kin[4][2];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = k0 + wk * 32 + n * 8 + tg * 2 + e;
      kin[n][e] = c < p.S;
      kpos[n][e] = kin[n][e] ? pos[c] : -1;
    }
  const float* lse = p.lse + static_cast<int64_t>(bh) * p.S;
  const float* delta = p.delta + static_cast<int64_t>(bh) * p.S;
  const int64_t dq_pitch = static_cast<int64_t>(p.H) * kDqk;
  float* dqg = p.dq + static_cast<int64_t>(b) * p.S * dq_pitch + h * kDqk + wc * 96 + tg * 2;

  float dva[8][4], dka[12][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
#pragma unroll
  for (int n = 0; n < 12; ++n) dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;

  int buf = 0;
  while (i < n_qt) {
    const int in_ = next_tile(i + 1);
    if (in_ < n_qt) load_q(in_, buf ^ 1);
    cp_async_commit();
    const int q0 = i * kBq;
    const int ra = q0 + wq * 16 + g, rb = ra + 8;
    const float la = ra < p.S ? lse[ra] : 0.f, lb = rb < p.S ? lse[rb] : 0.f;
    const float da = ra < p.S ? delta[ra] : 0.f, db = rb < p.S ? delta[rb] : 0.f;
    const int qpa = ra < p.S ? pos[ra] : -1, qpb = rb < p.S ? pos[rb] : -1;
    const bool full = unmasked(st[i], ks, keys_in);
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Qb = sQ + buf * kBq * kLdQk;
    const bf16* dOb = sdO + buf * kBq * kLdV;

    // (a) S = Q K^T and (b) dP = dO V^T: 16 rows x 32 keys a warp
    float s[4][4], dp[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kq = 0; kq < kDqk / 16; ++kq) {
      uint32_t a[4];
      ldsm_x4(a, Qb + (wq * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) * kLdQk + kq * 16 +
                     ((lane >> 4) << 3));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t kb[4];
        ldsm_x4(kb, sK + (wk * 32 + np * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLdQk +
                        kq * 16 + (((lane >> 3) & 1) << 3));
        mma(s[2 * np], a, kb[0], kb[1]);
        mma(s[2 * np + 1], a, kb[2], kb[3]);
      }
    }
#pragma unroll
    for (int kq = 0; kq < kDv / 16; ++kq) {
      uint32_t a[4];
      ldsm_x4(a, dOb + (wq * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) * kLdV + kq * 16 +
                      ((lane >> 4) << 3));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t vb[4];
        ldsm_x4(vb, sV + (wk * 32 + np * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLdV +
                        kq * 16 + (((lane >> 3) & 1) << 3));
        mma(dp[2 * np], a, vb[0], vb[1]);
        mma(dp[2 * np + 1], a, vb[2], vb[3]);
      }
    }

    // (c) P and dS = P (dP - D) scale, to shared memory in bf16
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      float pr[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool lower = e >= 2;
        const float l = lower ? lb : la, d = lower ? db : da;
        const float t = s[n][e] * p.scale_log2;
        if (full) {
          pr[e] = exp2f(t - l);
          ds[e] = pr[e] * (dp[n][e] - d) * p.scale;
        } else {
          const int kp = kpos[n][e & 1];
          const bool ok = kp >= 0 && kp <= (lower ? qpb : qpa);
          pr[e] = ok ? exp2f(t - l) : ((kin[n][e & 1] && l == kNegInf) ? p.inv_s : 0.f);
          ds[e] = ok ? pr[e] * (dp[n][e] - d) * p.scale : 0.f;
        }
      }
      const int col = wk * 32 + n * 8 + tg * 2;
      const int row = wq * 16 + g;
      *reinterpret_cast<uint32_t*>(sP + row * kLdP + col) = pack(pr[0], pr[1]);
      *reinterpret_cast<uint32_t*>(sP + (row + 8) * kLdP + col) = pack(pr[2], pr[3]);
      *reinterpret_cast<uint32_t*>(sdS + row * kLdP + col) = pack(ds[0], ds[1]);
      *reinterpret_cast<uint32_t*>(sdS + (row + 8) * kLdP + col) = pack(ds[2], ds[3]);
    }
    __syncthreads();

    // (d) dV += P^T dO and (e) dK += dS^T Q: keys wr*16.. a warp
#pragma unroll
    for (int kq = 0; kq < kBq / 16; ++kq) {
      uint32_t pa[4], sa[4];
      const int arow = kq * 16 + (lane & 7) + ((lane >> 4) << 3);
      const int acol = wr * 16 + (((lane >> 3) & 1) << 3);
      ldsm_x4_t(pa, sP + arow * kLdP + acol);
      ldsm_x4_t(sa, sdS + arow * kLdP + acol);
      const int brow = kq * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t ob[4];
        ldsm_x4_t(ob, dOb + brow * kLdV + wc * 64 + np * 16 + ((lane >> 4) << 3));
        mma(dva[2 * np], pa, ob[0], ob[1]);
        mma(dva[2 * np + 1], pa, ob[2], ob[3]);
      }
#pragma unroll
      for (int np = 0; np < 6; ++np) {
        uint32_t qb[4];
        ldsm_x4_t(qb, Qb + brow * kLdQk + wc * 96 + np * 16 + ((lane >> 4) << 3));
        mma(dka[2 * np], sa, qb[0], qb[1]);
        mma(dka[2 * np + 1], sa, qb[2], qb[3]);
      }
    }

    // (f) dQ += dS K: query rows wr*16.., columns wc*96.., by atomics
    {
      float dqa[12][4];
#pragma unroll
      for (int n = 0; n < 12; ++n) dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kBk / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, sdS + (wr * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) * kLdP + kk * 16 +
                       ((lane >> 4) << 3));
        const int brow = kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
        for (int np = 0; np < 6; ++np) {
          uint32_t kb[4];
          ldsm_x4_t(kb, sK + brow * kLdQk + wc * 96 + np * 16 + ((lane >> 4) << 3));
          mma(dqa[2 * np], a, kb[0], kb[1]);
          mma(dqa[2 * np + 1], a, kb[2], kb[3]);
        }
      }
      const int fa = q0 + wr * 16 + g, fb = fa + 8;
      if (fa < p.S) {
#pragma unroll
        for (int n = 0; n < 12; ++n) atomic_add2(dqg + fa * dq_pitch + n * 8, dqa[n][0], dqa[n][1]);
      }
      if (fb < p.S) {
#pragma unroll
        for (int n = 0; n < 12; ++n) atomic_add2(dqg + fb * dq_pitch + n * 8, dqa[n][2], dqa[n][3]);
      }
    }
    __syncthreads();  // P, dS and the buffer are free
    i = in_;
    buf ^= 1;
  }
  cp_async_wait<0>();

  // dK, dV of the block's keys (the scale is in dS already)
  const int ka = k0 + wr * 16 + g, kb_ = ka + 8;
  const int64_t kpitch = static_cast<int64_t>(p.H) * kDqk, vpitch = static_cast<int64_t>(p.H) * kDv;
  bf16* dkg = p.dk + static_cast<int64_t>(b) * p.S * kpitch + h * kDqk + wc * 96 + tg * 2;
  bf16* dvg = p.dv + static_cast<int64_t>(b) * p.S * vpitch + h * kDv + wc * 64 + tg * 2;
  if (ka < p.S) {
#pragma unroll
    for (int n = 0; n < 12; ++n)
      *reinterpret_cast<uint32_t*>(dkg + ka * kpitch + n * 8) = pack(dka[n][0], dka[n][1]);
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<uint32_t*>(dvg + ka * vpitch + n * 8) = pack(dva[n][0], dva[n][1]);
  }
  if (kb_ < p.S) {
#pragma unroll
    for (int n = 0; n < 12; ++n)
      *reinterpret_cast<uint32_t*>(dkg + kb_ * kpitch + n * 8) = pack(dka[n][2], dka[n][3]);
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<uint32_t*>(dvg + kb_ * vpitch + n * 8) = pack(dva[n][2], dva[n][3]);
  }
}

// Opt the kernel in to `bytes` of dynamic shared memory, once per device
// (so a launch captured into a CUDA graph makes no attribute call).
int set_smem(const void* kernel, int bytes, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!done[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    done[dev] = true;
  }
  return 0;
}

bool fwd_smem_set[kMaxDevices] = {};
bool bwd_smem_set[kMaxDevices] = {};

}  // namespace

// Forward. q, k: (B, S, H, 192) bf16, v: (B, S, H, 128) bf16, element
// strides (b, s, h) as given, unit last stride; pos: (B, S) int32; stats:
// (B, ceil(S / 64)) int2, written here; o: (B, S, H, 128) bf16; lse: (B, H,
// S) float32. scale_log2 = scale * log2(e). Two launches (the granule stats,
// then the attention); returns cudaGetLastError().
extern "C" int mla_attention_fwd_launch(const void* q, const void* k, const void* v,
                                        long long q_b, long long q_s, long long q_h,
                                        long long k_b, long long k_s, long long k_h,
                                        long long v_b, long long v_s, long long v_h,
                                        const void* pos, void* stats, void* o, void* lse, int B,
                                        int S, int H, float scale_log2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int n_gran = (S + kGran - 1) / kGran;
  mla_stats_kernel<<<B, kThreads, 0, st>>>(static_cast<const int*>(pos),
                                           static_cast<int2*>(stats), S, n_gran);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  err = set_smem(reinterpret_cast<const void*>(mla_fwd_kernel), kFwdSmem, fwd_smem_set);
  if (err) return err;
  Fwd p{static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h,
        static_cast<const int*>(pos), static_cast<const int2*>(stats),
        static_cast<bf16*>(o), static_cast<float*>(lse), B, S, H, n_gran, scale_log2};
  const long long blocks = static_cast<long long>((S + kFq - 1) / kFq) * B * H;
  mla_fwd_kernel<<<static_cast<unsigned>(blocks), kThreads, kFwdSmem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Backward. q, k, v, pos, stats, o, lse as the forward took or left them;
// dout: (B, S, H, 128) bf16 with its own strides; delta: (B, H, S) float32
// scratch; dq: (B, S, H, 192) float32 scratch, zeroed here and left holding
// dQ; dk (B, S, H, 192), dv (B, S, H, 128) bf16. Four operations on the
// stream (a memset, D, the gradients); returns cudaGetLastError().
extern "C" int mla_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* dout, long long q_b, long long q_s,
    long long q_h, long long k_b, long long k_s, long long k_h, long long v_b, long long v_s,
    long long v_h, long long do_b, long long do_s, long long do_h, const void* pos,
    const void* stats, const void* o, const void* lse, void* delta, void* dq, void* dk, void* dv,
    int B, int S, int H, float scale, float scale_log2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int n_gran = (S + kGran - 1) / kGran;
  int err = static_cast<int>(
      cudaMemsetAsync(dq, 0, static_cast<size_t>(B) * S * H * kDqk * sizeof(float), st));
  if (err) return err;
  const long long rows = static_cast<long long>(B) * S * H;
  mla_bwd_prep_kernel<<<static_cast<unsigned>((rows + 7) / 8), kThreads, 0, st>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), do_b, do_s, do_h,
      static_cast<float*>(delta), B, S, H);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  err = set_smem(reinterpret_cast<const void*>(mla_bwd_kernel), kBwdSmem, bwd_smem_set);
  if (err) return err;
  Bwd p{static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h,
        do_b, do_s, do_h, static_cast<const int*>(pos), static_cast<const int2*>(stats),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<float*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
        B, S, H, n_gran, scale, scale_log2, 1.0f / static_cast<float>(S)};
  const long long blocks = static_cast<long long>(n_gran) * B * H;
  mla_bwd_kernel<<<static_cast<unsigned>(blocks), kThreads, kBwdSmem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mla_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
