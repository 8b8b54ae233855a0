// Type I / Type II feedback of one class round, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro.kernels.ta_update._update_kernel
// (src/repro/kernels/ta_update.py:35, pallas_call at :99). For clause j and
// literal k of one class row, with c = clause_out[j] == 1, l = lit[k] == 1,
// u = uniforms[j, k]:
//
//   active[j] and type_i[j]:    d = [c & l & u < p_reward]
//                                   - [(!c | !l) & u < inv_s]
//   active[j] and !type_i[j]:   d = [c & !l & ta[j, k] <= N]
//   otherwise:                  d = 0
//   out[j, k] = clamp(ta[j, k] + d, 1, 2N)
//
// inv_s and p_reward come in as float32: the host rounds the double values
// 1/s and 1 - 1/s (or 1.0 under boost_true_positive), as JAX's weak-typed
// Python floats give them, so the comparisons match the reference bit for
// bit. Neither is recomputed here: 1.0f / s lands one ulp off for some s.
//
// What bounds it on an H100: memory. One class round at the MNIST width
// reads and writes 2000 x 1568 int16 states (6.27 MB each way) and reads at
// most as many float32 uniforms (12.5 MB): 25.1 MB, 7.49 us at 3.35 TB/s.
// A row's uniforms matter only when the row takes Type I feedback (active
// and type I), so other rows never read theirs.
//
// Design: grid (n, ceil(ceil(L / 8) / 128)). blockIdx.x is the clause, so
// its three gates are block-uniform values held in registers and the Type I
// branch never diverges inside a block. Each thread takes 8 consecutive
// literals: one 16-byte load of 8 int16 states, two float4 (16-byte) loads
// of uniforms, one 8-byte load of literal bytes, one 16-byte store. When L
// is not a multiple of 8 or a pointer is not aligned for those loads, the
// same thread walks its 8 literals with scalar loads. The ragged tail of a
// row is masked in the kernel: nothing is padded (the TPU wrapper pads the
// uniforms with 1.0 instead). out may alias ta (an in-place round): each
// element is read and then written by the same thread and by no other.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPer = 8;  // literals per thread

union States8 {
  int4 v;
  int16_t e[kPer];
};
union Uniforms8 {
  float4 v[2];
  float e[kPer];
};
union Literals8 {
  uint2 v;
  uint8_t e[kPer];
};

struct Round {
  bool c1;      // clause output is 1
  bool type_i;  // the clause takes Type I feedback (else Type II)
  bool active;  // the clause's update gate fired
  int n_states;
  float inv_s;
  float p_reward;
};

__device__ __forceinline__ int16_t feedback(int16_t ta, bool l1, float u,
                                            const Round& r) {
  int d = 0;
  if (r.active) {
    if (r.type_i) {
      const int reward = (r.c1 && l1 && u < r.p_reward) ? 1 : 0;
      const int penalty = ((!r.c1 || !l1) && u < r.inv_s) ? 1 : 0;
      d = reward - penalty;
    } else {
      d = (r.c1 && !l1 && ta <= r.n_states) ? 1 : 0;
    }
  }
  return static_cast<int16_t>(
      min(max(static_cast<int>(ta) + d, 1), 2 * r.n_states));
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
ta_update_kernel(const int16_t* ta, const uint8_t* __restrict__ lit,
                 const int8_t* __restrict__ clause_out,
                 const uint8_t* __restrict__ type_i,
                 const uint8_t* __restrict__ active,
                 const float* __restrict__ uniforms, int16_t* out, int L,
                 int n_states, float inv_s, float p_reward) {
  const int j = blockIdx.x;
  const int k0 = (blockIdx.y * kThreads + threadIdx.x) * kPer;
  if (k0 >= L) return;
  const Round r{clause_out[j] == 1, type_i[j] != 0, active[j] != 0,
                n_states, inv_s, p_reward};
  const bool needs_u = r.active && r.type_i;
  const size_t base = static_cast<size_t>(j) * L + k0;

  if constexpr (kVec) {  // L % 8 == 0, aligned pointers: whole chunks
    States8 s, o;
    s.v = *reinterpret_cast<const int4*>(ta + base);
    Literals8 l;
    l.v = __ldg(reinterpret_cast<const uint2*>(lit + k0));
    Uniforms8 u;
    if (needs_u) {
      const float4* up = reinterpret_cast<const float4*>(uniforms + base);
      u.v[0] = __ldcs(up);
      u.v[1] = __ldcs(up + 1);
    } else {
      u.v[0] = u.v[1] = make_float4(1.f, 1.f, 1.f, 1.f);  // never read
    }
#pragma unroll
    for (int e = 0; e < kPer; ++e)
      o.e[e] = feedback(s.e[e], l.e[e] == 1, u.e[e], r);
    *reinterpret_cast<int4*>(out + base) = o.v;
  } else {
    const int cnt = min(kPer, L - k0);
    for (int e = 0; e < cnt; ++e) {
      const float u = needs_u ? __ldcs(uniforms + base + e) : 1.f;
      out[base + e] = feedback(ta[base + e], __ldg(lit + k0 + e) == 1, u, r);
    }
  }
}

}  // namespace

// ta, out: (n, L) int16 (out may equal ta); lit: (L,) uint8; clause_out:
// (n,) int8; type_i, active: (n,) bool bytes; uniforms: (n, L) float32.
// vec != 0 only when L % 8 == 0, ta/out/uniforms are 16-byte aligned and
// lit is 8-byte aligned. Returns cudaGetLastError() after the launch.
extern "C" int ta_update_launch(const void* ta, const void* lit,
                                const void* clause_out, const void* type_i,
                                const void* active, const void* uniforms,
                                void* out, int n, int L, int n_states,
                                float inv_s, float p_reward, int vec,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunks = (L + kPer - 1) / kPer;
  const dim3 grid(n, (chunks + kThreads - 1) / kThreads);
  const auto* t = static_cast<const int16_t*>(ta);
  const auto* l = static_cast<const uint8_t*>(lit);
  const auto* c = static_cast<const int8_t*>(clause_out);
  const auto* ti = static_cast<const uint8_t*>(type_i);
  const auto* a = static_cast<const uint8_t*>(active);
  const auto* u = static_cast<const float*>(uniforms);
  auto* o = static_cast<int16_t*>(out);
  if (vec) {
    ta_update_kernel<true><<<grid, kThreads, 0, s>>>(
        t, l, c, ti, a, u, o, L, n_states, inv_s, p_reward);
  } else {
    ta_update_kernel<false><<<grid, kThreads, 0, s>>>(
        t, l, c, ti, a, u, o, L, n_states, inv_s, p_reward);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ta_update_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
