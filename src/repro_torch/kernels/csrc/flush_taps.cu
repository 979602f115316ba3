// The flush's metric taps: seven scalars of one server flush, in one launch.
//
// No TPU kernel: the JAX reference computes these taps in XLA inside its
// one jitted flush (repro/obs/taps.py::flush_tap_vector, squares pinned
// behind a hard boundary, then jnp.sum and sqrt). The port takes them in a
// kernel of its own that sums in XLA:CPU's order (tap_reduce.cuh), so the
// card equals the CPU and the reference bit for bit, and taps on cost one
// launch per flush.
//
// In:  the flush's true-n f32 vectors x_old, x_new, delta (the aggregated
//      buffer delta), diff (x_new - x-hat) and q (the decoded broadcast
//      increment; diff itself for an identity server quantizer, so the
//      relative error is exactly 0), and the window's K normalized
//      staleness weights or none (K = 0).
// Out: f32 (7,) = [sqrt(S_delta), sqrt(S_upd), sqrt(S_diff),
//      sqrt(S_err) / max(sqrt(S_diff), 1e-30), sqrt(S_q), sum w, min w]
//      with S_delta = sum delta^2, S_upd = sum (x_new - x_old)^2,
//      S_diff = sum diff^2, S_err = sum (diff - q)^2, S_q = sum q^2, the
//      weights summed in ascending k (zeros without weights).
//
// Bound: bytes. It reads 5*n*4 B (the CNN's n = 79,842: 1.6 MB, 0.48 us at
// 3.35 TB/s, so the launch floor sets its time; d = 1e8: 2.0 GB, 0.597 ms).
// The earlier design (two passes of 16 level-0 windows a warp, half the
// lanes summing the other half's windows, 4-byte loads that waited on
// the sums, the levels from 2 up in one block) ran at 47% of it at
// d = 1e8.
//
// Design: tap_reduce.cuh's plan. Each warp stages a span of 1,024 values
// of the five vectors through shared memory with cp.async, two spans in
// flight at a time, and every lane sums one window of 32 of the five
// squares in order; at d = 1e8 a block owns whole level-2 windows
// (32,768 values), so only 3,052 sums a vector reach the tail; at the
// CNN's n the 78 level-1 windows spread over 20 blocks, one a warp.
#include "tap_reduce.cuh"

namespace {

// The five vectors staged a span, and their five squares a value: delta^2,
// (x_new - x_old)^2, diff^2, (diff - q)^2, q^2 (0 outside [0, n), as the
// staging fills 0 there).
struct FlushSource {
  static constexpr int kSums = 5;
  static constexpr int kVectors = 5;  // delta, x_old, x_new, diff, q
  static constexpr int kExtraWords = 0;
  const float* v[kVectors];
  const float* weights;
  int k;
  float* out;
  __device__ __forceinline__ const float* vector(long long, int i) const {
    return v[i];
  }
  __device__ __forceinline__ void stage_extra(float*, long long, long long,
                                              int) const {}
  __device__ __forceinline__ void lane_sums(const float* st, long long,
                                            long long, int lane,
                                            float acc[kSums]) const {
    const float* row = st + lane * taps::kRowFloats;
#pragma unroll 2
    for (int q = 0; q < taps::kWindow / 4; ++q) {
      float4 f[kVectors];
#pragma unroll
      for (int i = 0; i < kVectors; ++i) {
        f[i] = *reinterpret_cast<const float4*>(row + i * taps::kSpanFloats +
                                                4 * q);
      }
      const float* dl = &f[0].x;
      const float* xo = &f[1].x;
      const float* xn = &f[2].x;
      const float* df = &f[3].x;
      const float* qv = &f[4].x;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float upd = __fsub_rn(xn[c], xo[c]);
        const float err = __fsub_rn(df[c], qv[c]);
        acc[0] = __fadd_rn(acc[0], __fmul_rn(dl[c], dl[c]));
        acc[1] = __fadd_rn(acc[1], __fmul_rn(upd, upd));
        acc[2] = __fadd_rn(acc[2], __fmul_rn(df[c], df[c]));
        acc[3] = __fadd_rn(acc[3], __fmul_rn(err, err));
        acc[4] = __fadd_rn(acc[4], __fmul_rn(qv[c], qv[c]));
      }
    }
  }
  __device__ __forceinline__ void finish(long long, const float* tot) const {
    taps::tap_vector(tot, weights, k, out);
  }
};

__global__ void __launch_bounds__(taps::kThreads)
    flush_taps_kernel(FlushSource src, taps::Plan plan, float* partials,
                      unsigned* counter) {
  taps::run(src, plan, partials, counter);
}

}  // namespace

// `weights` may be null when k == 0. `partials` holds
// taps::scratch_slots(ceil(n / 1024)) * 5 floats; `counter` is one unsigned
// that is 0 between launches.
extern "C" int flush_taps(const void* x_old, const void* x_new,
                          const void* delta, const void* diff, const void* q,
                          const void* weights, int k, long long n,
                          void* partials, void* counter, void* out,
                          void* stream) {
  if (n <= 0 || k < 0 || (k > 0 && weights == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const FlushSource src{{(const float*)delta, (const float*)x_old,
                         (const float*)x_new, (const float*)diff,
                         (const float*)q},
                        (const float*)weights, k, (float*)out};
  return taps::launch(flush_taps_kernel, src, taps::plan_of(n, 1),
                      (float*)partials, (unsigned*)counter,
                      (cudaStream_t)stream);
}
