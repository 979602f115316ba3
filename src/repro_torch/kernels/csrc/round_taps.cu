// The QAFeL round's metric taps: the finishing pass, one launch a round.
//
// No TPU kernel: the JAX reference computes the round's taps in XLA inside
// its jitted round (repro/distributed/steps.py:200-204 ->
// repro/obs/taps.py::flush_tap_vector: five squares behind a hard boundary,
// jnp.sum, sqrt). The round updates x, x-hat and the clients' sum in place,
// so the port takes the squares where the values are: the server-update
// kernel writes the level-0 window sums (windows of 32 values, XLA:CPU's
// law) of delta_bar^2, (x_new - x)^2 and diff^2, K3's apply the sums of
// err^2 and q^2. This pass finishes XLA's law on those sums.
//
// In:  partials f32 (5, W), W = ceil(d / 32): the five rows of window sums
//      in FLUSH_TAP_NAMES order (delta, update, diff, err, q); the round's
//      K staleness weights.
// Out: f32 (7,) = [sqrt(S_delta), sqrt(S_upd), sqrt(S_diff),
//      sqrt(S_err) / max(sqrt(S_diff), 1e-30), sqrt(S_q), sum w, min w],
//      each S the xla_sum of its row, which is the xla_sum of the squares.
//
// Bound: bytes. It reads 5 * 4 * W B (gemma2-2b at d = 2.61e9: 1.63 GB,
// 0.49 ms at 3.35 TB/s).
//
// Design: tap_reduce.cuh's plan with the identity in place of the square:
// a warp stages 1,024 window sums of each row through shared memory with
// cp.async, every lane sums one window of 32 in order, the warp adds the
// 32 sums in order; at gemma2-2b's W a block owns whole level-2 windows of
// the rows and the last block runs the levels above and writes the
// vector.
#include "tap_reduce.cuh"

namespace {

// The five rows staged a span; value e of each as is (0 outside [0, W)).
struct PartialRows {
  static constexpr int kSums = 5;
  static constexpr int kVectors = 5;
  static constexpr int kExtraWords = 0;
  const float* rows;
  long long windows;
  const float* weights;
  int k;
  float* out;
  __device__ __forceinline__ const float* vector(long long, int s) const {
    return rows + s * windows;
  }
  __device__ __forceinline__ void stage_extra(float*, long long, long long,
                                              int) const {}
  __device__ __forceinline__ void lane_sums(const float* st, long long,
                                            long long, int lane,
                                            float acc[kSums]) const {
    const float* row = st + lane * taps::kRowFloats;
#pragma unroll 2
    for (int q = 0; q < taps::kWindow / 4; ++q) {
#pragma unroll
      for (int s = 0; s < kSums; ++s) {
        const float4 v = *reinterpret_cast<const float4*>(
            row + s * taps::kSpanFloats + 4 * q);
        acc[s] = __fadd_rn(acc[s], v.x);
        acc[s] = __fadd_rn(acc[s], v.y);
        acc[s] = __fadd_rn(acc[s], v.z);
        acc[s] = __fadd_rn(acc[s], v.w);
      }
    }
  }
  __device__ __forceinline__ void finish(long long, const float* tot) const {
    taps::tap_vector(tot, weights, k, out);
  }
};

__global__ void __launch_bounds__(taps::kThreads)
    round_taps_kernel(PartialRows src, taps::Plan plan, float* scratch,
                      unsigned* counter) {
  taps::run(src, plan, scratch, counter);
}

}  // namespace

// `weights` may be null when k == 0. `scratch` holds
// taps::scratch_slots(ceil(windows / 1024)) * 5 floats; `counter` is one
// unsigned that is 0 between launches.
extern "C" int round_taps(const void* partials, long long windows,
                          const void* weights, int k, void* scratch,
                          void* counter, void* out, void* stream) {
  if (windows <= 0 || k < 0 || (k > 0 && weights == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const PartialRows src{(const float*)partials, windows,
                        (const float*)weights, k, (float*)out};
  return taps::launch(round_taps_kernel, src, taps::plan_of(windows, 1),
                      (float*)scratch, (unsigned*)counter,
                      (cudaStream_t)stream);
}
