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
// Design: tap_reduce.cuh's two passes with the identity in place of the
// square: a warp stages 1,024 window sums of each row through shared
// memory, lane k sums one window of 32 in order, the warp adds the 32 sums
// in order; the last block runs the levels above and writes the vector.
#include "tap_reduce.cuh"

namespace {

using taps::kThreads;
constexpr int kSums = 5;

// Value e of each of the five rows as is (0 outside [0, W)).
struct PartialRows {
  const float* rows;
  long long windows;
  __device__ __forceinline__ void operator()(long long e,
                                             float v[kSums]) const {
    const bool in = e >= 0 && e < windows;
#pragma unroll
    for (int s = 0; s < kSums; ++s) {
      v[s] = in ? __ldg(rows + s * windows + e) : 0.0f;
    }
  }
};

__global__ void __launch_bounds__(kThreads)
    round_taps_kernel(PartialRows rows, const float* weights, int k,
                      taps::Law law, float* scratch, unsigned* counter,
                      float* __restrict__ out) {
  taps::level1_sums<kSums>(rows, law, blockIdx.x * (long long)taps::kWarps,
                           scratch);
  if (!taps::block_done(counter, law.blocks)) return;
  float tot[kSums];
  taps::row_totals<kSums>(scratch, law.l1, counter, tot);
  if (threadIdx.x == 0) taps::tap_vector(tot, weights, k, out);
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
  const taps::Law law = taps::law_of(windows);
  if (law.blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  round_taps_kernel<<<(unsigned)law.blocks, kThreads, 0,
                      (cudaStream_t)stream>>>(
      PartialRows{(const float*)partials, windows}, (const float*)weights, k,
      law, (float*)scratch, (unsigned*)counter, (float*)out);
  return (int)cudaGetLastError();
}
