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
//
// Design: tap_reduce.cuh's law (XLA:CPU's reduce-windows of 32): a warp
// reads its level-1 window of 1,024 values of each vector coalesced, stages
// the five squares through shared memory so that a lane sums one window of
// 32 in order, and adds the 32 window sums in order; a block of 4 warps
// writes 4 level-1 sums, and the last block runs the levels above them.
#include "tap_reduce.cuh"

namespace {

using taps::kThreads;
constexpr int kSums = 5;

// The five squares of value e: delta^2, (x_new - x_old)^2, diff^2,
// (diff - q)^2, q^2; 0 outside [0, n).
struct FlushSquares {
  const float* x_old;
  const float* x_new;
  const float* delta;
  const float* diff;
  const float* q;
  long long n;
  __device__ __forceinline__ void operator()(long long e,
                                             float v[kSums]) const {
    const bool in = e >= 0 && e < n;
    const float dl = in ? __ldg(delta + e) : 0.0f;
    const float xo = in ? __ldg(x_old + e) : 0.0f;
    const float xn = in ? __ldg(x_new + e) : 0.0f;
    const float df = in ? __ldg(diff + e) : 0.0f;
    const float qv = in ? __ldg(q + e) : 0.0f;
    const float upd = __fsub_rn(xn, xo);
    const float err = __fsub_rn(df, qv);
    v[0] = __fmul_rn(dl, dl);
    v[1] = __fmul_rn(upd, upd);
    v[2] = __fmul_rn(df, df);
    v[3] = __fmul_rn(err, err);
    v[4] = __fmul_rn(qv, qv);
  }
};

__global__ void __launch_bounds__(kThreads)
    flush_taps_kernel(FlushSquares squares, const float* weights, int k,
                      taps::Law law, float* partials, unsigned* counter,
                      float* __restrict__ out) {
  taps::level1_sums<kSums>(squares, law, blockIdx.x * (long long)taps::kWarps,
                           partials);
  if (!taps::block_done(counter, law.blocks)) return;
  float tot[kSums];
  taps::row_totals<kSums>(partials, law.l1, counter, tot);
  if (threadIdx.x == 0) taps::tap_vector(tot, weights, k, out);
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
  const taps::Law law = taps::law_of(n);
  if (law.blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const FlushSquares squares{(const float*)x_old, (const float*)x_new,
                             (const float*)delta, (const float*)diff,
                             (const float*)q, n};
  flush_taps_kernel<<<(unsigned)law.blocks, kThreads, 0,
                      (cudaStream_t)stream>>>(
      squares, (const float*)weights, k, law, (float*)partials,
      (unsigned*)counter, (float*)out);
  return (int)cudaGetLastError();
}
