// The flush's metric taps: seven scalars of one server flush, in one launch.
//
// No TPU kernel: the JAX reference computes these taps in XLA inside its
// one jitted flush (repro/obs/taps.py::flush_tap_vector, squares pinned
// behind a hard boundary, then jnp.sum and sqrt). The port takes them in a
// kernel of its own so that their reduction order is fixed (tap_reduce.cuh)
// and the card equals the CPU bit for bit, and so that taps on cost one
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
// Design: a simple first kernel. One block of 256 threads per 4,096-element
// chunk; a thread issues all its loads first (16 elements of each vector,
// coalesced 4-byte loads: 80 in flight) and then keeps the five sums; the
// chunk's partials go to a scratch buffer and the last block reduces them
// (tap_reduce.cuh).
#include "tap_reduce.cuh"

namespace {

using taps::kThreads;
constexpr int kSums = 5;

__global__ void __launch_bounds__(kThreads)
    flush_taps_kernel(const float* x_old, const float* x_new,
                      const float* delta, const float* diff, const float* q,
                      const float* weights, int k, long long n,
                      long long chunks, float* partials, unsigned* counter,
                      float* __restrict__ out) {
  __shared__ float scratch[kSums][kThreads];
  const long long c = blockIdx.x;
  const long long e0 = c * taps::kChunk + threadIdx.x;
  // all loads first (80 in flight per thread), then the in-order sums;
  // a value past n is 0, whose square adds +0 and changes no sum
  float dl[taps::kPerThread], xo[taps::kPerThread], xn[taps::kPerThread],
      df[taps::kPerThread], qv[taps::kPerThread];
#pragma unroll
  for (int i = 0; i < taps::kPerThread; ++i) {
    const long long e = e0 + (long long)i * kThreads;
    const bool in = e < n;
    dl[i] = in ? __ldg(delta + e) : 0.0f;
    xo[i] = in ? __ldg(x_old + e) : 0.0f;
    xn[i] = in ? __ldg(x_new + e) : 0.0f;
    df[i] = in ? __ldg(diff + e) : 0.0f;
    qv[i] = in ? __ldg(q + e) : 0.0f;
  }
  float acc[kSums] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < taps::kPerThread; ++i) {
    const float upd = __fsub_rn(xn[i], xo[i]);
    const float err = __fsub_rn(df[i], qv[i]);
    acc[0] = __fadd_rn(acc[0], __fmul_rn(dl[i], dl[i]));
    acc[1] = __fadd_rn(acc[1], __fmul_rn(upd, upd));
    acc[2] = __fadd_rn(acc[2], __fmul_rn(df[i], df[i]));
    acc[3] = __fadd_rn(acc[3], __fmul_rn(err, err));
    acc[4] = __fadd_rn(acc[4], __fmul_rn(qv[i], qv[i]));
  }
  taps::block_tree<kSums>(acc, scratch);
  if (!taps::partials_done<kSums>(acc, partials + c * kSums, counter,
                                  chunks)) {
    return;
  }
  float tot[kSums];
  taps::row_totals<kSums>(partials, chunks, counter, scratch, tot);
  if (threadIdx.x != 0) return;
  float r[kSums];
#pragma unroll
  for (int s = 0; s < kSums; ++s) r[s] = __fsqrt_rn(tot[s]);
  out[0] = r[0];
  out[1] = r[1];
  out[2] = r[2];
  out[3] = __fdiv_rn(r[3], fmaxf(r[2], 1e-30f));
  out[4] = r[4];
  float wsum = 0.0f, wmin = 0.0f;
  if (k > 0) {
    wsum = wmin = weights[0];
    for (int j = 1; j < k; ++j) {
      wsum = __fadd_rn(wsum, weights[j]);
      wmin = fminf(wmin, weights[j]);
    }
  }
  out[5] = wsum;
  out[6] = wmin;
}

}  // namespace

// `weights` may be null when k == 0. `partials` holds chunks*5 floats,
// chunks = ceil(n / 4096); `counter` is one unsigned that is 0 between
// launches.
extern "C" int flush_taps(const void* x_old, const void* x_new,
                          const void* delta, const void* diff, const void* q,
                          const void* weights, int k, long long n,
                          void* partials, void* counter, void* out,
                          void* stream) {
  if (n <= 0 || k < 0 || (k > 0 && weights == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long chunks = (n + taps::kChunk - 1) / taps::kChunk;
  if (chunks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flush_taps_kernel<<<(unsigned)chunks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x_old, (const float*)x_new, (const float*)delta,
      (const float*)diff, (const float*)q, (const float*)weights, k, n,
      chunks, (float*)partials, (unsigned*)counter, (float*)out);
  return (int)cudaGetLastError();
}
