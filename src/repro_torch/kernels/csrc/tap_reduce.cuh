// Fixed-order sums of squares shared by the metric-tap kernels
// (flush_taps.cu, upload_taps.cu; sm_90a, built with -fmad=false).
//
// The law, which repro_torch/kernels/ref.py ``tap_sum`` spells out with
// elementwise adds for the CPU:
//   * a row of n values is cut into chunks of kChunk = kThreads * kPerThread
//     elements; element i*kThreads + t of a chunk goes to lane t, and lane t
//     adds its kPerThread values in order of i, from +0;
//   * the chunk's kThreads lane sums are combined by a halving tree: at
//     width w, lane t < w/2 adds lane t + w/2, from w = kThreads down to 2;
//   * the row's chunk sums are combined the same way: chunk j goes to lane
//     j % kThreads, each lane adds its chunk sums in order from +0, and the
//     lanes close with the same halving tree.
// A value past the end of the row counts as +0, which leaves a sum of
// squares as it was, so the order depends on n alone: not on the number of
// rows in a launch, the grid, the SM count or the card.
//
// One launch does both levels. Each block reduces one chunk of one row and
// thread 0 writes its partial sums; the last block of the row to finish
// (a per-row counter, counted with atomicAdd after a __threadfence) reads
// the row's partials back through L2, reduces them and resets the counter
// to 0 for the next launch. Launches that share counters must run on one
// stream.
//
// Every product, difference and sum is an explicit _rn intrinsic.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace taps {

constexpr int kThreads = 256;   // lanes of the law, threads per block
constexpr int kPerThread = 16;  // values a lane adds in order per chunk
constexpr long long kChunk = (long long)kThreads * kPerThread;
constexpr unsigned kFullMask = 0xffffffffu;

// The halving tree over one value per thread, for each of S sums at once.
// Thread 0 ends with the totals in v[]; the other threads' v[] are left
// undefined. `scratch` is S x kThreads floats of shared memory; the call
// ends with a block barrier, so the next call may reuse it.
template <int S>
__device__ __forceinline__ void block_tree(float v[S],
                                           float (*scratch)[kThreads]) {
  const int t = threadIdx.x;
#pragma unroll
  for (int s = 0; s < S; ++s) scratch[s][t] = v[s];
  __syncthreads();
#pragma unroll
  for (int h = kThreads / 2; h >= 32; h /= 2) {
    if (t < h) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        scratch[s][t] = __fadd_rn(scratch[s][t], scratch[s][t + h]);
      }
    }
    __syncthreads();
  }
  if (t < 32) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      float x = scratch[s][t];
#pragma unroll
      for (int h = 16; h >= 1; h /= 2) {
        x = __fadd_rn(x, __shfl_down_sync(kFullMask, x, h));
      }
      v[s] = x;
    }
  }
  __syncthreads();
}

// Thread 0 writes the block's S partials (from block_tree) to `partials`
// and counts the block done; returns, in every thread, whether this block
// was the row's last of `chunks`.
template <int S>
__device__ __forceinline__ bool partials_done(const float v[S],
                                              float* __restrict__ partials,
                                              unsigned* counter,
                                              long long chunks) {
  __shared__ unsigned done;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) partials[s] = v[s];
    __threadfence();  // the partials are visible before the count
    done = atomicAdd(counter, 1u);
  }
  __syncthreads();
  return done == (unsigned)(chunks - 1);
}

// The second level of the law in the row's last block: the row's totals
// from its `chunks` x S partials, on thread 0, which also resets the row's
// counter.
template <int S>
__device__ __forceinline__ void row_totals(const float* partials,
                                           long long chunks,
                                           unsigned* counter,
                                           float (*scratch)[kThreads],
                                           float tot[S]) {
#pragma unroll
  for (int s = 0; s < S; ++s) tot[s] = 0.0f;
  for (long long j = threadIdx.x; j < chunks; j += kThreads) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      tot[s] = __fadd_rn(tot[s], __ldcg(partials + j * S + s));
    }
  }
  block_tree<S>(tot, scratch);
  if (threadIdx.x == 0) *counter = 0u;
}

}  // namespace taps
