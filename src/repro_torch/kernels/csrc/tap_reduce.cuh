// Sums of squares in XLA:CPU's order, shared by the metric-tap kernels
// (flush_taps.cu, upload_taps.cu, round_taps.cu; sm_90a, built with
// -fmad=false).
//
// The law is the reference's own: XLA:CPU compiles an f32 jnp.sum of n
// values to reduce-windows of 32 (repro_torch/kernels/ref.py ``xla_sum``
// spells it with elementwise adds for the CPU):
//   * level 0 cuts the n values into ceil(n/32) windows of 32, with
//     floor(pad/2) zeros in front and the rest of the padding behind; each
//     window is summed in order from +0;
//   * each further level takes windows of 32 of the previous level's sums,
//     with that level's own padding split the same way;
//   * when 32 or fewer sums are left they are summed in order.
// The values are squares, never negative, so zeros at the top level
// change no sum: the top level is summed as one window with its values
// first (front_pad 0 there).
//
// Levels 0 and 1 run in the blocks: a warp owns one level-1 window (1,024
// values) and stages it through shared memory in two halves of 16 level-0
// windows: in step k the warp reads window k's 32 values, coalesced (lane
// l value l), squares them and writes them to row k of a padded tile; then
// lane k sums row k in order from +0 (the tile's stride of 33 floats puts
// the 16 rows' reads on distinct banks). The warp then adds its 32 level-0
// sums in order of window into one level-1 sum; a block of 4 warps writes
// 4 level-1 sums. The last block of a row to finish (a per-row counter,
// counted with atomicAdd after a __threadfence) reads the row's level-1
// sums back through L2, runs the levels from 2 up in place in the same
// scratch buffer, and resets the counter to 0 for the next launch. One
// launch per call; launches that share counters must run on one stream.
// The order depends on n alone: not on the number of rows in a launch, the
// grid, the SM count or the card.
//
// The law is recursive: past level 0 it is the same law applied to the
// level-0 sums. So a kernel that writes the level-0 (32-value window) sums
// of a vector (server_update.cu and unpack_dequantize.cu with taps) leaves
// the rest to round_taps.cu, which runs this file's two passes over those
// sums with the identity in place of the square.
//
// Every product, difference and sum is an explicit _rn intrinsic.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace taps {

constexpr int kWindow = 32;                  // XLA:CPU's reduce window
constexpr int kThreads = 128;                // threads per block
constexpr int kWarps = kThreads / 32;        // level-1 windows per block
constexpr long long kL1Span = kWindow * kWindow;  // values per level-1 sum
constexpr int kHalf = kWindow / 2;           // level-0 windows per staging
constexpr unsigned kFullMask = 0xffffffffu;

__host__ __device__ inline long long cdiv(long long a, long long b) {
  return (a + b - 1) / b;
}

// Zeros in front of a level of m values: half the padding to whole
// windows, rounded down; 0 at the top level (m <= 32).
__host__ __device__ inline long long front_pad(long long m) {
  return m <= kWindow ? 0 : (cdiv(m, kWindow) * kWindow - m) / 2;
}

// Where a row of n values puts its level-1 windows: window j covers values
// [j * 1024 - offset, j * 1024 - offset + 1024).
struct Law {
  long long offset;  // front_pad(n) + 32 * front_pad(ceil(n / 32))
  long long l1;      // level-1 sums of the row, ceil(n / 1024)
  long long blocks;  // blocks of the row, ceil(l1 / 4)
};

__host__ __device__ inline Law law_of(long long n) {
  Law law;
  law.offset = front_pad(n) + kWindow * front_pad(cdiv(n, kWindow));
  law.l1 = cdiv(n, kL1Span);
  law.blocks = cdiv(law.l1, kWarps);
  return law;
}

// Scratch floats a row needs per sum: its level-1 sums and every level
// above them (a geometric series below 2 * l1 + 32).
__host__ __device__ inline long long scratch_slots(long long l1) {
  return 2 * l1 + kWindow;
}

// Levels 0 and 1 of the block's 4 level-1 windows for S sums at once.
// `squares(e, v)` writes the S squares of value e of the row, 0 outside
// [0, n). Lane 0 of warp w writes level-1 sum `first + w` (when it is
// below `l1`) to partials[(first + w) * S + s].
template <int S, class Squares>
__device__ __forceinline__ void level1_sums(const Squares& squares,
                                            const Law& law, long long first,
                                            float* __restrict__ partials) {
  __shared__ float tile[kWarps][S][kHalf][kWindow + 1];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long j = first + warp;
  const long long base = j * kL1Span - law.offset;
  float l0[2][S];  // lane k < 16: the sums of windows k and 16 + k
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll 8
    for (int k = 0; k < kHalf; ++k) {
      float v[S];
      squares(base + (long long)(h * kHalf + k) * kWindow + lane, v);
#pragma unroll
      for (int s = 0; s < S; ++s) tile[warp][s][k][lane] = v[s];
    }
    __syncwarp();
    const int row = lane % kHalf;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      float acc = 0.0f;
#pragma unroll 8
      for (int i = 0; i < kWindow; ++i) {
        acc = __fadd_rn(acc, tile[warp][s][row][i]);
      }
      l0[h][s] = acc;
    }
    __syncwarp();  // the tile is rewritten by the next half
  }
  // level 1: the 32 level-0 sums in order of window (lanes 0..15 hold
  // windows 0..15, then 16..31)
#pragma unroll
  for (int s = 0; s < S; ++s) {
    float t = 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int k = 0; k < kHalf; ++k) {
        t = __fadd_rn(t, __shfl_sync(kFullMask, l0[h][s], k));
      }
    }
    if (lane == 0 && j < law.l1) partials[j * S + s] = t;
  }
}

// Thread 0 counts the block done once every lane's writes are visible;
// returns, in every thread, whether this block was the row's last.
__device__ __forceinline__ bool block_done(unsigned* counter,
                                           long long blocks) {
  __shared__ unsigned done;
  __threadfence();  // this block's sums are visible before the count
  __syncthreads();
  if (threadIdx.x == 0) done = atomicAdd(counter, 1u);
  __syncthreads();
  return done == (unsigned)(blocks - 1);
}

// The levels from 2 up, in the row's last block: its l1 level-1 sums sit
// in partials[0, l1) (x S); each level's window sums are written after the
// previous level's. Thread 0 ends with the row's S totals in tot[] and
// resets the row's counter.
template <int S>
__device__ __forceinline__ void row_totals(float* partials, long long l1,
                                           unsigned* counter, float tot[S]) {
  long long m = l1, in = 0, out = l1;
  while (m > kWindow) {
    const long long windows = cdiv(m, kWindow), pad = front_pad(m);
    for (long long w = threadIdx.x; w < windows; w += kThreads) {
      float acc[S];
#pragma unroll
      for (int s = 0; s < S; ++s) acc[s] = 0.0f;
#pragma unroll 8
      for (int i = 0; i < kWindow; ++i) {
        const long long idx = w * kWindow + i - pad;
        const bool ok = idx >= 0 && idx < m;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          acc[s] = __fadd_rn(acc[s],
                             ok ? __ldcg(partials + (in + idx) * S + s) : 0.0f);
        }
      }
#pragma unroll
      for (int s = 0; s < S; ++s) partials[(out + w) * S + s] = acc[s];
    }
    __threadfence_block();
    __syncthreads();
    in = out;
    out += windows;
    m = windows;
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      float t = 0.0f;
      for (long long j = 0; j < m; ++j) {
        t = __fadd_rn(t, __ldcg(partials + (in + j) * S + s));
      }
      tot[s] = t;
    }
    *counter = 0u;
  }
}

// The flush's tap vector (obs/taps.py FLUSH_TAP_NAMES) from the five sums'
// totals (delta^2, upd^2, diff^2, err^2, q^2) and the K weights, in thread
// 0: correctly rounded roots, ||err|| / max(||diff||, 1e-30), the weights'
// sum in order of k and their minimum (zeros when k is 0).
__device__ inline void tap_vector(const float tot[5], const float* weights,
                                  int k, float* out) {
  float r[5];
#pragma unroll
  for (int s = 0; s < 5; ++s) r[s] = __fsqrt_rn(tot[s]);
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

}  // namespace taps
