// Code-vector decode shared by the kernels that read packed qsgd codes
// (buffer_aggregate.cu, unpack_dequantize.cu).
//
// * A row is 128*bits/8 bytes of codes. A thread owns one code vector of
//   WORDS 32-bit words (128/bits codes at WORDS = 4) and reads it with one
//   load (ld.global.nc.v4 at WORDS = 4).
// * 16-byte vectors (WORDS = 4) when the grid has at least four blocks per
//   SM; below that (the CNN's 624 rows: 2,496 such threads on 132 SMs) each
//   thread's serial decode stream, not memory, sets the time, so a message
//   that small takes one word per thread and four times the threads.
// * sign*mag without a conversion instruction: a funnel shift puts the
//   magnitude bits under the constant 0x4B000000, the f32 2^23 + mag, and
//   subtracting 2^23 leaves mag exactly; OR-ing the sign bit in gives
//   (1 - 2*sign) * mag bit for bit, -0.0 included.
// * A thread's outputs are contiguous. A warp passes them through shared
//   memory (float4 slots XOR-swizzled, so neither the writes nor the reads
//   conflict on banks) and stores float4s lane after lane: each warp-wide
//   store covers whole 128-byte lines.
#pragma once

#include "qsgd_common.cuh"

namespace codevec {

constexpr int kWarps = 4;              // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kWideBlocksPerSm = 4;    // 16-byte vectors from this grid on

template <int BITS, int WORDS>
struct Vec {
  static constexpr int kCodes = 32 * WORDS / BITS;  // codes per thread
  static constexpr int kQuads = kCodes / 4;  // float4 outputs per thread
  // float4 slots per thread in one pass through shared memory
  static constexpr int kPass = kQuads < 8 ? kQuads : 8;
  static constexpr int kPerRow = 4 * BITS / WORDS;  // threads per row
};

// True when `rows` rows fill the card with 16-byte vectors (WORDS = 4),
// false when the kernel should take one word per thread (WORDS = 1).
template <int BITS>
inline bool use_wide(long long rows, int sms) {
  const long long wide_blocks =
      (rows * Vec<BITS, 4>::kPerRow + kThreads - 1) / kThreads;
  return wide_blocks >= (long long)kWideBlocksPerSm * sms;
}

template <int WORDS>
__device__ __forceinline__ void load_words(const uint32_t* __restrict__ p,
                                           uint32_t w[WORDS]) {
  if constexpr (WORDS == 4) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = q.x;
    w[1] = q.y;
    w[2] = q.z;
    w[3] = q.w;
  } else {
    w[0] = __ldg(p);
  }
}

// sign*mag of code c (a compile-time index after unrolling) of the words.
template <int BITS>
__device__ __forceinline__ float signed_mag(const uint32_t* w, int c) {
  const uint32_t word = w[c * BITS / 32];
  const int sh = c * BITS % 32;  // the code's bits: [sh, sh + BITS)
  // the magnitude to the top (the sign bit leaves), then under the exponent
  // of 2^23: (hi:lo) >> (33 - BITS) with hi << (BITS - 1) == 0x4B000000
  const uint32_t lo = word << (33 - BITS - sh);
  const uint32_t biased =
      __funnelshift_r(lo, 0x4B000000u >> (BITS - 1), 33 - BITS);
  const float mag = __fsub_rn(__uint_as_float(biased), 8388608.0f);
  const uint32_t sign = (word << (32 - BITS - sh)) & 0x80000000u;
  return __uint_as_float(__float_as_uint(mag) | sign);
}

// XOR swizzle of a thread's kPass float4 slots: any 8 consecutive lanes
// touch 8 distinct 16-byte bank groups, writing by owner or reading lane
// after lane.
template <int PASS>
__device__ __forceinline__ int swizzle(int owner) {
  return (owner / (8 / PASS)) % PASS;
}

// The warp's 32 threads' outputs (contiguous floats from thread `t0`'s
// first) to out, through `tile` (32 * kPass float4 of shared memory), in
// passes of kPass float4 per thread.
template <int BITS, int WORDS>
__device__ __forceinline__ void store_warp(
    const float acc[Vec<BITS, WORDS>::kCodes], float4* tile,
    float4* __restrict__ out, long long t0, long long threads, int lane) {
  using V = Vec<BITS, WORDS>;
#pragma unroll
  for (int p = 0; p < V::kQuads / V::kPass; ++p) {
#pragma unroll
    for (int f = 0; f < V::kPass; ++f) {
      const int c = 4 * (p * V::kPass + f);
      tile[lane * V::kPass + (f ^ swizzle<V::kPass>(lane))] =
          make_float4(acc[c], acc[c + 1], acc[c + 2], acc[c + 3]);
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < V::kPass; ++j) {
      const int slot = j * 32 + lane;
      const int owner = slot / V::kPass;
      const int f = slot % V::kPass;
      if (t0 + owner < threads) {
        out[(t0 + owner) * V::kQuads + p * V::kPass + f] =
            tile[owner * V::kPass + (f ^ swizzle<V::kPass>(owner))];
      }
    }
    __syncwarp();  // the tile is rewritten by the next pass
  }
}

}  // namespace codevec
