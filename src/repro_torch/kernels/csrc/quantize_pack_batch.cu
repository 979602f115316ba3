// Batched qsgd quantize + pack with an in-kernel counter-hash dither.
//
// Replaces the TPU kernel repro/kernels/qsgd.py::qsgd_quantize_pack_batch
// (_quantize_pack_batch_kernel, _hash_uniform).
//
// In:  x f32, B messages of n elements each, message b at x + b*stride
//      (stride = n for a flat (B, n) stack, rows*128 for (B, rows, 128));
//      the seed words (B, 2) uint32, by value up to kSeedsByValue messages,
//      above that from a device buffer.
// Out: packed uint8 (B, rows, 128*bits/8), norms f32 (B, rows), with
//      rows = ceil(n / 128): the lanes past n read as zeros (zero codes,
//      whatever their dither), so a ragged message needs no padding pass.
//
// The dither of element (row, lane) of message b is two murmur3 fmix32
// rounds of (seeds[b], element index (row0 + row)*128 + lane mod 2^32), top
// 24 bits times 2^-24, in native uint32 arithmetic: the same law as the
// reference (its row_offset), so a message's codes depend neither on the
// batch nor on the tiling or grid, and rows [row0, row0 + rows) of a longer
// message encode exactly as those rows of the whole (the row-chunked
// streaming encode).
//
// Bound: the larger of bytes and integer issue. Bytes: 4 B of x per
// element plus rows*(16*bits + 4) out (d = 1e8, qsgd4: 0.45 GB, 0.135 ms at
// 3.35 TB/s). Integer work: the hash is two fmix32 rounds per element.
// chip_smoke.py counts it at each run as the int32 SASS of this kernel less
// that of a build with QSGD_BATCH_CONSTANT_DITHER (the same kernel with a
// constant dither), over the 32 elements a thread quantizes per loop pass,
// by pipe: IMAD on the FMA pipe, the other int32 instructions on the int32
// ALU, each 64 lanes per SM per clock. The larger pipe's share stays under
// the byte bound at d = 1e8: the bytes bound the kernel.
//
// Design, against that bound:
// * Four threads per row, one per norm partial: thread w of a row owns
//   lanes 32w..32w+31, sums their squares in order (the reference's own
//   partial), and four shuffles give every thread of the row p0..p3 for
//   the same ((p0+p1)+p2)+p3, square root and division. No lane idles and
//   no square goes through shared memory.
// * A warp quantizes a tile of 8 rows. The tile arrives in shared memory by
//   cp.async: lane l copies 16 bytes of each of the 8 rows, so each copy
//   instruction reads one whole 512-byte row (coalesced), and the 16-byte
//   slots are XOR-swizzled so that a thread reading its own 128 contiguous
//   bytes back conflicts on no bank. Ragged or unaligned rows (a flat
//   message whose length is no multiple of 4) copy 4 bytes at a time with
//   zero fill; messages of whole aligned rows take a kernel without that
//   path, 8% faster at d = 1e8 than the general one (PERF.md).
// * A persistent grid, one grid row per message (no division to find a
//   row's message; its seed words are read once): each warp walks its
//   message's tiles with kStages buffers, the copies of the next two tiles
//   in flight while it encodes the current one, so the loads never wait on
//   a row's norm-encode-store chain.
// * A thread's 32 codes leave as one 16-byte store at 4 bits (two at 8
//   bits, one 8-byte store at 2 bits): a warp writes its 8 rows' codes
//   contiguously, and the first thread of each row writes the norm.
#include "qsgd_common.cuh"

constexpr int kSeedsByValue = 64;  // messages whose seeds ride by value

// The by-value seed parameter, words 2b and 2b+1 message b's (outside the
// anonymous namespace: the C entry point takes it). Must match
// repro_torch/kernels/_build.py::SeedWords.
struct SeedWords {
  uint32_t w[2 * kSeedsByValue];
};

namespace {

constexpr int kWarps = 4;             // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 3;            // tile buffers per warp
constexpr int kBlocksPerSm = 4;       // 4 x 48 KB of shared memory
constexpr int kTileRows = 8;          // rows per warp tile
constexpr int kTileQuads = kTileRows * 32;  // float4 slots per tile

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float hash_uniform(uint32_t seed0, uint32_t seed1,
                                              uint32_t idx) {
#ifdef QSGD_BATCH_CONSTANT_DITHER  // the baseline of the hash's SASS count
  return 0.5f;
#else
  uint32_t h = fmix32(idx * 0x9E3779B9u + seed0);
  h = fmix32(h ^ seed1);
  return __fmul_rn((float)(h >> 8), 5.9604644775390625e-08f);  // 2^-24
#endif
}

// Slot of float4 j of thread t's 32 lanes in a tile: any 8 consecutive
// threads reading their float4 j, or any 8 consecutive lanes copying one
// row, touch 8 distinct 16-byte bank groups.
__device__ __forceinline__ int slot(int t, int j) {
  return 8 * t + (j ^ (t & 7));
}

__device__ __forceinline__ void cp_async16(float4* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// 4 bytes from src, or zeros when `bytes` is 0 (src is then not read).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One message of the batch: n elements from x, rows = ceil(n/128) rows of
// codes and norms out, its seed words, and whether its start is 16-byte
// aligned (the wrapper checks the base; a flat message's start need not be).
struct Msg {
  const float* x;
  long long n, rows, row0;
  uint8_t* packed;
  float* norms;
  uint32_t seed0, seed1;
  bool aligned;
};

// Lane `lane`'s copies of tile `tile` into `buf` (none past the last row).
// kWhole: every row of the message is whole and 16-byte aligned.
template <bool kWhole>
__device__ __forceinline__ void issue_tile(const Msg& m, long long tile,
                                           float4* buf, int lane) {
#pragma unroll
  for (int i = 0; i < kTileRows; ++i) {
    const long long r = tile * kTileRows + i;
    if (r >= m.rows) break;
    const long long e0 = r * qsgd::kLanes + 4 * lane;
    float4* dst = buf + slot(4 * i + lane / 8, lane % 8);
    if (kWhole || (m.aligned && e0 + 4 <= m.n)) {
      cp_async16(dst, m.x + e0);
    } else {  // the ragged last row, or an unaligned message
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = e0 + e < m.n;
        cp_async4(reinterpret_cast<float*>(dst) + e, in ? m.x + e0 + e : m.x,
                  in ? 4 : 0);
      }
    }
  }
}

template <int BITS>
__device__ __forceinline__ void store_codes(uint8_t* p, const uint32_t* w) {
  if constexpr (BITS == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
#pragma unroll
    for (int k = 0; k < BITS / 4; ++k) {
      reinterpret_cast<uint4*>(p)[k] =
          make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
    }
  }
}

// Quantize + pack the tile in `buf`: this thread is partial w = lane % 4 of
// tile row lane / 4.
template <int BITS>
__device__ __forceinline__ void quantize_tile(const Msg& m, long long tile,
                                              const float4* buf, int lane) {
  float v[32];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 q = buf[slot(lane, j)];
    v[4 * j] = q.x;
    v[4 * j + 1] = q.y;
    v[4 * j + 2] = q.z;
    v[4 * j + 3] = q.w;
  }
  float partial = 0.0f;
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    partial = __fadd_rn(partial, __fmul_rn(v[e], v[e]));
  }
  const int first = lane & ~3;
  const float p0 = __shfl_sync(qsgd::kFullMask, partial, first);
  const float p1 = __shfl_sync(qsgd::kFullMask, partial, first + 1);
  const float p2 = __shfl_sync(qsgd::kFullMask, partial, first + 2);
  const float p3 = __shfl_sync(qsgd::kFullMask, partial, first + 3);
  const long long r = tile * kTileRows + lane / 4;
  if (r >= m.rows) return;
  const float norm =
      __fsqrt_rn(__fadd_rn(__fadd_rn(__fadd_rn(p0, p1), p2), p3));
  const float s = qsgd::levels(BITS);
  const float inv = norm > 0.0f ? __fdiv_rn(s, fmaxf(norm, 1e-30f)) : 0.0f;
  const int w = lane & 3;
  const uint32_t idx0 =
      (uint32_t)(m.row0 + r) * (uint32_t)qsgd::kLanes + 32u * w;
  uint32_t words[BITS] = {};
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const uint32_t code = qsgd::encode(
        v[e], inv, hash_uniform(m.seed0, m.seed1, idx0 + e), BITS, s);
    words[e * BITS / 32] |= code << (e * BITS % 32);
  }
  store_codes<BITS>(m.packed + r * (16 * BITS) + w * (4 * BITS), words);
  if (w == 0) m.norms[r] = norm;
}

// Block (i, b) works on message b; its warps walk the message's 8-row tiles
// with stride gridDim.x * kWarps. One loop issues each tile's copies
// kStages - 1 iterations before it quantizes the tile, so the loop body is
// the kernel's only copy of the copy and encode code.
template <int BITS, bool kWhole>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    quantize_pack_batch_kernel(const float* __restrict__ x, long long n,
                               long long stride, long long row0,
                               const __grid_constant__ SeedWords seeds,
                               const uint32_t* __restrict__ seeds_dev,
                               uint8_t* __restrict__ packed,
                               float* __restrict__ norms) {
  __shared__ float4 bufs[kWarps][kStages][kTileQuads];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long b = blockIdx.y;
  const long long rows = (n + qsgd::kLanes - 1) / qsgd::kLanes;
  const Msg m{x + b * stride,
              n,
              rows,
              row0,
              packed + b * rows * (16 * BITS),
              norms + b * rows,
              seeds_dev ? seeds_dev[2 * b] : seeds.w[2 * b],
              seeds_dev ? seeds_dev[2 * b + 1] : seeds.w[2 * b + 1],
              ((b * stride) & 3) == 0};
  const long long tiles = (rows + kTileRows - 1) / kTileRows;
  const long long step = (long long)gridDim.x * kWarps;
  const long long first = (long long)blockIdx.x * kWarps + warp;
  int fill = 0, use = 0;  // buffers the next copy and the next encode take
#pragma unroll 1
  for (long long k = 1 - kStages; first + k * step < tiles; ++k) {
    issue_tile<kWhole>(m, first + (k + kStages - 1) * step,
                       bufs[warp][fill], lane);
    cp_async_commit();
    fill = fill + 1 == kStages ? 0 : fill + 1;
    if (k < 0) continue;
    cp_async_wait<kStages - 1>();  // this thread's copies of the tile landed
    __syncwarp();                  // and every lane's
    quantize_tile<BITS>(m, first + k * step, bufs[warp][use], lane);
    __syncwarp();  // all lanes read the buffer before it is refilled
    use = use + 1 == kStages ? 0 : use + 1;
  }
  cp_async_wait<0>();  // no copy outlives the block
}

template <int BITS>
void launch(const float* x, long long n, long long stride, long long row0,
            long long batch, const SeedWords& seeds, const uint32_t* seeds_dev,
            uint8_t* packed, float* norms, int sms, cudaStream_t stream) {
  const long long rows = (n + qsgd::kLanes - 1) / qsgd::kLanes;
  const long long tiles = (rows + kTileRows - 1) / kTileRows;
  // as many blocks per message as its tiles need, and together no more
  // than the card holds at once
  const long long resident = (long long)kBlocksPerSm * sms;
  const long long per_msg = (resident + batch - 1) / batch;
  const long long wanted = (tiles + kWarps - 1) / kWarps;
  const dim3 grid((unsigned)(wanted < per_msg ? wanted : per_msg),
                  (unsigned)batch);
  if (n % qsgd::kLanes == 0 && stride % 4 == 0) {
    quantize_pack_batch_kernel<BITS, true><<<grid, kThreads, 0, stream>>>(
        x, n, stride, row0, seeds, seeds_dev, packed, norms);
  } else {
    quantize_pack_batch_kernel<BITS, false><<<grid, kThreads, 0, stream>>>(
        x, n, stride, row0, seeds, seeds_dev, packed, norms);
  }
}

}  // namespace

extern "C" int qsgd_quantize_pack_batch(const void* x, long long n,
                                        long long stride, long long row0,
                                        long long batch,
                                        int bits, SeedWords seeds,
                                        const void* seeds_dev, void* packed,
                                        void* norms, void* stream) {
  if ((seeds_dev == nullptr && batch > kSeedsByValue) || batch > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  int sms = 0;
  const cudaError_t err = qsgd::sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const auto xf = (const float*)x;
  const auto sd = (const uint32_t*)seeds_dev;
  const auto p = (uint8_t*)packed;
  const auto o = (float*)norms;
  const auto s = (cudaStream_t)stream;
  switch (bits) {
    case 2: launch<2>(xf, n, stride, row0, batch, seeds, sd, p, o, sms, s); break;
    case 4: launch<4>(xf, n, stride, row0, batch, seeds, sd, p, o, sms, s); break;
    case 8: launch<8>(xf, n, stride, row0, batch, seeds, sd, p, o, sms, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
