// The uploads' metric taps: two scalars per message of a client step's
// (b, d) delta stack, in one launch.
//
// No TPU kernel: the JAX reference computes these taps in XLA inside its
// fused cohort step (repro/obs/taps.py::cohort_tap_rows, with the wire bits
// decoded by decode_qsgd_stack). The port takes them in a kernel of its own
// so that each message's reduction order depends on d alone
// (tap_reduce.cuh): a member's tap does not depend on the cohort it was
// batched with, and the card equals the CPU bit for bit.
//
// In:  deltas f32 (b, d); for qsgd uploads their packed codes uint8
//      (b, rows, 16*bits) and norms f32 (b, rows), rows = ceil(d/128);
//      bits 0 for identity uploads, whose wire is the delta itself.
// Out: f32 (b, 2): per message i, [||delta_i||,
//      ||delta_i - qdq(delta_i)|| / max(||delta_i||, 1e-30)] — 0 for
//      identity, and 0, not NaN, for a zero delta.
//
// qdq is the receiver's decode, the law of unpack_dequantize.cu (K3):
// (sign*mag) * (norm * fl32(1/s)); the decoded values never reach memory.
//
// Bound: bytes. It reads the deltas once, the codes and the norms once:
// B = 32 over the CNN's 624 rows, qsgd4 11,577,600 B (3.46 us at
// 3.35 TB/s); B = 8 at d = 1e8, 3.625 GB (1.08 ms) — what K2 reads.
//
// Design: a simple first kernel. One block of 256 threads per 4,096-element
// chunk of a message (32 wire rows); thread t always holds lane t % 128 of
// its wire rows. It issues all its loads first (16 values, the 16 code
// bytes that hold their codes and their rows' norms; a warp's 32 elements
// share one row), then decodes, squares the errors and sums in order.
#include "qsgd_common.cuh"
#include "tap_reduce.cuh"

namespace {

using taps::kThreads;
constexpr int kSums = 2;

template <int BITS>  // 0: identity uploads, no codes
__global__ void __launch_bounds__(kThreads)
    upload_taps_kernel(const float* __restrict__ deltas,
                       const uint8_t* __restrict__ packed,
                       const float* __restrict__ norms, long long d,
                       long long chunks, float* partials, unsigned* counters,
                       float* __restrict__ out) {
  __shared__ float scratch[kSums][kThreads];
  const long long row = blockIdx.x / chunks;
  const long long c = blockIdx.x % chunks;
  const float* x = deltas + row * d;
  const long long wire_rows = (d + qsgd::kLanes - 1) / qsgd::kLanes;
  const long long e0 = c * taps::kChunk + threadIdx.x;
  const int lane = threadIdx.x % qsgd::kLanes;  // kChunk, kThreads: x128
  // all loads first, then the in-order sums; past d a value, its code and
  // its norm are 0, so its square and its error add +0 and change no sum
  float v[taps::kPerThread];
  uint32_t byte[taps::kPerThread];
  float nm[taps::kPerThread];
#pragma unroll
  for (int i = 0; i < taps::kPerThread; ++i) {
    const long long e = e0 + (long long)i * kThreads;
    const bool in = e < d;
    v[i] = in ? __ldg(x + e) : 0.0f;
    if constexpr (BITS > 0) {
      const long long r = row * wire_rows + e / qsgd::kLanes;
      byte[i] = in ? __ldg(packed + r * (16 * BITS) + lane * BITS / 8) : 0u;
      nm[i] = in ? __ldg(norms + r) : 0.0f;
    }
  }
  float acc[kSums] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < taps::kPerThread; ++i) {
    acc[0] = __fadd_rn(acc[0], __fmul_rn(v[i], v[i]));
    if constexpr (BITS > 0) {
      const uint32_t code =
          (byte[i] >> (lane * BITS % 8)) & ((1u << BITS) - 1u);
      const float mag = (float)(code & ((1u << (BITS - 1)) - 1u));
      const float sm = (code >> (BITS - 1)) ? -mag : mag;
      const float scale =
          __fmul_rn(nm[i], __frcp_rn(qsgd::levels(BITS)));
      const float err = __fsub_rn(v[i], __fmul_rn(sm, scale));
      acc[1] = __fadd_rn(acc[1], __fmul_rn(err, err));
    }
  }
  taps::block_tree<kSums>(acc, scratch);
  float* row_partials = partials + row * chunks * kSums;
  if (!taps::partials_done<kSums>(acc, row_partials + c * kSums,
                                  counters + row, chunks)) {
    return;
  }
  float tot[kSums];
  taps::row_totals<kSums>(row_partials, chunks, counters + row, scratch, tot);
  if (threadIdx.x != 0) return;
  const float dn = __fsqrt_rn(tot[0]);
  out[2 * row] = dn;
  out[2 * row + 1] = __fdiv_rn(__fsqrt_rn(tot[1]), fmaxf(dn, 1e-30f));
}

template <int BITS>
void launch(const float* deltas, const uint8_t* packed, const float* norms,
            long long b, long long d, long long chunks, float* partials,
            unsigned* counters, float* out, cudaStream_t stream) {
  upload_taps_kernel<BITS><<<(unsigned)(b * chunks), kThreads, 0, stream>>>(
      deltas, packed, norms, d, chunks, partials, counters, out);
}

}  // namespace

// bits 0 (identity; packed and norms may be null), 2, 4 or 8. `partials`
// holds b*chunks*2 floats, chunks = ceil(d / 4096); `counters` holds b
// unsigned that are 0 between launches.
extern "C" int upload_taps(const void* deltas, const void* packed,
                           const void* norms, long long b, long long d,
                           int bits, void* partials, void* counters,
                           void* out, void* stream) {
  if (b <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  const long long chunks = (d + taps::kChunk - 1) / taps::kChunk;
  if (b * chunks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (bits != 0 && (packed == nullptr || norms == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const auto x = (const float*)deltas;
  const auto p = (const uint8_t*)packed;
  const auto nm = (const float*)norms;
  const auto pt = (float*)partials;
  const auto ct = (unsigned*)counters;
  const auto o = (float*)out;
  const auto s = (cudaStream_t)stream;
  switch (bits) {
    case 0: launch<0>(x, p, nm, b, d, chunks, pt, ct, o, s); break;
    case 2: launch<2>(x, p, nm, b, d, chunks, pt, ct, o, s); break;
    case 4: launch<4>(x, p, nm, b, d, chunks, pt, ct, o, s); break;
    case 8: launch<8>(x, p, nm, b, d, chunks, pt, ct, o, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
