// silu and its gradient by the reference's law, one launch each way; and
// XLA:CPU's exp alone (xla_exp), the cross-entropy's exp(a - m).
//
// No Pallas counterpart: the reference's silu is jax.nn.silu inside its
// jitted model, which XLA:CPU compiles (logistic expanded) as
//   s  = 1 / (1 + exp(-x))                      (add_divide fusion)
//   y  = x * s
//   gx = fma(g, s, (g * x) * (s * (1 - s)))      (the vjp, first product
//                                                 fused into the add)
// with its own f32 exp (Cephes' expf with XLA's clamps), and runs it with
// flush-to-zero and denormals-are-zero on: a subnormal operand reads as a
// zero of its sign and a subnormal result becomes one. The plain version
// is kernels/xla_math.py (exp, silu_fwd, silu_bwd, ftz); every operation
// here is the one it runs, as an _rn intrinsic (__fmaf_rn where XLA
// contracts a product into an add), built with -fmad=false and without
// -ftz, so the flush is spelled (ftz below) exactly where the plain
// version applies it.
//
// Forward:  x (n,) -> y (n,), f32.
// Backward: g, x (n,) -> gx (n,), f32; s is recomputed from x, the same
// bits as the forward's, so nothing but x is kept between the two.
// exp:      x (rows, cols), m (rows,) or none -> exp(x - m[row]) (rows,
// cols), f32: the subtraction rounded once, then xla_exp (no flush of
// the input, as xla_math.exp has none), so the cross-entropy's a - m is
// never a tensor of its own.
//
// Bound: bytes. Forward reads 4 and writes 4 B a value, backward reads 8
// and writes 4, exp reads 4 and writes 4; about 40 flops a value forward,
// 48 backward and 25 for exp are far under the card's f32 rate.
//
// Design: a grid-stride loop over float4 vectors when every pointer is on
// a 16-byte boundary, then one value a thread for the tail; any pointer off
// that boundary (a view that starts mid-vector) takes the scalar loop for
// the whole length. Indices are 64-bit.
#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ float ftz(float v) {
  return fabsf(v) < FLT_MIN ? copysignf(0.0f, v) : v;
}

// NaN passes both clamps, as torch.clamp passes it.
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  v = v < lo ? lo : v;
  return v > hi ? hi : v;
}

// XLA:CPU's f32 exp (xla_math.exp); the constants are its f32 values
// (-87.8, 88.8, log2(e), ln 2 in two parts, Cephes' polynomial), in hex.
__device__ __forceinline__ float xla_exp(float x) {
  x = clamp(x, -0x1.5f3334p+6f, 0x1.633334p+6f);
  float n = floorf(__fmaf_rn(x, 0x1.715476p+0f, 0.5f));
  n = clamp(n, -127.0f, 127.0f);
  float a = __fmaf_rn(n, -0x1.63p-1f, x);
  a = __fmaf_rn(n, 0x1.bd0106p-13f, a);
  float z = __fmaf_rn(a, 0x1.a0d2cep-13f, 0x1.6e879cp-10f);
  z = __fmaf_rn(z, a, 0x1.111210p-7f);
  z = __fmaf_rn(z, a, 0x1.555382p-5f);
  z = __fmaf_rn(z, a, 0x1.555554p-3f);
  z = __fmaf_rn(z, a, 0x1.0p-1f);
  z = __fadd_rn(__fmaf_rn(z, __fmul_rn(a, a), a), 1.0f);
  const float pow2 = __int_as_float((static_cast<int>(n) + 127) << 23);
  return ftz(__fmul_rn(z, pow2));
}

// s = 1 / (1 + exp(-x)) of a flushed x, flushed.
__device__ __forceinline__ float logistic(float x) {
  const float d = __fadd_rn(xla_exp(-x), 1.0f);
  return ftz(__fdiv_rn(1.0f, d));
}

__device__ __forceinline__ float fwd(float xin) {
  const float x = ftz(xin);
  return ftz(__fmul_rn(x, logistic(x)));
}

__device__ __forceinline__ float bwd(float gin, float xin) {
  const float g = ftz(gin);
  const float x = ftz(xin);
  const float s = logistic(x);
  const float u =
      ftz(__fmul_rn(ftz(__fmul_rn(g, x)), __fmul_rn(s, __fsub_rn(1.0f, s))));
  return ftz(__fmaf_rn(g, s, u));
}

__global__ void __launch_bounds__(kThreads)
silu_fwd_kernel(const float* __restrict__ x, float* __restrict__ y,
                long long n, int vec) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long nv = n / 4;
    for (long long v = i; v < nv; v += stride) {
      const float4 xv = reinterpret_cast<const float4*>(x)[v];
      reinterpret_cast<float4*>(y)[v] =
          make_float4(fwd(xv.x), fwd(xv.y), fwd(xv.z), fwd(xv.w));
    }
    done = nv * 4;
  }
  for (long long e = done + i; e < n; e += stride) {
    y[e] = fwd(x[e]);
  }
}

__global__ void __launch_bounds__(kThreads)
silu_bwd_kernel(const float* __restrict__ g, const float* __restrict__ x,
                float* __restrict__ gx, long long n, int vec) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long nv = n / 4;
    for (long long v = i; v < nv; v += stride) {
      const float4 gv = reinterpret_cast<const float4*>(g)[v];
      const float4 xv = reinterpret_cast<const float4*>(x)[v];
      reinterpret_cast<float4*>(gx)[v] =
          make_float4(bwd(gv.x, xv.x), bwd(gv.y, xv.y), bwd(gv.z, xv.z),
                      bwd(gv.w, xv.w));
    }
    done = nv * 4;
  }
  for (long long e = done + i; e < n; e += stride) {
    gx[e] = bwd(g[e], x[e]);
  }
}

// One row per blockIdx.y (striding by gridDim.y), its columns over the
// blocks of x; float4 vectors where the row starts on a 16-byte boundary.
__global__ void __launch_bounds__(kThreads)
xla_exp_kernel(const float* __restrict__ x, const float* __restrict__ m,
               float* __restrict__ out, long long rows, long long cols,
               int vec) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const float* xr = x + r * cols;
    float* outr = out + r * cols;
    long long done = 0;
    if (m != nullptr) {
      const float sub = m[r];
      if (vec) {
        const long long nv = cols / 4;
        for (long long v = i; v < nv; v += stride) {
          const float4 xv = reinterpret_cast<const float4*>(xr)[v];
          reinterpret_cast<float4*>(outr)[v] = make_float4(
              xla_exp(__fsub_rn(xv.x, sub)), xla_exp(__fsub_rn(xv.y, sub)),
              xla_exp(__fsub_rn(xv.z, sub)), xla_exp(__fsub_rn(xv.w, sub)));
        }
        done = nv * 4;
      }
      for (long long e = done + i; e < cols; e += stride) {
        outr[e] = xla_exp(__fsub_rn(xr[e], sub));
      }
    } else {
      if (vec) {
        const long long nv = cols / 4;
        for (long long v = i; v < nv; v += stride) {
          const float4 xv = reinterpret_cast<const float4*>(xr)[v];
          reinterpret_cast<float4*>(outr)[v] =
              make_float4(xla_exp(xv.x), xla_exp(xv.y), xla_exp(xv.z),
                          xla_exp(xv.w));
        }
        done = nv * 4;
      }
      for (long long e = done + i; e < cols; e += stride) {
        outr[e] = xla_exp(xr[e]);
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// mode == 0: a = x, out = y (b unused).
// mode == 1: a = g, b = x, out = gx.
// mode == 2: a = x (n / cols rows of cols), b = m (one value a row) or
//            null, out = exp(x - m); cols divides n.
extern "C" int silu(const float* a, const float* b, float* out, long long n,
                    int mode, long long cols, cudaStream_t stream) {
  if (n <= 0) return 0;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long most = static_cast<long long>(sms) * kBlocksPerSm;
  if (mode == 2) {
    if (cols <= 0 || n % cols) return static_cast<int>(cudaErrorInvalidValue);
    const long long rows = n / cols;
    const long long by = rows < 65535 ? rows : 65535;
    const long long want = (cols / 4 + kThreads - 1) / kThreads;
    long long bx = (most + by - 1) / by;
    bx = bx < want ? bx : want;
    bx = bx < 1 ? 1 : bx;
    const int vec = aligned16(a) && aligned16(out) && cols % 4 == 0;
    xla_exp_kernel<<<dim3(static_cast<unsigned>(bx), static_cast<unsigned>(by)),
                     kThreads, 0, stream>>>(a, b, out, rows, cols, vec);
    return static_cast<int>(cudaGetLastError());
  }
  const long long want = (n / 4 + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 1 ? 1 : (want < most ? want : most));
  if (mode == 1) {
    const int vec = aligned16(a) && aligned16(b) && aligned16(out);
    silu_bwd_kernel<<<blocks, kThreads, 0, stream>>>(a, b, out, n, vec);
  } else {
    const int vec = aligned16(a) && aligned16(out);
    silu_fwd_kernel<<<blocks, kThreads, 0, stream>>>(a, out, n, vec);
  }
  return static_cast<int>(cudaGetLastError());
}
