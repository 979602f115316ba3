"""XLA:CPU's f32 transcendental functions, spelled in elementwise torch ops.

The population engine draws its latencies and interarrivals through
``log``, ``log1p``, ``exp``, ``erfinv`` and ``ndtri``. torch's own versions
of these differ between its CPU and CUDA builds and from XLA's, so each is
written here as the sequence of correctly rounded operations XLA:CPU
compiles it to (jax 0.9, jitted): f32 adds, products, true divisions,
``ref.sqrt_f32`` and single-rounded multiply-adds (``_fma``) where
XLA contracts a product into an add. Every operation here rounds the same
way on both devices, so a draw has the same bits on the card and the CPU.

The laws, found by probing XLA's output and pinned by
``tests/test_torch_population.py``:

* ``log``: Cephes' ``logf`` as XLA emits it — the mantissa in
  [sqrt(1/2), sqrt(2)) minus one, the degree-8 polynomial as three
  interleaved Horner chains joined over x**3, every step a multiply-add,
  and the last product contracted with the exponent term:
  ``y = fma(y, x**3, e * q1)``; bit-exact with XLA.
* ``log1p``: Cephes' rational approximation for ``|x| < sqrt(2) - 1``
  (numerator and denominator in multiply-add Horner form from zero), else
  ``log(1 + x)``; bit-exact.
* ``exp``: Cephes' ``expf`` with XLA's clamps, ``n = floor(fma(x,
  log2(e), 1/2))``, the two-part reduction and the polynomial all as
  multiply-adds, scaled by ``2**n`` built from its bits, a subnormal
  result flushed to zero (``ftz``: below x = -87.34 the product falls
  under 2**-126); bit-exact.
* ``erfinv``: XLA's ``ErfInv`` for f32, Giles' two-branch polynomial on
  ``w = -log1p(-x*x)`` in multiply-add Horner form; bit-exact.
* ``ndtri``: jax's Cephes ``ndtri`` with XLA's rewrites — ``(a/b)/z`` as
  ``a/(b*z)``, ``log(sqrt(v))`` as ``0.5*log(v)``, ``w + (w*ww)*r`` as a
  multiply-add.

Over all 2**24 uniforms the counter hash can give, the poisson
interarrival, the half-normal and the lognormal (sigma 1 and 1.5)
durations built from these are XLA's bits.

XLA:CPU runs its compiled code with the x86 flush-to-zero and
denormals-are-zero modes on: an f32 operation reads a subnormal operand as
a zero of its sign and returns a zero of its sign for a subnormal result.
``ftz`` spells that flush; the functions here apply it where a subnormal
can arise in their domain.

``silu_fwd`` and ``silu_bwd`` are ``jax.nn.silu`` and its vjp as XLA:CPU
compiles them (``logistic`` expanded to ``1 / (1 + exp(-x))``, read from
the optimised HLO and LLVM IR): the plain version of the silu kernel
(``csrc/silu.cu``), which runs these operations one for one.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.ref import fma_f32, sqrt_f32


_TINY = float(np.finfo(np.float32).tiny)  # 2**-126, the least normal f32


def ftz(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's flush: a subnormal f32 value becomes a zero of its sign;
    every other value (zeros, normals, infinities, nan) is kept."""
    return torch.where(x.abs() < _TINY, x * 0.0, x)


def _f(v: float) -> float:
    """A constant rounded to f32, as a Python float (exact in either
    device's f32 arithmetic)."""
    return float(np.float32(v))


_MID_MASK, _MID = (1 << 29) - 1, 1 << 28  # a float64 on an f32 midpoint


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """Single-rounded f32 ``a*b + c`` (``b`` and ``c`` f32 tensors of
    ``a``'s shape or f32 values), equal to ``ref.fma_f32``. On the CPU the
    float64 sum of the exact product is rounded to f32 once, which is the
    single rounding unless that sum lies on an f32 midpoint or under
    2**-126 (a second rounding could then move it); those few values, and
    a CUDA tensor whole, go through ``fma_f32``."""
    if a.device.type != "cpu":
        if not isinstance(c, torch.Tensor):
            c = torch.full_like(a, c)
        return fma_f32(a, b, c)
    f64 = lambda v: v.to(torch.float64) if isinstance(v, torch.Tensor) \
        else float(v)
    s = a.to(torch.float64) * f64(b) + f64(c)
    r = s.to(torch.float32)
    suspect = (((s.view(torch.int64) & _MID_MASK) == _MID)
               | ((s.abs() < _TINY) & (s != 0)))
    if bool(suspect.any()):
        at = lambda v: v[suspect] if isinstance(v, torch.Tensor) \
            else torch.full_like(r[suspect], v)
        r[suspect] = fma_f32(a[suspect], at(b), at(c))
    return r


def _horner(x: torch.Tensor, coeffs) -> torch.Tensor:
    """``((c0*x + c1)*x + ...)`` from zero, every step a multiply-add (the
    first one gives c0 exactly)."""
    y = torch.full_like(x, _f(coeffs[0]))
    for c in coeffs[1:]:
        y = _fma(y, x, _f(c))
    return y


_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)


def log(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's f32 ``log`` of positive normal f32 values."""
    b = x.view(torch.int32)
    e = ((b >> 23) & 0xFF) - 126
    m = ((b & 0x7FFFFF) | (126 << 23)).view(torch.float32)  # [0.5, 1)
    small = m < _f(0.707106781186547524)
    m = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    e = (e - small.to(torch.int32)).to(torch.float32)
    x2 = m * m
    x3 = x2 * m
    p = _LOG_P
    y = _fma(m, _f(p[0]), _f(p[1]))
    y1 = _fma(m, _f(p[3]), _f(p[4]))
    y2 = _fma(m, _f(p[6]), _f(p[7]))
    y = _fma(y, m, _f(p[2]))
    y1 = _fma(y1, m, _f(p[5]))
    y2 = _fma(y2, m, _f(p[8]))
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, e * _f(-2.12194440e-4))
    m = m - x2 * 0.5
    m = m + y
    return m + e * _f(0.693359375)


_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192198385e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's f32 ``log1p`` of f32 values in (-1, 1]."""
    large = log(x + 1.0)
    x2 = x * x
    small = _horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN)
    small = x + (x2 * -0.5 + (x * x2) * small)
    return torch.where(x.abs() < _f(0.41421356237309504880), small, large)


_EXP_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
          4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)


def exp(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's f32 ``exp``."""
    x = torch.clamp(x, _f(-87.8), _f(88.8))
    n = torch.floor(_fma(x, _f(1.44269504088896341), 0.5))
    n = torch.clamp(n, -127.0, 127.0)
    a = _fma(n, _f(-0.693359375), x)
    a = _fma(n, _f(2.12194440e-4), a)
    z = _fma(a, _f(_EXP_P[0]), _f(_EXP_P[1]))
    for c in _EXP_P[2:]:
        z = _fma(z, a, _f(c))
    z = _fma(z, a * a, a) + 1.0
    pow2 = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return ftz(z * pow2)


def _logistic(x: torch.Tensor) -> torch.Tensor:
    """``s = 1 / (1 + exp(-x))`` of flushed f32 ``x`` (``exp`` above, a
    true division), flushed: 0 where it would be under 2**-126, for x
    below -87.34."""
    d = exp(-x) + 1.0
    return ftz(torch.ones_like(d) / d)


def silu_fwd(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's ``jax.nn.silu`` of f32 ``x``: ``y = x * s``, ``s`` the
    logistic (``_logistic``), with the flush (``ftz``) on the input and
    wherever a subnormal can arise: ``s``, and ``y`` of a small x."""
    x = ftz(x)
    return ftz(x * _logistic(x))


def silu_bwd(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's vjp of ``jax.nn.silu`` for cotangent ``g`` at ``x``:
    ``fma(g, s, (g * x) * (s * (1 - s)))``, the first product fused into
    the add, ``s`` recomputed as the forward takes it (the same bits),
    with the flush on the inputs and on every product that can be
    subnormal (``s * (1 - s)`` cannot: ``s`` is 0 or at least 2**-126 and
    ``1 - s`` 0 or at least 2**-24)."""
    g, x = ftz(g), ftz(x)
    s = _logistic(x)
    u = ftz(ftz(g * x) * (s * (1 - s)))
    return ftz(_fma(g, s, u))


_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``ErfInv`` (Giles' single-precision approximation) of
    values in [-1, 1]."""
    w = 0.0 - log1p(0.0 - x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, sqrt_f32(w) - 3.0)
    p = None
    for a, b in zip(_ERFINV_LT5, _ERFINV_GE5):
        c = torch.where(lt, torch.full_like(x, _f(a)),
                        torch.full_like(x, _f(b)))
        p = c if p is None else _fma(p, w, c)
    big = torch.full_like(x, float(np.finfo(np.float32).max))
    return torch.where(x.abs() == 1.0, x * big, p * x)


# jax.scipy.special.ndtri's Cephes coefficients (float32)
_NDTRI_P0 = (-5.99633501014107895267e1, 9.80010754185999661536e1,
             -5.66762857469070293439e1, 1.39312609387279679503e1,
             -1.23916583867381258016e0)
_NDTRI_Q0 = (1.0, 1.95448858338141759834e0, 4.67627912898881538453e0,
             8.63602421390890590575e1, -2.25462687854119370527e2,
             2.00260212380060660359e2, -8.20372256168333339912e1,
             1.59056225126211695515e1, -1.18331621121330003142e0)
_NDTRI_P1 = (4.05544892305962419923e0, 3.15251094599893866154e1,
             5.71628192246421288162e1, 4.40805073893200834700e1,
             1.46849561928858024014e1, 2.18663306850790267539e0,
             -1.40256079171354495875e-1, -3.50424626827848203418e-2,
             -8.57456785154685413611e-4)
_NDTRI_Q1 = (1.0, 1.57799883256466749731e1, 4.53907635128879210584e1,
             4.13172038254672030440e1, 1.50425385692907503408e1,
             2.50464946208309415979e0, -1.42182922854787788574e-1,
             -3.80806407691578277194e-2, -9.33259480895457427372e-4)
_NDTRI_P2 = (3.23774891776946035970e0, 6.91522889068984211695e0,
             3.93881025292474443415e0, 1.33303460815807542389e0,
             2.01485389549179081538e-1, 1.23716634817820021358e-2,
             3.01581553508235416007e-4, 2.65806974686737550832e-6,
             6.23974539184983293730e-9)
_NDTRI_Q2 = (1.0, 6.02427039364742014255e0, 3.67983563856160859403e0,
             1.37702099489081330271e0, 2.16236993594496635890e-1,
             1.34204006088543189037e-2, 3.28014464682127739104e-4,
             2.89247864745380683936e-6, 6.79019408009981274425e-9)


def ndtri(p: torch.Tensor) -> torch.Tensor:
    """jax's f32 ``ndtri`` (inverse normal CDF) of values in [0, 1], as
    XLA:CPU compiles it inside a jit."""
    mcp = torch.where(p > _f(-np.expm1(-2.0)), 1.0 - p, p)
    s = torch.where(mcp == 0.0, torch.full_like(p, 0.5), mcp)
    w = s - 0.5
    ww = w * w
    r = _horner(ww, _NDTRI_P0) / _horner(ww, _NDTRI_Q0)
    big = _fma(w * ww, r, w) * _f(-np.sqrt(2.0 * np.pi))
    v = log(s) * -2.0
    z = sqrt_f32(v)
    first = z - (log(v) * 0.5) / z
    iz = torch.ones_like(z) / z
    tail_small = _horner(iz, _NDTRI_P2) / (_horner(iz, _NDTRI_Q2) * z)
    tail = _horner(iz, _NDTRI_P1) / (_horner(iz, _NDTRI_Q1) * z)
    x = torch.where(s > _f(np.exp(-2.0)), big,
                    torch.where(z >= 8.0, first - tail_small, first - tail))
    x = torch.where(p > _f(1.0 - np.exp(-2.0)), x, -x)
    inf = torch.full_like(x, float("inf"))
    return torch.where(p == 0.0, -inf, torch.where(p == 1.0, inf, x))
