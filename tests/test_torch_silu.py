"""The port's silu (``models.layers.silu``) against the reference's
``jax.nn.silu``, on the CPU in f32.

The law, read from XLA:CPU's optimised HLO and LLVM IR: the forward is
``x * s``, ``s = logistic(x) = 1 / (1 + exp(-x))`` with XLA's own ``exp``;
the gradient is the transpose of ``x * logistic(x)`` with ``logistic``'s
jvp ``g * (ans * (1 - ans))``, the first product fused into the add:
``fma(g, s, (g * x) * (s * (1 - s)))``. XLA:CPU runs it with
flush-to-zero and denormals-are-zero on, so ``s`` is 0 where ``1 / (1 +
exp(-x))`` would be subnormal (x in [-88.72, -87.34]) and ``exp`` is 0
where its result would be. With jax's own ``s`` the law is the
reference's bit for bit, eager and jitted (the witness below); the port's
plain version (``kernels.xla_math.silu_fwd`` / ``silu_bwd``, the CPU path
of the silu kernel) spells it whole and is the reference's bit for bit,
on N(0, 16) inputs, on the tail and on the special values. Its one
backward serves ``torch.autograd.grad`` (the round with remat) and
``torch.func`` (without) alike, and a silu model's loss gradient is the
same both ways; every silu of the models takes it, the MoE experts'
too.

The cross-entropy's ``layers.logsumexp`` is ``jax.nn.logsumexp`` as
XLA:CPU compiles it (``log(sum(exp(a - m))) + m`` with XLA's ``exp`` and
its flush, the sum in law 7's windows of 32, XLA's ``log``; the gradient
``(g / sum) * exp(a - m)``), bit for bit, its vjp too, on every gradient
path.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.common.tree import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.kernels import xla_math
from repro_torch.kernels.ref import fma_f32
from repro_torch.models import layers
from repro_torch.models import transformer as TT
from test_torch_archs import one_thread  # noqa: F401
from test_torch_moe import moe_model

N = 1 << 18
# every value and every gradient bit-equal to jax.nn.silu's (2^18 values of
# N(0, 16), seeds 0 and 1; torch.sigmoid's s gave 99.63-99.69%)
FORWARD_EQUAL_FLOOR, GRADIENT_EQUAL_FLOOR = 1.0, 1.0
# where 1 / (1 + exp(-x)) is subnormal, which XLA:CPU flushes to zero
TAIL = (-88.8, -87.3)
SPECIAL = np.array([0.0, -0.0, 1e-40, -1e-40, 1.4e-45, -1.4e-45, 1.1e-38,
                    -1.1e-38, 1.2e-38, 2e-38, -2e-38, np.inf, -np.inf,
                    np.nan, 1e-30, -1e-30, 87.5, 88.5, 89.0, -87.5, -88.5,
                    -89.0, 100.0, -100.0, 3.4e38, -3.4e38], np.float32)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = (4 * rng.standard_normal(N)).astype(np.float32)
    g = rng.standard_normal(N).astype(np.float32)
    return x, g


def _jax_silu_and_vjp(x, g, jit):
    def f(x, g):
        y, vjp = jax.vjp(jax.nn.silu, x)
        return y, vjp(g)[0]
    f = jax.jit(f) if jit else f
    y, gx = f(jnp.asarray(x), jnp.asarray(g))
    return np.asarray(y), np.asarray(gx)


def _bits(a) -> np.ndarray:
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32)


def _same(a, b) -> np.ndarray:
    """Elementwise: the same bits, or both nan."""
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return (a.view(np.int32) == b.view(np.int32)) | (np.isnan(a)
                                                     & np.isnan(b))


@pytest.mark.parametrize("jit", (False, True))
def test_law_is_the_reference_with_its_logistic(jit):
    """With jax's own ``jax.nn.sigmoid`` values as ``s``, ``x * s`` and
    ``fma(g, s, (g * x) * (s * (1 - s)))`` are jax's silu and its vjp bit
    for bit, eager and jitted."""
    x, g = _inputs(0)
    want_y, want_g = _jax_silu_and_vjp(x, g, jit)
    s = torch.from_numpy(np.asarray(jax.nn.sigmoid(jnp.asarray(x))))
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    assert np.array_equal(_bits(xt * s), _bits(want_y))
    got = fma_f32(gt, s, (gt * xt) * (s * (1 - s)))
    assert np.array_equal(_bits(got), _bits(want_g))


@pytest.mark.parametrize("seed", (0, 1))
def test_port_silu_against_the_reference(seed):
    """The port's silu and its gradient against ``jax.nn.silu``'s, jitted
    (the eager ones are the same bits): every value bit-equal."""
    x, g = _inputs(seed)
    want_y, want_g = _jax_silu_and_vjp(x, g, jit=True)
    xt = torch.from_numpy(x).requires_grad_()
    y = layers.silu(xt)
    (gx,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
    fwd = float(np.mean(_bits(y) == _bits(want_y)))
    grad = float(np.mean(_bits(gx) == _bits(want_g)))
    print(f"seed {seed}: silu bit-equal {fwd:.4%}, gradient {grad:.4%}")
    assert fwd >= FORWARD_EQUAL_FLOOR and grad >= GRADIENT_EQUAL_FLOOR


@pytest.mark.parametrize("where", ("tail", "special"))
def test_port_silu_on_the_tail_and_special_values(where):
    """On the tail [-88.8, -87.3] (``s`` flushed to zero from -87.34 down)
    and on zeros, subnormals, the normals next to 2^-126, infinities, nan
    and the clamps of ``exp``, with subnormal and tiny cotangents too: the
    port's silu and gradient are jax's jitted ones bit for bit (a nan as
    a nan)."""
    rng = np.random.default_rng(7)
    if where == "tail":
        x = rng.uniform(*TAIL, size=1 << 16).astype(np.float32)
        g = rng.standard_normal(x.size).astype(np.float32)
    else:
        x = np.repeat(SPECIAL, 4)
        g = np.tile(np.array([1.0, -3.0, 1e-40, 1e-30], np.float32),
                    SPECIAL.size)
    want_y, want_g = _jax_silu_and_vjp(x, g, jit=True)
    xt = torch.from_numpy(x).requires_grad_()
    y = layers.silu(xt)
    (gx,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
    assert _same(y, want_y).all(), x[~_same(y, want_y)][:8]
    assert _same(gx, want_g).all(), x[~_same(gx, want_g)][:8]


def test_exp_is_xlas_at_its_subnormal_tail():
    """``xla_math.exp`` against the jitted ``jnp.exp`` over [-90, 90],
    where XLA:CPU flushes the results of x in [-87.68, -87.34] (subnormal)
    to zero, and on subnormal inputs, bit for bit."""
    x = np.concatenate([np.linspace(-90, 90, 1 << 18, dtype=np.float32),
                        np.linspace(-87.8, -87.3, 1 << 14, dtype=np.float32),
                        SPECIAL])
    want = np.asarray(jax.jit(jnp.exp)(jnp.asarray(x)))
    got = xla_math.exp(torch.from_numpy(x))
    assert _same(got, want).all(), x[~_same(got, want)][:8]


def test_cpu_fma_is_fma_f32():
    """``xla_math._fma``'s CPU path (one float64 rounding, the midpoints
    and subnormal sums through ``fma_f32``) equals ``ref.fma_f32`` on
    random operands at several scales, on exact ties and on cancellations
    into the subnormals."""
    gen = torch.Generator().manual_seed(0)
    for scale in (1.0, 1e-20, 1e-38, 1e30):
        a = torch.randn(1 << 16, generator=gen) * scale
        b = torch.randn(1 << 16, generator=gen)
        c = torch.randn(1 << 16, generator=gen) * scale
        c[:512] = -(a[:512] * b[:512])
        assert np.array_equal(_bits(xla_math._fma(a, b, c)),
                              _bits(fma_f32(a, b, c)))
    ulp = 2.0 ** -24  # half an ulp of 1: exact ties and near ties
    a = torch.ones(4)
    b = torch.tensor([ulp, ulp * (1 + 2 ** -20), -ulp, 3 * ulp])
    c = torch.ones(4)
    assert np.array_equal(_bits(xla_math._fma(a, b, c)),
                          _bits(fma_f32(a, b, c)))
    assert np.array_equal(_bits(xla_math._fma(a, 0.5, 0.25)),
                          _bits(fma_f32(a, 0.5, torch.full((4,), 0.25))))


def test_every_gradient_path_is_one():
    """``torch.autograd.grad`` (under ``torch.utils.checkpoint`` too),
    ``torch.func.grad``, ``torch.func.vjp`` and a vmapped ``torch.func.grad``
    of the port's silu are bit-identical."""
    x, g = (torch.from_numpy(a) for a in _inputs(2))
    xr = x.clone().requires_grad_()
    want = torch.autograd.grad(layers.silu(xr), xr, g)[0]
    xr = x.clone().requires_grad_()
    remat = torch.utils.checkpoint.checkpoint(layers.silu, xr,
                                              use_reentrant=False)
    got = {
        "checkpoint": torch.autograd.grad(remat, xr, g)[0],
        "func.grad": torch.func.grad(
            lambda t: (layers.silu(t) * g).sum())(x),
        "func.vjp": torch.func.vjp(layers.silu, x)[1](g)[0],
        "vmap": torch.func.vmap(torch.func.grad(
            lambda t, c: (layers.silu(t) * c).sum()))(
                x.reshape(64, -1), g.reshape(64, -1)).reshape(-1),
    }
    for name, v in got.items():
        assert np.array_equal(_bits(v), _bits(want)), name


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_operations_per_silu():
    """The plain version of the port's silu, which the CPU runs, on 64
    seeded N(0, 16) values: 211 operations forward (XLA's ``exp`` with its
    8 multiply-adds, each a float64 sum rounded once with the exact
    fallback for the one sum here that lies on an f32 midpoint, the
    division and the flushes) and 243 backward (the logistic recomputed
    from x, then the gradient's 41), where ``F.silu`` is 1 and 1. On the
    card each direction is one launch of ``csrc/silu.cu``
    (``tests/test_torch_kernels_card.py``)."""
    gen = torch.Generator().manual_seed(0)
    x = (4 * torch.randn(64, generator=gen)).requires_grad_()
    g = torch.randn(64, generator=gen)
    with _Ops() as fwd:
        y = layers.silu(x)
    with _Ops() as bwd:
        torch.autograd.grad(y, x, g)
    assert (len(fwd.ops), len(bwd.ops)) == (211, 243), (fwd.ops, bwd.ops)


def _gradients_with_and_without_remat(arch):
    m = moe_model(arch)
    tc, tp, tb = m["tc"], m["tp"], m["tb"]
    without = tree_leaves(torch.func.grad(
        lambda p: TT.loss_fn(tc, p, tb, remat=False)[0])(tp))
    flat, treedef = tree_flatten(tp)
    leaves = [t.detach().clone().requires_grad_() for t in flat]
    params = tree_unflatten(treedef, leaves)
    loss = TT.loss_fn(tc, params, tb, remat=True)[0]
    with_remat = torch.autograd.grad(loss, leaves)
    assert len(with_remat) == len(without)
    for a, b in zip(with_remat, without):
        assert np.array_equal(_bits(a), _bits(b))


def test_silu_model_gradient_same_with_and_without_remat():
    """qwen3-moe's reduced config (silu in its experts' FFN): the loss
    gradient of every leaf with remat (``torch.autograd.grad`` through
    ``torch.utils.checkpoint``, the round's default) and without
    (``torch.func.grad``, the launcher's) bit-identical."""
    _gradients_with_and_without_remat("qwen3-moe-235b-a22b")


def test_both_silu_laws_model_gradient_same_with_and_without_remat():
    """deepseek-v3's reduced config (silu in its dense prefix layers, its
    shared expert and its routed experts): the loss gradient the same
    with and without remat, bit for bit."""
    _gradients_with_and_without_remat("deepseek-v3-671b")


def _lse_inputs():
    """Seeded (8, 4,096) f32 logits: N(0, 64) rows, a row with one -inf,
    a row all -inf, a row whose exp has a subnormal tail (a - m in
    [-88.8, -86.5], where XLA flushes), a row whose largest value stands
    87.5 over the rest; and a cotangent (0 on the all -inf row)."""
    rng = np.random.default_rng(0)
    a = (rng.standard_normal((8, 4096)) * 8).astype(np.float32)
    a[1, 7] = -np.inf
    a[2] = -np.inf
    a[3, 100:200] = a[3].max() - rng.uniform(86.5, 88.8, 100).astype(
        np.float32)
    a[4, 5] = a[4].max() + 87.5
    g = rng.standard_normal(8).astype(np.float32)
    g[2] = 0.0
    return a, g


@pytest.mark.parametrize("path", ["autograd", "func.grad", "vmap"])
def test_logsumexp_is_the_jitted_reference(path):
    """``layers.logsumexp`` and its vjp against the jitted
    ``jax.nn.logsumexp`` (last axis), bit for bit, under
    ``torch.autograd.grad``, ``torch.func.grad`` and a vmapped
    ``torch.func.grad``."""
    a, g = _lse_inputs()
    want = np.asarray(jax.jit(lambda x: jax.nn.logsumexp(x, axis=-1))(a))
    want_g = np.asarray(jax.jit(lambda x, c: jax.vjp(
        lambda y: jax.nn.logsumexp(y, axis=-1), x)[1](c)[0])(a, g))
    at, gt = torch.from_numpy(a), torch.from_numpy(g)
    if path == "autograd":
        x = at.clone().requires_grad_()
        out = layers.logsumexp(x, -1)
        got = torch.autograd.grad(out, x, gt)[0]
    elif path == "func.grad":
        out = layers.logsumexp(at, -1)
        got = torch.func.grad(
            lambda x: (layers.logsumexp(x, -1) * gt).sum())(at)
    else:
        fn = torch.func.vmap(torch.func.grad_and_value(
            lambda x, c: (layers.logsumexp(x, -1) * c).sum()))
        got, _ = fn(at.reshape(2, 4, -1), gt.reshape(2, 4))
        out = torch.func.vmap(lambda x: layers.logsumexp(x, -1))(
            at.reshape(2, 4, -1))
        got, out = got.reshape(8, -1), out.reshape(-1)
    assert np.array_equal(_bits(out), want.view(np.int32))
    assert np.array_equal(_bits(got), want_g.view(np.int32))


def test_logsumexp_over_a_middle_axis():
    """``dim`` other than the last: the same bits as over the last axis of
    the moved tensor, the gradient moved back."""
    a, _ = _lse_inputs()
    at = torch.from_numpy(a[:4, :96].reshape(4, 3, 32).copy())
    x = at.clone().requires_grad_()
    out = layers.logsumexp(x, 1)
    want = np.asarray(jax.jit(lambda y: jax.nn.logsumexp(y, axis=1))(
        at.numpy()))
    assert np.array_equal(_bits(out), want.view(np.int32))
    g = torch.ones_like(out)
    want_g = np.asarray(jax.jit(lambda y, c: jax.vjp(
        lambda z: jax.nn.logsumexp(z, axis=1), y)[1](c)[0])(
            at.numpy(), g.numpy()))
    assert np.array_equal(_bits(torch.autograd.grad(out, x, g)[0]),
                          want_g.view(np.int32))
