"""The port's silu (``models.layers.silu``) against the reference's
``jax.nn.silu``, on the CPU in f32.

The law, read from XLA:CPU's optimised HLO: the forward is ``x * s``,
``s = logistic(x) = 1 / (1 + exp(-x))``; the gradient is the transpose of
``x * logistic(x)`` with ``logistic``'s jvp ``g * (ans * (1 - ans))``, the
first product fused into the add: ``fma(g, s, (g * x) * (s * (1 - s)))``.
With jax's own ``s`` the law is the reference's bit for bit, eager and
jitted (the witness below). The port takes ``s`` from ``torch.sigmoid``,
which is not XLA's ``exp`` in the last bit on 0.4% of values, so the
port's silu is held to a measured share; its one backward serves
``torch.autograd.grad`` (the round with remat) and ``torch.func`` (without)
alike, and a silu model's loss gradient is the same both ways. The MoE
experts' silu keeps torch's law (``layers.silu_aten``: ``F.silu`` and
ATen's fused backward), also with one backward for both paths.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.common.tree import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.kernels.ref import fma_f32
from repro_torch.models import layers
from repro_torch.models import transformer as TT
from test_torch_archs import one_thread  # noqa: F401
from test_torch_moe import moe_model

N = 1 << 18
# measured here (2^18 values of N(0, 16), seeds 0 and 1): 99.63-99.65% of
# the values and 99.66-99.69% of the gradients bit-equal to jax.nn.silu's
FORWARD_EQUAL_FLOOR, GRADIENT_EQUAL_FLOOR = 0.99, 0.99


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
    (the eager ones are the same bits): at least 99% bit-equal each, and
    within one ulp of the forward's and a few of the gradient's scale
    elsewhere."""
    x, g = _inputs(seed)
    want_y, want_g = _jax_silu_and_vjp(x, g, jit=True)
    xt = torch.from_numpy(x).requires_grad_()
    y = layers.silu(xt)
    (gx,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
    fwd = float(np.mean(_bits(y) == _bits(want_y)))
    grad = float(np.mean(_bits(gx) == _bits(want_g)))
    print(f"seed {seed}: silu bit-equal {fwd:.4%}, gradient {grad:.4%}")
    assert fwd >= FORWARD_EQUAL_FLOOR and grad >= GRADIENT_EQUAL_FLOOR
    np.testing.assert_allclose(y.detach().numpy(), want_y, rtol=2.4e-7,
                               atol=1e-30)
    np.testing.assert_allclose(gx.numpy(), want_g, rtol=1e-6, atol=1e-6)


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
    """The port's silu is 2 operations forward (``sigmoid``, the product)
    and 34 backward (the products, ``1 - s`` and the 28 of ``fma_f32``'s
    single rounding), where ``F.silu`` is 1 and 1: on the card each is one
    launch."""
    x, g = torch.randn(64, requires_grad=True), torch.ones(64)
    with _Ops() as fwd:
        y = layers.silu(x)
    with _Ops() as bwd:
        torch.autograd.grad(y, x, g)
    assert (len(fwd.ops), len(bwd.ops)) == (2, 34), (fwd.ops, bwd.ops)


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
    """qwen3-moe's reduced config (silu in its experts' FFN, torch's law,
    ``layers.silu_aten``): the loss gradient of every leaf with remat
    (``torch.autograd.grad`` through ``torch.utils.checkpoint``, the
    round's default) and without (``torch.func.grad``, the launcher's)
    bit-identical."""
    _gradients_with_and_without_remat("qwen3-moe-235b-a22b")


def test_both_silu_laws_model_gradient_same_with_and_without_remat():
    """deepseek-v3's reduced config, whose dense prefix layers and shared
    expert take the reference's law (``layers.silu``) and its routed
    experts torch's (``layers.silu_aten``): the loss gradient the same
    with and without remat, bit for bit."""
    _gradients_with_and_without_remat("deepseek-v3-671b")


def test_aten_silu_is_torch_autograd_silu_on_every_path():
    """The MoE experts' silu (``layers.silu_aten``): ``F.silu``'s values and
    the gradient ``torch.autograd.grad`` takes of ``F.silu`` (ATen's fused
    ``silu_backward``), bit for bit, under ``torch.autograd.grad``,
    ``torch.func.grad``, ``torch.func.vjp`` and a vmapped
    ``torch.func.grad`` alike."""
    x, g = (torch.from_numpy(a) for a in _inputs(3))
    xr = x.clone().requires_grad_()
    y = torch.nn.functional.silu(xr)
    want = torch.autograd.grad(y, xr, g)[0]
    xr = x.clone().requires_grad_()
    got_y = layers.silu_aten(xr)
    assert np.array_equal(_bits(got_y), _bits(y))
    got = {
        "autograd": torch.autograd.grad(got_y, xr, g)[0],
        "func.grad": torch.func.grad(
            lambda t: (layers.silu_aten(t) * g).sum())(x),
        "func.vjp": torch.func.vjp(layers.silu_aten, x)[1](g)[0],
        "vmap": torch.func.vmap(torch.func.grad(
            lambda t, c: (layers.silu_aten(t) * c).sum()))(
                x.reshape(64, -1), g.reshape(64, -1)).reshape(-1),
    }
    for name, v in got.items():
        assert np.array_equal(_bits(v), _bits(want)), name
