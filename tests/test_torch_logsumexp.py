"""The loss's logsumexp (``kernels.logsumexp``, ``models.layers.logsumexp``,
``sharded_logsumexp``) against the jitted ``jax.nn.logsumexp`` and its
vjp, on the CPU in f32, bit for bit (a nan as a nan).

The law (PERF.md law 12): ``m`` the row maximum, 0 where it is not finite;
the sum of XLA's ``exp(a - m)`` (with its flush of subnormals) in law 7's
windows of 32, recursively; XLA's ``log`` and ``+ m``; the gradient ``(g /
sum) * exp(a - m)``. The vocabulary lengths cover every change of law 7's
padding (one window, 32 and 33 values, one level-1 window of 1,024 and
one past it, one level-2 window of 32,768 and one past it, mamba2-1.3b's
50,280, 50,288 and gemma2-2b's 256,000). The rows hold a -inf, a row of -inf, a
+inf, a nan, values whose ``exp`` flushes (a - m in [-88.8, -86.5]) and a
maximum 87.5 over the rest; a cotangent whose quotient by the sum is
subnormal, and gradients that are (both flushed to zero). The card runs
the same law in one kernel each way; ``tests/test_torch_kernels_card.py``
holds it to this plain version.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import logsumexp as klse
from repro_torch.models import layers
from test_torch_archs import one_thread  # noqa: F401

LENGTHS = (1, 31, 32, 33, 1_024, 1_025, 32_768, 32_769, 50_280, 50_288)
WIDE = 256_000  # gemma2-2b's vocabulary, a few rows
PATHS = ("autograd", "func.grad", "vmap")

_lse = jax.jit(lambda x: jax.nn.logsumexp(x, axis=-1))
_vjp = jax.jit(lambda x, c: jax.vjp(
    lambda y: jax.nn.logsumexp(y, axis=-1), x)[1](c)[0])


def _inputs(v: int, rows: int = 8):
    """Seeded (rows, v) logits of N(0, 64) with the special rows (as far
    as v allows) and a cotangent a row."""
    rng = np.random.default_rng(v)
    a = (rng.standard_normal((rows, v)) * 8).astype(np.float32)
    special = {1: "neg_inf", 2: "all_neg_inf", 3: "flush", 4: "pos_inf",
               5: "nan", 6: "tall"}
    for r, kind in special.items():
        if r >= rows:
            break
        if kind == "neg_inf":
            a[r, rng.integers(v)] = -np.inf
        elif kind == "all_neg_inf":
            a[r] = -np.inf
        elif kind == "flush":
            k = min(v, 300)
            a[r, :k] = a[r].max() - rng.uniform(86.5, 88.8, k).astype(
                np.float32)
        elif kind == "pos_inf":
            a[r, rng.integers(v)] = np.inf
        elif kind == "nan":
            a[r, rng.integers(v)] = np.nan
        else:
            a[r, rng.integers(v)] = a[r].max() + 87.5
    g = rng.standard_normal(rows).astype(np.float32)
    if rows > 7:
        g[7] = 1e-37  # g / sum is subnormal, which XLA flushes
    return a, g


def _same(got, want) -> bool:
    """The same bits, or both nan."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    return bool(np.all((got.view(np.int32) == want.view(np.int32))
                       | (np.isnan(got) & np.isnan(want))))


def _reference(a, g):
    return np.asarray(_lse(a)), np.asarray(_vjp(a, g))


@pytest.mark.parametrize("v", LENGTHS + (WIDE,))
def test_plain_version_is_the_jitted_reference(v):
    """The wrapper's CPU path (``forward``, ``backward``) against the
    jitted ``jax.nn.logsumexp`` and its vjp; ``m`` and ``total`` as jax's
    ``amax`` fix and sum would give them."""
    a, g = _inputs(v, 3 if v == WIDE else 8)
    want, want_g = _reference(a, g)
    at = torch.from_numpy(a)
    lse, m, total = klse.forward(at)
    assert _same(lse, want)
    assert _same(klse.backward(torch.from_numpy(g), at, m, total), want_g)
    am = np.max(a, axis=-1, keepdims=True)
    assert _same(m, np.where(np.isfinite(am), am, 0).astype(np.float32))
    sums = np.asarray(jax.jit(lambda x, mm: jnp.sum(jnp.exp(x - mm), -1,
                                                    keepdims=True))(
        a, m.numpy()))
    assert _same(total, sums)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("v", LENGTHS + (WIDE,))
def test_layers_logsumexp_every_gradient_path(v, path):
    """``layers.logsumexp`` and its vjp bit for bit under
    ``torch.autograd.grad``, ``torch.func.grad`` and a vmapped
    ``torch.func.grad_and_value``."""
    rows = 4 if v == WIDE else 8
    a, g = _inputs(v, rows)
    want, want_g = _reference(a, g)
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
        got, _ = fn(at.reshape(2, rows // 2, -1), gt.reshape(2, rows // 2))
        out = torch.func.vmap(lambda x: layers.logsumexp(x, -1))(
            at.reshape(2, rows // 2, -1))
        got, out = got.reshape(rows, -1), out.reshape(-1)
    assert _same(out, want)
    assert _same(got, want_g)


@pytest.mark.parametrize("v", (33, 50_288))
def test_sharded_logsumexp_without_a_group_is_the_meshless_op(v):
    """``sharded_logsumexp`` with no "model" group is ``logsumexp``, its
    gradient too."""
    a, g = _inputs(v)
    want, want_g = _reference(a, g)
    x = torch.from_numpy(a).requires_grad_()
    out = layers.sharded_logsumexp(x, None)
    assert _same(out, want)
    assert _same(torch.autograd.grad(out, x, torch.from_numpy(g))[0],
                 want_g)


@pytest.mark.parametrize("v,shards", ((64, 2), (1_025, 5), (50_288, 4),
                                      (WIDE, 2)))
def test_sum_and_log_modes_compose_the_shards(v, shards):
    """The vocabulary-split path's modes: each shard's ``sum_exp`` under
    the group's maximum, the totals added in rank order (the all-reduce of
    the ranks' sums), then ``log_plus``, against the same composition of
    jitted reference pieces (each shard's ``jnp.sum(jnp.exp(s - m))``,
    ``jnp.log(total) + m``)."""
    a, _ = _inputs(v, 3 if v == WIDE else 8)
    parts = np.split(a, shards, axis=-1)
    am = np.max(a, axis=-1, keepdims=True)
    jm = np.where(np.isfinite(am), am, 0).astype(np.float32)
    shard_sum = jax.jit(lambda s, mm: jnp.sum(jnp.exp(s - mm), -1,
                                              keepdims=True))
    want_total = np.asarray(shard_sum(parts[0], jm))
    for p in parts[1:]:
        want_total = want_total + np.asarray(shard_sum(p, jm))
    want = np.asarray(jax.jit(lambda t, mm: (jnp.log(t) + mm)[..., 0])(
        want_total, jm))
    total = None
    for p in parts:
        m, t = klse.sum_exp(torch.from_numpy(p),
                            torch.from_numpy(am.copy()))
        total = t if total is None else total + t
    assert _same(m, jm)
    assert _same(total, want_total)
    assert _same(klse.log_plus(total, m), want)


def test_wrapper_checks_its_inputs():
    """Other dtypes, shapes and devices raise."""
    a = torch.zeros(2, 5)
    with pytest.raises(TypeError):
        klse.forward(a.double())
    with pytest.raises(ValueError):
        klse.forward(torch.zeros(2, 0))
    with pytest.raises(ValueError):
        klse.forward(torch.zeros(2, 5, device="meta"))
    _, m, total = klse.forward(a)
    with pytest.raises(ValueError):
        klse.backward(torch.zeros(3), a, m, total)
    with pytest.raises(ValueError):
        klse.sum_exp(a, torch.zeros(2))
