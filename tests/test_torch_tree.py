"""The names the port's modules took over from the reference in one
slice, each against the JAX package's on equal numpy inputs, on the CPU:
the tree arithmetic (``common.tree``), ``staleness_weight`` and
``tau_max_for_buffer`` (``core.staleness``), ``encode_message`` /
``decode_message`` (``core.protocol``), ``local_sgd_scan`` and
``server_apply`` (``core.qafel``), ``abstract_params`` /
``abstract_round_state`` and ``configs/celeba_cnn.py``.

All bit for bit (``np.array_equal`` on the bit patterns):

* ``tree_add`` ... ``tree_axpy`` on a tree of f32 and bf16 leaves against
  the reference called eagerly; ``split_key_tree`` key for key; the law
  of the reference's eager ``tree_dot`` on 1-D f32 leaves (every length
  from 1 to 70, and 1,517 and 4,099), spelled here as a witness: XLA:CPU's
  gemv chain per leaf (``_vdot_f32``), the leaves' dots summed in
  ``xla_sum``'s order;
* ``staleness_weight`` for every tau in 0..10^6 against the reference
  called eagerly (jitted, XLA takes a reciprocal square root and differs
  on 30% of them: the launcher calls it eagerly);
* the packed codes, norms and wire bytes of ``encode_message`` of the
  paper's CNN tree, and the tree ``decode_message`` gives back;
* ``local_sgd_scan`` against the jitted reference (f32), ``server_apply``
  against the eager reference (f32 and bf16).

Within a bound: the port's ``tree_dot`` and ``tree_norm``, which take
each leaf's dot in float64 on the leaf's device and round it once,
against the reference eager and jitted, on the 1-D trees above and on a
tree with a 2-D and a bf16 leaf (where XLA fuses the reshape or the
conversion into a vectorized dot, ROADMAP queue C): within the f32
summation bound ``(n + 2L + 2) * 2^-24 * sum|a_i b_i|`` (n the longest
leaf, L the leaves), which any f32 order of the reference's meets
(measured at most 0.0056 of it), and within ``DOT_RTOL`` = 1e-5 relative
(measured at most 3.3e-6, the jitted 3-leaf tree); the norm within 2^-23
relative of the reference's plus half the dot's bound, and within
``DOT_RTOL`` (measured 1.1e-6).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.common import tree as JT
from repro.configs import celeba_cnn as jcnn_cfg
from repro.core import protocol as JP
from repro.core.qafel import QAFeLConfig as JConfig
from repro.core.qafel import local_sgd_scan as jscan
from repro.core.qafel import server_apply as jserver_apply
from repro.core.quantizers import make_quantizer as jmake
from repro.core.staleness import staleness_weight as jweight
from repro.core.staleness import tau_max_for_buffer as jtau_max
from repro.distributed import steps as JS
from repro.models.cnn import init_cnn as jinit_cnn
from repro_torch import configs as TC
from repro_torch.common import prng
from repro_torch.common import tree as TT
from repro_torch.configs import celeba_cnn as tcnn_cfg
from repro_torch.convert import params_from_jax
from repro_torch.core import protocol as TP
from repro_torch.core.qafel import QAFeLConfig, local_sgd_scan, server_apply
from repro_torch.core.quantizers import make_quantizer
from repro_torch.core.staleness import staleness_weight, tau_max_for_buffer
from repro_torch.distributed import steps as TS
from repro_torch.kernels import ref as tkref
from repro_torch.models import transformer as TM


F32_EPS = 2.0 ** -24  # f32's unit roundoff
DOT_RTOL = 1e-5  # tree_dot and tree_norm against the reference, relative


def _dot_bound(pairs) -> float:
    """The f32 summation bound of a tree dot: ``(n + 2L + 2) * u *
    sum|a_i b_i|`` over the leaf pairs (n the longest leaf, L the leaves,
    u f32's unit roundoff)."""
    n = max(a.size for a, _ in pairs)
    total = sum(float(np.abs(a.astype(np.float64).ravel()
                             * b.astype(np.float64).ravel()).sum())
                for a, b in pairs)
    return (n + 2 * len(pairs) + 2) * F32_EPS * total


def _fma_f64(a: float, b: float, acc: float) -> float:
    """fl32(a * b + acc) of f32 values held as floats, single rounded:
    the product is exact in float64 and the sum's rounding is corrected
    as ``ref.fma_f32`` corrects it."""
    p = a * b
    s = p + acc
    bb = s - acc
    err = (acc - (s - bb)) + (p - bb)
    r = float(np.float32(s))
    if err != 0.0 and r != s:
        other = float(np.nextafter(np.float32(r), np.float32(
            math.inf if s > r else -math.inf)))
        if (r + other) * 0.5 == s:  # an f32 tie that err breaks
            r = max(r, other) if err > 0 else min(r, other)
    return r


def _vdot_f32(x: np.ndarray, y: np.ndarray) -> float:
    """The witness of ``jnp.vdot`` of two 1-D f32 vectors as XLA:CPU
    compiles it on its own (its gemv emitter, read from the optimised IR):
    the first product rounded, then one accumulator in element order, the
    products of elements 1-7 rounded before their adds and every later
    one fused into its add (``fma(x_i, y_i, acc)``; at two elements the
    second is fused too). Stepped on the host, one element at a time."""
    xs, ys = x.astype(np.float64).tolist(), y.astype(np.float64).tolist()
    f32 = np.float32
    acc = float(f32(xs[0]) * f32(ys[0]))
    for i in range(1, len(xs)):
        if i < 8 and len(xs) != 2:
            acc = float(f32(acc) + f32(xs[i]) * f32(ys[i]))
        else:
            acc = _fma_f64(xs[i], ys[i], acc)
    return acc


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.view(torch.int16) if a.dtype == torch.bfloat16 else
                a.view(torch.int32) if a.dtype == torch.float32 else
                a).numpy()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.int16)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(a, b) -> bool:
    a, b = _bits(a), _bits(b)
    return a.shape == b.shape and np.array_equal(a, b)


def _pair(seed, scale=1.0):
    """One tree in both packages: an f32 and a bf16 leaf, nested."""
    rng = np.random.default_rng(seed)
    a = (scale * rng.standard_normal((37, 41))).astype(np.float32)
    b = (scale * rng.standard_normal(4_099)).astype(np.float32)
    j = {"w": jnp.asarray(a), "n": {"v": jnp.asarray(b).astype(jnp.bfloat16)}}
    t = {"w": torch.from_numpy(a), "n": {"v": torch.from_numpy(b).to(
        torch.bfloat16)}}
    return j, t


def _leaves_same(t, j) -> bool:
    return all(_same(a, np.asarray(b)) for a, b in zip(
        TT.tree_leaves(t), jax.tree.leaves(j)))


def test_tree_arithmetic_bit_for_bit():
    (ja, ta), (jb, tb) = _pair(1), _pair(2, 0.1)
    assert _leaves_same(TT.tree_add(ta, tb), JT.tree_add(ja, jb))
    assert _leaves_same(TT.tree_sub(ta, tb), JT.tree_sub(ja, jb))
    assert _leaves_same(TT.tree_scale(ta, 0.37), JT.tree_scale(ja, 0.37))
    assert _leaves_same(TT.tree_axpy(0.3, ta, tb), JT.tree_axpy(0.3, ja, jb))
    assert _leaves_same(TT.tree_zeros_like(ta), JT.tree_zeros_like(ja))
    assert TT.tree_size(ta) == JT.tree_size(ja) == 37 * 41 + 4_099
    assert TT.tree_bytes(ta) == JT.tree_bytes(ja) == 4 * 37 * 41 + 2 * 4_099


def _within_dot_bound(got, want, pairs, what) -> None:
    bound = _dot_bound(pairs)
    err = abs(float(got) - float(want))
    rel = err / abs(float(want))
    print(f"{what}: |port - reference| = {err:.3e}, {err / bound:.4f} of "
          f"the bound, {rel:.2e} relative")
    assert err <= bound and rel <= DOT_RTOL, what


@pytest.mark.parametrize("lengths", [tuple(range(1, 36)),
                                     tuple(range(36, 71)), (1517, 4099, 2)])
def test_tree_dot_and_norm_bit_for_bit(lengths):
    """Bit for bit: the witness of the eager reference's law (each leaf's
    gemv chain, the leaves' dots in ``xla_sum``'s order). The port's
    ``tree_dot`` and ``tree_norm``: within the f32 summation bound of the
    reference, eager and jitted."""
    rng = np.random.default_rng(len(lengths))
    vals = [(rng.standard_normal(n).astype(np.float32),
             rng.standard_normal(n).astype(np.float32)) for n in lengths]
    ja = {f"l{i:02d}": jnp.asarray(a) for i, (a, _) in enumerate(vals)}
    jb = {f"l{i:02d}": jnp.asarray(b) for i, (_, b) in enumerate(vals)}
    ta = {k: torch.from_numpy(np.asarray(v)) for k, v in ja.items()}
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in jb.items()}
    got = TT.tree_dot(ta, tb)
    assert got.dtype == torch.float32 and got.shape == ()
    eager = np.asarray(JT.tree_dot(ja, jb))
    _within_dot_bound(got, eager, vals, f"{len(lengths)} 1-D leaves, eager")
    _within_dot_bound(got, jax.jit(JT.tree_dot)(ja, jb), vals,
                      f"{len(lengths)} 1-D leaves, jitted")
    # the witness: the eager reference's law, bit for bit
    for (a, b), n in zip(vals, lengths):
        assert _same(np.float32(_vdot_f32(a, b)),
                     np.asarray(jnp.vdot(a, b))), n
    dots = torch.tensor([_vdot_f32(a, b) for a, b in vals],
                        dtype=torch.float32)
    assert _same(tkref.xla_sum(dots), eager)
    # the norm: sqrt of a dot within the bound, correctly rounded
    norm, want = float(TT.tree_norm(ta)), float(np.asarray(JT.tree_norm(ja)))
    sq = [(a, a) for a, _ in vals]
    assert abs(norm - want) <= (2.0 ** -23 * want
                                + 0.5 * _dot_bound(sq) / want)
    assert abs(norm - want) <= DOT_RTOL * want


def test_tree_dot_on_fused_leaves_within_bound():
    (ja, ta), (jb, tb) = _pair(1), _pair(2)
    got = TT.tree_dot(ta, tb)
    pairs = [(np.asarray(x, dtype=np.float32), np.asarray(y, dtype=np.float32))
             for x, y in zip(jax.tree.leaves(ja), jax.tree.leaves(jb))]
    _within_dot_bound(got, JT.tree_dot(ja, jb), pairs,
                      "a 2-D f32 and a bf16 leaf, eager")
    _within_dot_bound(got, jax.jit(JT.tree_dot)(ja, jb), pairs,
                      "a 2-D f32 and a bf16 leaf, jitted")


def test_split_key_tree_is_jaxs():
    ja, ta = _pair(1)
    want = JT.split_key_tree(jax.random.PRNGKey(7), ja)
    got = TT.split_key_tree(prng.PRNGKey(7), ta)
    for a, b in zip(TT.tree_leaves(got), jax.tree.leaves(want)):
        assert np.array_equal(a.numpy(), np.asarray(b).astype(np.int64))


def test_staleness_weight_bit_for_bit():
    tau = np.arange(0, 1_000_001)
    want = np.asarray(jweight(tau))
    got = staleness_weight(torch.from_numpy(tau))
    assert got.dtype == torch.float32 and _same(got, want)
    assert _same(staleness_weight(torch.zeros(4)), np.asarray(
        jweight(jnp.zeros((4,)))))
    assert _same(staleness_weight(3), np.asarray(jweight(3)))
    assert _same(staleness_weight(torch.tensor([0, 5]), enabled=False),
                 np.asarray(jweight(np.array([0, 5]), enabled=False)))
    for t1, k in ((0, 4), (17, 4), (16, 4), (9, 1), (5, 0)):
        assert tau_max_for_buffer(t1, k) == jtau_max(t1, k)


@pytest.mark.parametrize("name,fast", [("qsgd4", False), ("qsgd4", True),
                                       ("qsgd2", False), ("top_k0.1", False),
                                       ("identity", False)])
def test_encode_message_on_the_cnn_tree(name, fast):
    jp = jinit_cnn(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    key = jax.random.PRNGKey(11)
    jm = JP.encode_message("client_update", jmake(name), jp, key,
                           fast=fast, client=3)
    tm = TP.encode_message("client_update", make_quantizer(name), tp,
                           torch.from_numpy(np.asarray(key).astype(
                               np.int64)), fast=fast, client=3)
    assert tm.wire_bytes == jm.wire_bytes and tm.meta == {"client": 3}
    for field in ("packed", "norms", "idx", "vals", "payload"):
        if field in jm.payload:
            a = tm.payload[field]
            assert _same(a.to(torch.int64) if field == "idx" else a,
                         np.asarray(jm.payload[field]).astype(np.int64)
                         if field == "idx" else jm.payload[field]), field
    jd = JP.decode_message(jmake(name), jm)
    td = TP.decode_message(make_quantizer(name), tm)
    assert _leaves_same(td, jd)


def test_local_sgd_scan_and_server_apply():
    def jloss(p, batch, key):
        del key
        return jnp.sum(p["w"] * batch["c"]) + jnp.sum(p["n"]["v"] ** 2)

    def tloss(p, batch, key):
        del key
        return torch.sum(p["w"] * batch["c"]) + torch.sum(p["n"]["v"] ** 2)

    rng = np.random.default_rng(3)
    w = rng.standard_normal((37, 41)).astype(np.float32)
    v = rng.standard_normal(4_099).astype(np.float32)
    c = rng.standard_normal((3, 37, 41)).astype(np.float32)
    jp = {"w": jnp.asarray(w), "n": {"v": jnp.asarray(v)}}
    tp = {"w": torch.from_numpy(w), "n": {"v": torch.from_numpy(v)}}
    jkeys = jax.random.split(jax.random.PRNGKey(0), 3)
    want, wl = jax.jit(lambda p, b, k: jscan(jloss, 0.05, p, b, k,
                                             with_loss=True))(
        jp, {"c": jnp.asarray(c)}, jkeys)
    got, gl = local_sgd_scan(tloss, 0.05, tp, {"c": torch.from_numpy(c)},
                             prng.split(prng.PRNGKey(0), 3), with_loss=True)
    assert _leaves_same(got, want)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=1e-6)
    assert local_sgd_scan(tloss, 0.05, tp, {"c": torch.from_numpy(c)},
                          prng.split(prng.PRNGKey(0), 3))[1] is None
    for beta in (0.3, 0.0):
        for (jx, tx), (jm, tm), (jd, td) in (
                (_pair(1), _pair(2, 0.01), _pair(3, 0.01)),):
            jq = JConfig(server_lr=0.7, server_momentum=beta)
            tq = QAFeLConfig(server_lr=0.7, server_momentum=beta)
            wx, wm = jserver_apply(jq, jx, jm, jd)
            gx, gm = server_apply(tq, tx, tm, td)
            assert _leaves_same(gx, wx) and _leaves_same(gm, wm)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_abstract_params_and_round_state(dtype):
    """Shapes and dtypes of the reference's ``eval_shape``, on ``meta``
    tensors: nothing allocated, at the published gemma2-2b too."""
    for jc, tc in ((JC.get_reduced("gemma2-2b"), TC.get_reduced("gemma2-2b")),
                   (JC.get_config("gemma2-2b"), TC.get_config("gemma2-2b"))):
        jc = jc.replace(param_dtype=dtype, dtype=dtype)
        tc = tc.replace(param_dtype=dtype, dtype=dtype)
        want = JS.abstract_round_state(jc)
        got = TS.abstract_round_state(tc)
        assert TM.abstract_params(tc).keys() == got.x.keys()
        for name in ("x", "hidden", "momentum"):
            jl = jax.tree.leaves(getattr(want, name))
            tl = TT.tree_leaves(getattr(got, name))
            assert len(jl) == len(tl)
            for a, b in zip(tl, jl):
                assert a.is_meta and tuple(a.shape) == tuple(b.shape)
                assert str(a.dtype).split(".")[-1] == str(b.dtype)
        assert got.t == 0 and got.flat is None
    assert TT.tree_size(got.x) == 2_614_341_888


def test_celeba_cnn_constants_are_the_papers():
    names = [n for n in dir(jcnn_cfg) if n.isupper()]
    assert names == [n for n in dir(tcnn_cfg) if n.isupper()]
    for n in names:
        assert getattr(tcnn_cfg, n) == getattr(jcnn_cfg, n), n
    assert tcnn_cfg.CONFIG is None and tcnn_cfg.REDUCED is None
    assert (tcnn_cfg.CLIENT_LR, tcnn_cfg.SERVER_LR, tcnn_cfg.SERVER_MOMENTUM,
            tcnn_cfg.BUFFER_K) == (4.7e-6, 1000.0, 0.3, 10)
