"""The QAFeL round's taps (``repro_torch.distributed.steps
.make_qafel_round(taps=True)``: the server-update kernel's and K3's tap
outputs as plain versions, ``kernels.taps.round_taps``'s finishing pass,
``kernels.ref.round_taps``) against the JAX package's round, on the CPU.

Bit for bit (``np.array_equal`` on the bit patterns):

* on equal client messages, over two rounds, with f32 and bf16 leaves:
  the port's seven taps through its own ``accumulate`` and ``server_half``
  against the reference's ``flush_tap_vector`` in its jitted round's
  server half (``repro/distributed/steps.py:165-204``) with a traced
  boundary flag, as its round computes them; and ``ref.round_taps`` over
  the materialized vectors;
* taps on change no bit of the round: x, x-hat, m and every message equal
  to taps off, in the port (f32 and bf16) and in the reference, over two
  rounds;
* the law at odd lengths: the level-1 window sums and the finishing pass
  against ``ref.xla_sum`` of the squares, at 4,100, 79,842 and 100,000
  values.

Within a tolerance: two whole rounds of the reference's jitted
``make_qafel_round(taps=True)`` and the port's from the same state,
batches and keys; the clients' model math differs in its last bits
(tests/test_torch_llm_round.py), so the taps agree to ``WHOLE_ROUND_RTOL``
relative (measured 1.6e-6).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.core.qafel import QAFeLConfig as JConfig
from repro.core.qafel import server_apply_flat as jserver_apply
from repro.core.quantizers import flatten_tree as jflatten
from repro.core.quantizers import qsgd_encode_flat2d
from repro.data.synthetic import synthetic_batch_for_config as jbatch
from repro.distributed import steps as JS
from repro.kernels import ops as jops
from repro.models import transformer as JT
from repro.obs.taps import FLUSH_TAP_NAMES, flush_tap_vector
from repro_torch import configs as TC
from repro_torch.common import prng
from repro_torch.common.tree import tree_leaves
from repro_torch.convert import params_from_jax, round_state_from_jax
from repro_torch.core.qafel import QAFeLConfig
from repro_torch.distributed import steps as TS
from repro_torch.examples import federated_llm
from repro_torch.launch.train import round_batch
from repro_torch.kernels import ops as tops
from repro_torch.kernels import qsgd as tq
from repro_torch.kernels import ref
from repro_torch.kernels import taps as ttaps
from repro_torch.kernels.server_update import server_update_


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The module's tests on one torch thread, restored after: the suite
    runs six workers on the CPU's cores, where a pool of threads per
    worker spends its time waiting on the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


WHOLE_ROUND_RTOL = 1e-5  # whole rounds, relative per tap (measured 1.6e-6)
QCFG = dict(client_lr=3e-2, server_lr=1.0, server_momentum=0.3,
            buffer_size=4, local_steps=2, client_quantizer="qsgd4",
            server_quantizer="qsgd4")
WEIGHTS = np.array([0.9, 1.0, 0.7, 0.5], np.float32)


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        a = (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.int16)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(a, b) -> bool:
    a, b = _bits(a), _bits(b)
    return a.shape == b.shape and np.array_equal(a, b)


def _messages(rng, d: int, k: int = 4, bits: int = 4):
    deltas = (0.003 * rng.standard_normal((k, d))).astype(np.float32)
    seeds = torch.from_numpy(rng.integers(0, 2 ** 32, (k, 2)))
    return tops.qsgd_quantize_batch(torch.from_numpy(deltas), seeds, bits)


def _reference_half(x, hidden, m, packed, norms, w, kser, t, *, d, bits,
                    qcfg):
    """``repro/distributed/steps.py:165-204`` from the packed client
    messages on, with its taps: the flag traced from the state's step."""
    hf, layout = jflatten(hidden)
    xf, _ = jflatten(x)
    mf, _ = jflatten(m)

    def body(buf, inp):
        p, n, wk = inp
        return buf + wk * jops.qsgd_dequantize(p, n, bits, d), None

    buf, _ = jax.lax.scan(body, jnp.zeros((d,), jnp.float32),
                          (packed, norms, w))
    delta_bar = buf * (1.0 / qcfg.buffer_size)
    x_new, m_new = jserver_apply(xf, mf, delta_bar, lr=qcfg.server_lr,
                                 beta=qcfg.server_momentum)
    diff = x_new - hf
    bp, bn = qsgd_encode_flat2d(diff[None], kser, bits, threefry=True)
    q = jops.qsgd_dequantize(bp[0], bn[0], bits, d)
    boundary = functools.partial(jops.hard_boundary, t >= jnp.int32(0))
    taps = flush_tap_vector(boundary, xf, x_new, delta_bar, diff, q, w)
    return (layout.unflatten(x_new), layout.unflatten(hf + q),
            layout.unflatten(m_new), bp[0], bn[0], taps,
            (xf, x_new, delta_bar, diff))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_taps_on_equal_messages_bit_for_bit(dtype):
    """Two rounds' server halves on the reduced gemma2-2b state from equal
    client messages: the port's taps (``server_half(taps=)`` then
    ``round_taps``) equal the reference's jitted taps, and so does
    ``ref.round_taps`` over the reference's materialized vectors; the
    state and the broadcast stay the reference's too."""
    bits = 4
    jc = JC.get_reduced("gemma2-2b").replace(param_dtype=dtype, dtype=dtype)
    rng = np.random.default_rng(5)
    jp = JT.init_params(jc, jax.random.PRNGKey(5))
    noise = lambda a, s: (a.astype(jnp.float32) + jnp.asarray(
        s * rng.standard_normal(a.shape), jnp.float32)).astype(a.dtype)
    x = jax.tree.map(lambda a: noise(a, 0.01), jp)
    hidden = jax.tree.map(lambda a: noise(a, 0.002), x)
    m = jax.tree.map(lambda a: noise(jnp.zeros_like(a), 0.001), jp)
    d = sum(a.size for a in jax.tree.leaves(jp))
    jq, tqc = JConfig(**QCFG), QAFeLConfig(**QCFG)
    half = jax.jit(lambda *a: _reference_half(*a, d=d, bits=bits, qcfg=jq))
    state = TS.RoundState.from_trees(
        *(params_from_jax(jax.tree.map(np.asarray, t), device="cpu")
          for t in (x, hidden, m)))
    w = torch.from_numpy(WEIGHTS)
    for step in range(2):
        packed, norms = _messages(rng, d)
        kser = jax.random.PRNGKey(9 + step)
        want = half(x, hidden, m, jnp.asarray(packed.numpy()),
                    jnp.asarray(norms.numpy()), jnp.asarray(WEIGHTS), kser,
                    jnp.int32(step))
        buf = torch.zeros(d)
        for k in range(4):
            TS.accumulate(buf, packed[k], norms[k], w[k:k + 1], bits=bits,
                          d=d)
        partials = torch.empty((5, ref.tap_windows(d)))
        bp, bn = TS.server_half(*state.flat, buf, prng.PRNGKey(9 + step),
                                qcfg=tqc, d=d, taps=partials)
        got = ttaps.round_taps(partials, w)
        assert _same(got, want[5]), (step, got, np.asarray(want[5]))
        assert _same(bp, want[3]) and _same(bn, want[4])
        for got_t, ref_t in zip((state.x, state.hidden, state.momentum),
                                want[:3]):
            assert all(_same(a, b) for a, b in zip(
                tree_leaves(got_t), jax.tree.leaves(ref_t)))
        xf, x_new, delta_bar, diff = (torch.from_numpy(np.array(v))
                                      for v in want[6])
        plain = ref.round_taps(xf, x_new, delta_bar, diff, bp, bn, bits, w)
        assert _same(plain, want[5])
        x, hidden, m = want[:3]
    assert [float(v) for v in got[5:]] == [float(WEIGHTS.sum(dtype=np.float32)),
                                           float(WEIGHTS.min())]
    assert len(FLUSH_TAP_NAMES) == got.shape[0] == 7


def test_whole_rounds_taps_match_reference():
    """The reference's jitted round with taps and the port's, two rounds
    from the same state, batches, keys and unequal weights."""
    jc, tc = JC.get_reduced("gemma2-2b"), TC.get_reduced("gemma2-2b")
    jq, tqc = JConfig(**QCFG), QAFeLConfig(**QCFG)
    jround = jax.jit(JS.make_qafel_round(jc, jq, remat=False, taps=True))
    tround = TS.make_qafel_round(tc, tqc, taps=True)
    jstate = JS.init_round_state(jc, jax.random.PRNGKey(0))
    tstate = round_state_from_jax(jax.device_get(jstate), device="cpu")
    rj, rt = np.random.default_rng(0), np.random.default_rng(0)
    worst = 0.0
    for step in range(2):
        raw = jbatch(jc, rj, 16, 64)
        jb = {k: jnp.asarray(v).reshape((4, 2, 2) + v.shape[1:])
              for k, v in raw.items()}
        jstate, jm = jround(jstate, jb, jnp.asarray(WEIGHTS),
                            jax.random.PRNGKey(step))
        tb = round_batch(tc, tqc, rt, federated_llm.LOCAL_BATCH, 64,
                         "cpu")
        tstate, tm = tround(tstate, tb, torch.from_numpy(WEIGHTS),
                            prng.PRNGKey(step))
        a = np.asarray(jm["taps"], np.float64)
        b = tm["taps"].numpy().astype(np.float64)
        assert tm["taps"].dtype == torch.float32 and b.shape == (7,)
        rel = np.abs(a - b) / np.abs(a)
        worst = max(worst, float(rel.max()))
        assert np.all(rel <= WHOLE_ROUND_RTOL), (step, a, b)
        assert np.array_equal(a[5:], b[5:])
    print(f"whole rounds: taps within {worst:.2e} of the reference's")


def _tiny(dtype):
    kw = dict(d_model=16, vocab=64, n_heads=2, n_kv_heads=1, head_dim=8,
              d_ff=32, sliding_window=8, param_dtype=dtype, dtype=dtype)
    return (JC.get_reduced("gemma2-2b").replace(**kw),
            TC.get_reduced("gemma2-2b").replace(**kw))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_taps_change_no_bit(dtype):
    """The port's round with taps on and off, two rounds each from clones
    of one state: x, x-hat, m, the losses and every upload and broadcast
    bit-equal; the taps on the second round differ across their first
    three (m and x - x-hat are no longer 0)."""
    _, tc = _tiny(dtype)
    qcfg = QAFeLConfig(**QCFG)
    base = TS.init_round_state(tc, 3, "cpu")
    runs = {}
    for taps in (False, True):
        msgs = []
        rf = TS.make_qafel_round(
            tc, qcfg, taps=taps, on_message=lambda kind, i, p, nm:
            msgs.append((kind, i, p.clone(), nm.clone())))
        state, rng, mets = base.clone(), np.random.default_rng(1), []
        for step in range(2):
            batch = round_batch(tc, qcfg, rng, federated_llm.LOCAL_BATCH,
                                16, "cpu")
            state, met = rf(state, batch, torch.from_numpy(WEIGHTS),
                            prng.PRNGKey(step))
            mets.append(met)
        runs[taps] = (state, mets, msgs)
    (s0, m0, g0), (s1, m1, g1) = runs[False], runs[True]
    assert all(_same(a, b) for a, b in zip(s0.flat, s1.flat))
    assert all(_same(a["loss"], b["loss"]) for a, b in zip(m0, m1))
    assert len(g0) == len(g1) == 10
    assert all(a[:2] == b[:2] and _same(a[2], b[2]) and _same(a[3], b[3])
               for a, b in zip(g0, g1))
    assert "taps" not in m0[0]
    t0, t1 = m1[0]["taps"], m1[1]["taps"]
    assert torch.isfinite(t1).all() and t1.shape == (7,)
    assert len({float(v) for v in t1[:3]}) == 3
    # a first round has m = 0 and x = x-hat: the three agree but for the
    # rounding of x_new - x and x_new - x-hat
    torch.testing.assert_close(t0[1:3], t0[:1].expand(2), rtol=1e-5, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_taps_change_no_bit(dtype):
    """The reference's jitted round with taps on and off, two rounds from
    one state: x, x-hat, m and the losses bit-equal."""
    jc, _ = _tiny(dtype)
    jq = JConfig(**QCFG)
    st0 = JS.init_round_state(jc, jax.random.PRNGKey(3))
    out = {}
    for taps in (False, True):
        rf = jax.jit(JS.make_qafel_round(jc, jq, remat=False, taps=taps))
        st, rng, losses = st0, np.random.default_rng(1), []
        for step in range(2):
            raw = jbatch(jc, rng, 16, 16)
            jb = {k: jnp.asarray(v).reshape((4, 2, 2) + v.shape[1:])
                  for k, v in raw.items()}
            st, met = rf(st, jb, jnp.asarray(WEIGHTS),
                         jax.random.PRNGKey(step))
            losses.append(np.asarray(met["loss"]))
        out[taps] = (jax.device_get(st), losses)
    (a, la), (b, lb) = out[False], out[True]
    for name in ("x", "hidden", "momentum"):
        for u, v in zip(jax.tree.leaves(getattr(a, name)),
                        jax.tree.leaves(getattr(b, name))):
            assert _same(u, v), name
    assert all(_same(u, v) for u, v in zip(la, lb))


@pytest.mark.parametrize("n", [4100, 79842, 100000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tap_law_at_odd_n(n, dtype):
    """At the lengths ``tests/test_torch_obs.py`` holds the sum law at
    (level-1 windows straddling the vector's ends at 4,100 and 79,842,
    with 14 and 15 zeros in front; whole windows at 100,000), the server update's and K3's tap
    outputs (plain versions, in window chunks of 37) and the finishing pass
    equal ``ref.xla_sum`` of the materialized squares and
    ``ref.round_taps``; the update and the apply are those without taps."""
    g = torch.Generator().manual_seed(n)
    buf = 4e-2 * torch.randn(n, generator=g)
    m = (1e-2 * torch.randn(n, generator=g)).to(dtype)
    x = torch.randn(n, generator=g).to(dtype)
    xhat = (x.float() + 1e-2 * torch.randn(n, generator=g)).to(dtype)
    w = torch.tensor([0.9, 1.0, 0.7, 0.5])
    # the materialized vectors, as the reference's round has them
    x_old = x.float().clone()
    delta = buf * np.float32(0.25)
    x_new = ref.fma_f32(m.float(), float(np.float32(0.3)), delta) + x_old
    diff = x_new - xhat.float()

    plain = [t.clone() for t in (buf, m, x, xhat)]
    server_update_(*plain, k=4, beta=0.3, lr=1.0)
    parts = torch.empty((5, ref.tap_windows(n)))
    ref.server_update_(buf, m, x, xhat, inv_k=0.25,
                       beta=float(np.float32(0.3)), lr=1.0, taps=parts[:3],
                       chunk=37 * 32)
    assert all(_same(a, b) for a, b in zip((buf, m, x), plain[:3]))
    assert _same(buf, diff)

    packed, norms = tq.qsgd_quantize_pack_threefry(diff, prng.PRNGKey(2), 4)
    acc, acc_plain = xhat.clone(), xhat.clone()
    tq.qsgd_unpack_dequantize(packed, norms, 4, acc=acc_plain)
    tq.qsgd_unpack_dequantize(packed, norms, 4, acc=acc, tap_diff=diff,
                              taps=parts[3:])
    assert _same(acc, acc_plain)
    assert _same(parts[3:], ref.dequantize_taps(packed, norms, 4, diff,
                                                chunk=37 * 32))

    sm = ref.signed_magnitudes(packed, 4).reshape(-1)[:n]
    scale = (norms * ref.reciprocal_levels(4)).repeat_interleave(128)[:n]
    q, err = sm * scale, ref.fma_f32(-sm, scale, diff)
    squares = [v * v for v in (delta, x_new - x_old, diff, err, q)]
    assert _same(ref.xla_sum(parts),
                 torch.stack([ref.xla_sum(v) for v in squares]))
    got = ttaps.round_taps(parts, w)
    assert _same(got, ref.round_taps(x_old, x_new, delta, diff, packed,
                                     norms, 4, w))
    assert torch.isfinite(got).all()


def test_tap_arguments_are_checked():
    n = 300
    packed, norms = tq.qsgd_quantize_pack_threefry(torch.randn(n),
                                                   prng.PRNGKey(1), 4)
    acc, diff = torch.zeros(n), torch.zeros(n)
    with pytest.raises(ValueError, match="together"):
        tq.qsgd_unpack_dequantize(packed, norms, 4, acc=acc, tap_diff=diff)
    with pytest.raises(ValueError, match="x-hat"):
        tq.qsgd_unpack_dequantize(packed, norms, 4, acc=acc, tap_diff=diff,
                                  taps=torch.zeros(2, 10),
                                  weight=torch.ones(1))
    with pytest.raises(ValueError, match="shape"):
        tq.qsgd_unpack_dequantize(packed, norms, 4, acc=acc, tap_diff=diff,
                                  taps=torch.zeros(2, 9))
    with pytest.raises(ValueError, match="shape"):
        server_update_(torch.zeros(n), torch.zeros(n), torch.zeros(n),
                       torch.zeros(n), k=4, beta=0.3, lr=1.0,
                       taps=torch.zeros(3, 9))
    with pytest.raises(ValueError, match="shape"):
        ttaps.round_taps(torch.zeros(4, 9))
    assert ref.tap_windows(n) == 10 and ref.tap_front(n) == 10
    assert ref.tap_front(32) == 0 and ref.tap_front(2_614_341_888) == 0
    assert ref.tap_front(2_614_341_888 // 32) == 12
