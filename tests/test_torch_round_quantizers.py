"""The QAFeL round under every quantizer kind (repro_torch.distributed
.steps: ``upload``, ``accumulate_upload``, ``server_half``) against the
JAX package's round (``repro/distributed/steps.py:114-132,147-204``), on
the CPU.

Bit for bit (``np.array_equal`` on the bit patterns), on equal messages:

* each client kind's message into the weighted sum: the reference's
  jitted scan body ``buf + w_k * decode_client_flat(...)`` against the
  port's wire payload (``upload``) and ``accumulate_upload``, identity,
  top_k, rand_k and lowrank (qsgd: tests/test_torch_llm_round.py), at an
  odd length;
* each server kind's half of the round on the reduced gemma2-2b state,
  f32 and bf16 leaves, with the taps: x, x-hat, m and the seven taps
  against the reference's jitted server half and ``flush_tap_vector``;
* the metered bytes of every kind against the reference's
  ``payload_wire_bytes`` of the same payload.

Within the decoder's bounds of ROADMAP queue C (tests/
test_torch_llm_round.py): one whole round of the reference's jitted
``make_qafel_round`` and the port's from the same state, batches and keys
for the pairs the card runs (a lowrank4g32 client under a top_k0.1
server, rand_k0.1 both ways, identity both ways): the losses within
``LOSS_RTOL``, x's change and the momentum within ``STATE_L2_RTOL``. And
the port's round runs under all 25 client x server pairs on a narrowed
config, with finite losses and taps.
"""
import functools
import itertools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.core.protocol import payload_wire_bytes as jwire_bytes
from repro.core.qafel import QAFeLConfig as JConfig
from repro.core.qafel import server_apply_flat as jserver_apply
from repro.core.quantizers import flatten_tree as jflatten
from repro.core.quantizers import lowrank_expand_flat2d as jexpand
from repro.core.quantizers import make_quantizer as jmake
from repro.data.synthetic import synthetic_batch_for_config as jbatch
from repro.distributed import steps as JS
from repro.kernels import ops as jops
from repro.kernels import qsgd as jkq
from repro.models import transformer as JT
from repro.obs.taps import flush_tap_vector
from repro_torch import configs as TC
from repro_torch.common import prng
from repro_torch.common.tree import tree_leaves
from repro_torch.convert import params_from_jax, round_state_from_jax
from repro_torch.core.protocol import payload_wire_bytes
from repro_torch.core.qafel import QAFeLConfig
from repro_torch.core.quantizers import (TreeLayout, lowrank_project_flat2d,
                                         make_quantizer)
from repro_torch.distributed import steps as TS
from repro_torch.examples import federated_llm
from repro_torch.launch.train import round_batch
from repro_torch.kernels import ops as tops
from repro_torch.kernels import qsgd as tkq
from repro_torch.kernels import ref
from repro_torch.kernels import taps as ttaps


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The module's tests on one torch thread, restored after: the suite
    runs six workers on the CPU's cores, where a pool of threads per
    worker spends its time waiting on the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


LOSS_RTOL = 1e-5        # round losses (qsgd4's bound; measured below)
STATE_L2_RTOL = 5e-3    # x - x_0 and m after a round, L2 relative
KINDS = ["identity", "top_k0.1", "rand_k0.1", "lowrank4g32"]
WEIGHTS = np.array([0.9, 1.0, 0.7, 0.5], np.float32)


def _qcfg(cq="qsgd4", sq="qsgd4", cls=QAFeLConfig):
    return cls(client_lr=3e-2, server_lr=1.0, server_momentum=0.3,
               buffer_size=4, local_steps=2, client_quantizer=cq,
               server_quantizer=sq)


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


# ---------------------------------------------------------------------------
# The clients' messages into the weighted sum
# ---------------------------------------------------------------------------


def _reference_decode(cq, d: int, lseeds):
    """``decode_client_flat`` of ``repro/distributed/steps.py:114-132``."""
    def dec(msg, k_enc):
        if cq.spec.kind == "lowrank":
            y = jops.qsgd_dequantize(msg[0], msg[1], cq.spec.bits,
                                     cq.spec.rank(d))
            return jexpand(y[None], lseeds, cq.spec.group, d)[0]
        if cq.spec.kind == "identity":
            return msg[0][0]
        return cq.qdq_flat(msg[0][0], k_enc)
    return dec


@pytest.mark.parametrize("kind,d", [(k, 100_003) for k in KINDS]
                         + [("lowrank4g32", 131_072)])
def test_client_messages_accumulate_bit_for_bit(kind, d):
    """Four clients' messages at d = 100,003 (neither whole wire rows nor
    whole sum windows), unequal weights, the lowrank basis of step 3; a
    lowrank upload also at a d of whole rows, where XLA folds the
    expand's scale into the weight."""
    k, t = 4, 3
    rng = np.random.default_rng(11)
    deltas = (3e-3 * rng.standard_normal((k, d))).astype(np.float32)
    kencs = np.stack([np.asarray(jax.random.PRNGKey(100 + i))
                      for i in range(k)])
    jq, spec = jmake(kind), make_quantizer(kind).spec
    layout = TreeLayout.of({"w": torch.zeros(d)})
    seeds = tkq.basis_seeds(0, t) if spec.kind == "lowrank" else None
    outs = []
    for i in range(k):
        flat = torch.from_numpy(deltas[i])[None]
        if spec.kind == "lowrank":
            y = lowrank_project_flat2d(flat, seeds, spec.group)
            packed, norms = tops.qsgd_quantize(y[0], torch.from_numpy(
                kencs[i].astype(np.int64)), spec.bits)
            outs.append({"packed": packed[None], "norms": norms[None]})
        else:
            outs.append({"flat": flat})
    if spec.kind == "lowrank":
        msgs = (jnp.asarray(np.stack([o["packed"][0].numpy() for o in outs])),
                jnp.asarray(np.stack([o["norms"][0].numpy() for o in outs])))
    else:
        msgs = (jnp.asarray(deltas[:, None, :]),)
    dec = _reference_decode(jq, d, jkq.basis_seeds(0, jnp.int32(t)))

    def half(msgs, kencs, w):
        def body(buf, inp):
            m, ke, wk = inp
            return buf + wk * dec(m, ke), None
        return jax.lax.scan(body, jnp.zeros((d,), jnp.float32),
                            (msgs, kencs, w))[0]

    want = jax.jit(half)(msgs, jnp.asarray(kencs), jnp.asarray(WEIGHTS))
    buf = torch.zeros(d)
    w = torch.from_numpy(WEIGHTS)
    for i in range(k):
        payload = TS.upload(spec, outs[i], torch.from_numpy(
            kencs[i].astype(np.int64)), layout, seeds)
        assert payload_wire_bytes(payload) == jwire_bytes(
            _jax_payload(payload))
        TS.accumulate_upload(buf, payload, w[i:i + 1], spec)
    assert _same(buf, want)


def _jax_payload(payload: dict) -> dict:
    """The port's payload as the reference's metering reads it."""
    out = {k: v for k, v in payload.items() if k != "layout"}
    for name in ("idx", "vals", "packed", "norms", "payload", "flat"):
        if isinstance(out.get(name), torch.Tensor):
            out[name] = jnp.asarray(out[name].numpy())
    return out


def test_rand_k_unscaled_client_accumulates_with_its_weight():
    """An unscaled rand_k upload adds its kept values times w_k alone:
    ``fma(v, w_k, buf)``, the sum the scaled law reduces to at n/k = 1."""
    d = 4_099
    spec = make_quantizer("rand_k0.1").spec
    spec = type(spec)(**{**spec.__dict__, "scaled": False})
    flat = torch.from_numpy(np.random.default_rng(2).standard_normal(
        d).astype(np.float32))
    layout = TreeLayout.of({"w": torch.zeros(d)})
    payload = TS.upload(spec, {"flat": flat[None]}, prng.PRNGKey(4), layout)
    buf = TS.accumulate_upload(torch.ones(d), payload, torch.tensor([0.7]),
                               spec)
    kept = TS._kept(flat, payload["idx"].long())
    assert _same(buf, ref.fma_f32(kept, torch.tensor(0.7), torch.ones(d)))
    assert _same(payload["vals"], flat[payload["idx"].long()])


# ---------------------------------------------------------------------------
# The server half under each server kind, with its taps
# ---------------------------------------------------------------------------


def _state_trees(dtype):
    jc = JC.get_reduced("gemma2-2b").replace(param_dtype=dtype, dtype=dtype)
    rng = np.random.default_rng(5)
    jp = JT.init_params(jc, jax.random.PRNGKey(5))
    noise = lambda a, s: (a.astype(jnp.float32) + jnp.asarray(
        s * rng.standard_normal(a.shape), jnp.float32)).astype(a.dtype)
    x = jax.tree.map(lambda a: noise(a, 0.01), jp)
    hidden = jax.tree.map(lambda a: noise(a, 0.002), x)
    m = jax.tree.map(lambda a: noise(jnp.zeros_like(a), 0.001), jp)
    d = sum(a.size for a in jax.tree.leaves(jp))
    buf = (3e-3 * rng.standard_normal(d)).astype(np.float32)
    return x, hidden, m, buf, d


def _reference_server(x, hidden, m, buf, kser, w, t, *, sq, qcfg,
                      taps=True):
    """``repro/distributed/steps.py:172-204`` from the clients' sum on,
    for a non-qsgd server, with its taps (the flag traced) or without."""
    hf, layout = jflatten(hidden)
    xf, _ = jflatten(x)
    mf, _ = jflatten(m)
    delta_bar = buf * (1.0 / qcfg.buffer_size)
    x_new, m_new = jserver_apply(xf, mf, delta_bar, lr=qcfg.server_lr,
                                 beta=qcfg.server_momentum)
    diff = x_new - hf
    q = diff if sq.spec.kind == "identity" else sq.qdq_flat(diff, kser)
    out = (layout.unflatten(x_new), layout.unflatten(hf + q),
           layout.unflatten(m_new))
    if not taps:
        return out
    boundary = functools.partial(jops.hard_boundary, t >= jnp.int32(0))
    return out + (flush_tap_vector(boundary, xf, x_new, delta_bar, diff, q,
                                   w),)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", KINDS)
def test_server_half_bit_for_bit(kind, dtype):
    """The port's ``server_half`` with taps on the round's flat state
    (``RoundState.from_trees``, updated in place) against the reference's
    jitted server half from the same clients' sum: x, x-hat, m and the
    seven taps bit for bit; the broadcast's metered bytes are the
    reference's."""
    x, hidden, m, buf, d = _state_trees(dtype)
    jq = _qcfg(sq=kind, cls=JConfig)
    kser = jax.random.PRNGKey(9)
    want = jax.jit(functools.partial(_reference_server, sq=jmake(kind),
                                     qcfg=jq))(
        x, hidden, m, jnp.asarray(buf), kser, jnp.asarray(WEIGHTS),
        jnp.int32(1))
    state = TS.RoundState.from_trees(
        *(params_from_jax(jax.tree.map(np.asarray, t), device="cpu")
          for t in (x, hidden, m)))
    partials = torch.empty((ref.ROUND_TAP_SUMS, ref.tap_windows(d)))
    tbuf = torch.from_numpy(buf.copy())
    msg = TS.server_half(*state.flat, tbuf, prng.PRNGKey(9),
                         qcfg=_qcfg(sq=kind), d=d, taps=partials)
    got_taps = ttaps.round_taps(partials, torch.from_numpy(WEIGHTS))
    assert _same(got_taps, want[3]), (got_taps, np.asarray(want[3]))
    for got_t, ref_t in zip((state.x, state.hidden, state.momentum),
                            want[:3]):
        assert all(_same(a, b) for a, b in zip(
            tree_leaves(got_t), jax.tree.leaves(ref_t)))
    spec = make_quantizer(kind).spec
    layout = TreeLayout.of(state.x)
    got_bytes = payload_wire_bytes(TS.broadcast_payload(spec, msg, layout))
    if spec.kind == "lowrank":  # the rank-length message it stands for
        assert got_bytes == jwire_bytes({"format": "packed",
                                         "kind": "lowrank", "bits": 4,
                                         "rank": spec.rank(d)})
        assert msg[0].shape == (spec.rank(d),)
    else:
        assert got_bytes == jwire_bytes(_jax_payload(
            TS.broadcast_payload(spec, msg, layout)))
        # the broadcast is the reference's in-math q: its kept
        # coordinates and values (identity: the diff itself)
        diff = _reference_diff(x, hidden, m, buf)
        q = np.asarray(jax.jit(jmake(kind).qdq_flat)(diff, kser))
        if spec.kind == "identity":
            assert _same(msg[0], diff)
        else:
            idx = msg[0].long().numpy()
            assert np.count_nonzero(q) <= idx.size
            assert _same(msg[1], q[idx])


@pytest.mark.parametrize("kind", ["rand_k0.1", "lowrank4g32"])
def test_server_half_without_taps_bit_for_bit(kind):
    """Without taps the reference's program has one consumer of q fewer;
    x-hat's rounding stays the one ``server_half`` applies."""
    x, hidden, m, buf, d = _state_trees("float32")
    want = jax.jit(functools.partial(
        _reference_server, sq=jmake(kind), qcfg=_qcfg(sq=kind, cls=JConfig),
        taps=False))(x, hidden, m, jnp.asarray(buf), jax.random.PRNGKey(9),
                     jnp.asarray(WEIGHTS), jnp.int32(1))
    state = TS.RoundState.from_trees(
        *(params_from_jax(jax.tree.map(np.asarray, t), device="cpu")
          for t in (x, hidden, m)))
    TS.server_half(*state.flat, torch.from_numpy(buf.copy()),
                   prng.PRNGKey(9), qcfg=_qcfg(sq=kind), d=d)
    for got_t, ref_t in zip((state.x, state.hidden, state.momentum), want):
        assert all(_same(a, b) for a, b in zip(
            tree_leaves(got_t), jax.tree.leaves(ref_t)))


def _reference_diff(x, hidden, m, buf):
    """The reference's broadcast diff ``x_new - x-hat`` of the clients'
    sum (the server update's rounding law holds it bit for bit)."""
    def diff(x, hidden, m, buf):
        xf, hf, mf = (jflatten(t)[0] for t in (x, hidden, m))
        x_new, _ = jserver_apply(xf, mf, buf * (1.0 / 4), lr=1.0, beta=0.3)
        return x_new - hf
    return jax.jit(diff)(x, hidden, m, jnp.asarray(buf))


# ---------------------------------------------------------------------------
# Whole rounds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cq,sq", [("lowrank4g32", "top_k0.1"),
                                   ("rand_k0.1", "rand_k0.1"),
                                   ("identity", "identity")])
def test_whole_round_matches_reference(cq, sq):
    """One round of the reference's jitted round and of the port's on the
    reduced gemma2-2b from the same state, batch, weights and key: the
    loss, x's change and the momentum within the decoder's bounds; the
    metered bytes as the reference's payloads give them."""
    jc, tc = JC.get_reduced("gemma2-2b"), TC.get_reduced("gemma2-2b")
    jstate = JS.init_round_state(jc, jax.random.PRNGKey(0))
    tstate = round_state_from_jax(jax.device_get(jstate), device="cpu")
    jx0 = np.concatenate([np.asarray(a, np.float32).ravel()
                          for a in jax.tree.leaves(jstate.x)])
    raw = jbatch(jc, np.random.default_rng(0), 16, 64)
    jb = {k: jnp.asarray(v).reshape((4, 2, 2) + v.shape[1:])
          for k, v in raw.items()}
    jround = jax.jit(JS.make_qafel_round(jc, _qcfg(cq, sq, JConfig),
                                         remat=False))
    jstate, jm = jround(jstate, jb, jnp.asarray(WEIGHTS),
                        jax.random.PRNGKey(0))
    tb = round_batch(tc, _qcfg(cq, sq), np.random.default_rng(0),
                     federated_llm.LOCAL_BATCH, 64, "cpu")
    tround = TS.make_qafel_round(tc, _qcfg(cq, sq), remat=False)
    tstate, tm = tround(tstate, tb, torch.from_numpy(WEIGHTS),
                        prng.PRNGKey(0))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    js = jax.device_get(jstate)
    for name, base in (("x", jx0), ("momentum", 0.0)):
        a = np.concatenate([np.asarray(v, np.float32).ravel() for v in
                            jax.tree.leaves(getattr(js, name))]) - base
        b = torch.cat([v.reshape(-1) for v in tree_leaves(
            getattr(tstate, name))]).numpy() - base
        rel = float(np.linalg.norm(b.astype(np.float64) - a)
                    / np.linalg.norm(a))
        print(f"{cq}/{sq}: {name} after a round, L2 error {rel:.3e}")
        assert rel <= STATE_L2_RTOL, (name, rel)
    d = tstate.flat[0].numel()
    for kind, got in ((cq, tm["upload_bytes"]), (sq, tm["broadcast_bytes"])):
        spec = make_quantizer(kind).spec
        if spec.kind == "identity":
            assert got == 4 * d
        elif spec.kind == "lowrank":
            r = spec.rank(d)
            assert got == (spec.bits * r + 32 * -(-r // 128)) / 8
        else:
            assert got == 8 * max(1, math.ceil(0.1 * d))


def _tiny_cfg():
    return TC.get_reduced("gemma2-2b").replace(
        d_model=16, vocab=64, n_heads=2, n_kv_heads=1, head_dim=8, d_ff=32,
        sliding_window=8)


@pytest.mark.parametrize("cq,sq", list(itertools.product(
    ["qsgd4"] + KINDS, ["qsgd4"] + KINDS)))
def test_round_runs_under_every_pair(cq, sq):
    """Two rounds of the port's round on a narrowed config (d = 5,792)
    for each client x server pair, taps on: finite losses and taps, the
    in-place state stepped, a message per client and the broadcast, and
    the metered bytes of each kind."""
    cfg = _tiny_cfg()
    qcfg = _qcfg(cq, sq)
    state = TS.init_round_state(cfg, 3, "cpu")
    d = state.flat[0].numel()
    msgs = []
    rf = TS.make_qafel_round(cfg, qcfg, remat=False, taps=True,
                             on_message=lambda kind, i, a, b: msgs.append(
                                 (kind, i)))
    rng = np.random.default_rng(1)
    for step in range(2):
        batch = round_batch(cfg, qcfg, rng, federated_llm.LOCAL_BATCH, 16,
                            "cpu")
        out, met = rf(state, batch, torch.from_numpy(WEIGHTS),
                      prng.PRNGKey(step))
        assert out is state and state.t == step + 1
        assert torch.isfinite(met["loss"]) and torch.isfinite(
            met["taps"]).all()
    assert msgs == 2 * ([("upload", k) for k in range(4)] + [("broadcast",
                                                             4)])
    for kind, got in ((cq, met["upload_bytes"]), (sq,
                                                  met["broadcast_bytes"])):
        spec = make_quantizer(kind).spec
        want = {"identity": 4 * d, "top_k": 8 * math.ceil(0.1 * d),
                "rand_k": 8 * math.ceil(0.1 * d)}.get(spec.kind)
        if spec.kind in ("qsgd", "lowrank"):
            n = d if spec.kind == "qsgd" else spec.rank(d)
            want = (spec.bits * n + 32 * -(-n // 128)) / 8
        assert got == want, (kind, got, want)
    if sq == "identity":  # q = diff: no broadcast error
        assert float(met["taps"][3]) == 0.0
