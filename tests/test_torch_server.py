"""The port's server path (receive -> buffer -> flush -> broadcast -> replica
apply) against the JAX package's, given identical uploads and keys: the
JAX package makes the wire payloads, both servers receive them, and after
every flush x, x-hat, momentum, the broadcast's codes and norms and a
replica's decoded increment must match bit for bit; at the end so must the
TrafficMeter and StalenessMonitor summaries."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import QAFeL as JQAFeL
from repro.core import QAFeLConfig as JConfig
from repro.core.protocol import CLIENT_UPDATE as J_UPDATE
from repro.core.protocol import Message as JMessage
from repro.core.protocol import decode_message_flat as jdecode
from repro.core.quantizers import packed_identity_payload as jident
from repro.core.quantizers import packed_qsgd_payload as jqsgd
from repro.kernels import ops as jops
from repro_torch.core import QAFeL, QAFeLConfig
from repro_torch.core.protocol import CLIENT_UPDATE, Message
from repro_torch.core.protocol import decode_message_flat
from repro_torch.core.quantizers import (packed_identity_payload,
                                         packed_qsgd_payload)

D, K = 2048, 4
# staleness of the i-th upload (capped at the server clock)
TAUS = (0, 0, 1, 0, 2, 1, 0, 3, 0, 2, 1, 0, 4, 0, 1, 0)


def _unused_loss(params, batch, key):
    raise AssertionError("the server path trains nothing")


def _bits_equal(j, t) -> bool:
    j = np.asarray(j)
    t = t.cpu().numpy()
    if j.dtype == np.float32:
        j, t = j.view(np.int32), t.view(np.int32)
    return j.shape == t.shape and np.array_equal(j, t)


def _pair(cfg_kw):
    w0 = np.random.default_rng(1).standard_normal(D).astype(np.float32)
    jalgo = JQAFeL(JConfig(**cfg_kw), _unused_loss, {"w": jnp.asarray(w0)})
    talgo = QAFeL(QAFeLConfig(**cfg_kw), _unused_loss,
                  {"w": torch.from_numpy(w0)}, device="cpu")
    return jalgo, talgo


def _uploads(jalgo, talgo, i, rng):
    """The i-th upload as a JAX Message and the same bytes as a port one."""
    version = max(0, jalgo.state.t - TAUS[i % len(TAUS)])
    delta = (rng.standard_normal(D) * 0.01).astype(np.float32)
    spec = jalgo.cq.spec
    if spec.kind == "qsgd":
        p, nm = jops.qsgd_quantize(jnp.asarray(delta), jax.random.PRNGKey(i),
                                   spec.bits)
        jenc = jqsgd(p, nm, spec.bits, D, jalgo.state.layout)
        tenc = packed_qsgd_payload(torch.from_numpy(np.array(p)),
                                   torch.from_numpy(np.array(nm)), spec.bits,
                                   D, talgo.state.layout)
    else:
        jenc = jident(jnp.asarray(delta), D, jalgo.state.layout)
        tenc = packed_identity_payload(torch.from_numpy(delta), D,
                                       talgo.state.layout)
    wire = jalgo.cq.wire_bytes_packed(jalgo.state.layout)
    assert wire == talgo.cq.wire_bytes_packed(talgo.state.layout)
    return (JMessage(J_UPDATE, jenc, wire, {"version": version}),
            Message(CLIENT_UPDATE, tenc, wire, {"version": version}))


CASES = {
    "qsgd4": dict(client_quantizer="qsgd4", server_quantizer="qsgd4"),
    "qsgd8-up-qsgd2-down": dict(client_quantizer="qsgd8",
                                server_quantizer="qsgd2"),
    "qsgd4-up-identity-down": dict(client_quantizer="qsgd4",
                                   server_quantizer="identity"),
    "fedbuff-identity": dict(client_quantizer="identity",
                             server_quantizer="identity"),
    "qsgd4-drop-stale": dict(client_quantizer="qsgd4",
                             server_quantizer="qsgd4", max_staleness=1),
    "qsgd4-no-momentum-no-scaling": dict(client_quantizer="qsgd4",
                                         server_quantizer="qsgd4",
                                         server_momentum=0.0,
                                         staleness_scaling=False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_server_path_bit_exact(case):
    kw = dict(client_lr=0.2, server_lr=1.0, server_momentum=0.3,
              buffer_size=K, local_steps=2)
    kw.update(CASES[case])
    jalgo, talgo = _pair(kw)
    rng = np.random.default_rng(7)
    jrep = jnp.array(jalgo.state.hidden_flat)
    trep = talgo.state.hidden_flat.clone()
    keys = jax.random.split(jax.random.PRNGKey(3), 64)
    flushes = 0
    for i in range(40):
        jmsg, tmsg = _uploads(jalgo, talgo, i, rng)
        key = keys[i]
        jb = jalgo.receive(jmsg, key, n_receivers=1 + i % 5)
        tb = talgo.receive(tmsg, torch.from_numpy(
            np.asarray(key).astype(np.int64)), n_receivers=1 + i % 5)
        assert (jb is None) == (tb is None)
        if jb is None:
            continue
        flushes += 1
        js, ts = jalgo.state, talgo.state
        assert js.t == ts.t
        for name in ("x_flat", "hidden_flat", "momentum_flat"):
            assert _bits_equal(getattr(js, name), getattr(ts, name)), name
        if talgo.sq.spec.kind == "qsgd":
            assert _bits_equal(jb.payload["packed"], tb.payload["packed"])
            assert _bits_equal(jb.payload["norms"], tb.payload["norms"])
        else:
            assert _bits_equal(jb.payload["payload"], tb.payload["payload"])
        assert jb.wire_bytes == tb.wire_bytes
        jrep = jrep + jdecode(jalgo.sq, jb)
        trep = trep + decode_message_flat(talgo.sq, tb)
        assert _bits_equal(jrep, trep)
        assert torch.equal(trep, ts.hidden_flat)  # replica in sync
    assert flushes >= 3
    assert jalgo.meter.summary() == talgo.meter.summary()
    assert jalgo.staleness.summary() == talgo.staleness.summary()
    if kw.get("max_staleness"):
        assert talgo.meter.uploads_dropped > 0
    jm, tm = jalgo.metrics(drift=True), talgo.metrics(drift=True)
    assert jm.keys() == tm.keys()
    assert tm["hidden_drift"] == pytest.approx(jm["hidden_drift"], rel=1e-5)


def test_receive_rejects_future_version_and_foreign_kind():
    jalgo, talgo = _pair(dict(client_quantizer="qsgd4",
                              server_quantizer="qsgd4", buffer_size=K))
    _, tmsg = _uploads(jalgo, talgo, 0, np.random.default_rng(0))
    tmsg.meta["version"] = 1
    with pytest.raises(ValueError):
        talgo.receive(tmsg, torch.tensor([0, 1]))
    tmsg.meta["version"] = 0
    good = tmsg.payload
    # codes of 4 bits that claim 8: corrupt, refused before anything counts
    tmsg.payload = dict(good, bits=8)
    with pytest.raises(ValueError):
        talgo.receive(tmsg, torch.tensor([0, 1]))
    # a kind the port has no decoder for
    tmsg.payload = dict(good, kind="top_k")
    with pytest.raises(ValueError):
        talgo.receive(tmsg, torch.tensor([0, 1]))
    assert talgo.buffer.count == 0 and talgo.meter.uploads == 0
