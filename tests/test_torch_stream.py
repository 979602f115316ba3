"""The port's row-chunked streaming encode and streamed uplink against the
JAX package's, on the CPU, bit for bit (``np.array_equal`` on the bit
patterns):

* ``ops.qsgd_quantize_chunk`` with the threefry dither, reassembled from
  chunks of 1, 3, 7 and all rows (ragged last rows included), against the
  reference's **unchunked** ``ops.qsgd_quantize``: the reference's own
  chunked threefry encode rebuilds its dither with
  ``qsgd.threefry_uniform_rows``, which no longer equals
  ``jax.random.uniform`` under ``jax_threefry_partitionable`` (ROADMAP
  queue C), so it is no oracle; the port keys each chunk's dither by its
  global element index, as the unchunked uniform does;
* the counter-hash chunks against the reference's chunked
  ``qsgd_quantize_chunk(threefry=False)``, ``qsgd_encode_rows`` at a row
  offset and ``qsgd_encode_flat2d(chunk_rows=)`` in both modes;
* the cohort step at ``chunk_rows`` (b = 5: K2 in row chunks, against
  the reference's chunked step; b = 1: the delta formed chunk by chunk
  and K1 at row offsets, against the reference's unchunked step);
* ``run_client_stream`` then ``receive`` against the reference's
  ``run_client``: every upload's codes, every broadcast, the server state
  and the meters, on the quad; on the CNN against the port's own
  ``run_client`` (the reference's jitted CNN gradient is not its eager
  one, ROADMAP queue C);
* streams of several clients at one version, interleaved, and a
  malformed stream refused before the server changes;
* ``UpdateBuffer.add_encoded_chunks``: every refusal the reference makes,
  each leaving the buffer as it was.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import QAFeL as JQAFeL
from repro.core import QAFeLConfig as JConfig
from repro.core.quantizers import flatten_tree as jflatten
from repro.core.quantizers import qsgd_encode_flat2d as jencode_flat2d
from repro.core.quantizers import qsgd_encode_rows as jencode_rows
from repro.kernels import ops as jops
from repro_torch.common import prng
from repro_torch.core import QAFeL, QAFeLConfig
from repro_torch.core.buffer import UpdateBuffer
from repro_torch.core.protocol import packed_qsgd_chunk_payload
from repro_torch.core.qafel import client_update_flat
from repro_torch.core.quantizers import (TreeLayout, flatten_tree,
                                         make_quantizer, qsgd_encode_flat2d,
                                         qsgd_encode_rows)
from repro_torch.kernels import ops as tops

D = 307  # 3 wire rows, the last ragged


def _same(a, b) -> bool:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    return a.shape == b.shape and np.array_equal(a, b)


def _flat(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def _chunks(flat: torch.Tensor, key, c: int, **kw):
    """The message of ``flat`` as ``qsgd_quantize_chunk`` chunks of c
    rows, concatenated."""
    n = flat.numel()
    rows = tops.rows_for(n)
    ps, ns = [], []
    for r0 in range(0, rows, c):
        p, nm = tops.qsgd_quantize_chunk(flat[r0 * 128:(r0 + c) * 128], key,
                                         r0, bits=4, total_rows=rows, **kw)
        ps.append(p)
        ns.append(nm)
    return torch.cat(ps), torch.cat(ns)


@pytest.mark.parametrize("n", (307, 1024, 1000))
def test_quantize_chunk_threefry_matches_unchunked_reference(n):
    flat = _flat(n, 1)
    want_p, want_n = jops.qsgd_quantize(jnp.asarray(flat),
                                        jax.random.PRNGKey(7), 4)
    rows = tops.rows_for(n)
    for c in (1, 3, 7, rows):
        p, nm = _chunks(torch.from_numpy(flat), prng.PRNGKey(7), c)
        assert _same(p, want_p) and _same(nm, want_n), (n, c)


def test_quantize_chunk_counter_hash_matches_reference():
    flat = _flat(D, 2)
    rows = tops.rows_for(D)
    key = jax.random.PRNGKey(3)
    pad = np.concatenate([flat, np.zeros(4 * 128, np.float32)])
    for c in (1, 2, 3):
        p, nm = _chunks(torch.from_numpy(flat), prng.PRNGKey(3), c,
                        threefry=False)
        for r0 in range(0, rows, c):
            jp, jn = jops.qsgd_quantize_chunk(
                jnp.asarray(pad[r0 * 128:(r0 + c) * 128]), key, r0, bits=4,
                total_rows=rows, threefry=False)
            rc = min(c, rows - r0)
            assert _same(p[r0:r0 + rc], np.asarray(jp)[:rc])
            assert _same(nm[r0:r0 + rc], np.asarray(jn)[:rc])


def test_quantize_chunk_refuses_rows_outside_the_message():
    with pytest.raises(ValueError, match="outside"):
        tops.qsgd_quantize_chunk(torch.zeros(256), prng.PRNGKey(0), 2,
                                 bits=4, total_rows=3)


def test_encode_rows_row_offset_matches_reference():
    rng = np.random.default_rng(8)
    x3d = rng.standard_normal((2, 6, 128)).astype(np.float32)
    seeds = np.arange(4, dtype=np.uint32).reshape(2, 2)
    jp, jn = jencode_rows(jnp.asarray(x3d[:, 2:]), jnp.asarray(seeds), 4, 2)
    for c in (None, 1, 3):
        p, nm = qsgd_encode_rows(torch.from_numpy(x3d[:, 2:]),
                                 torch.from_numpy(seeds.astype(np.int64)), 4,
                                 2, chunk_rows=c)
        assert _same(p, jp) and _same(nm, jn), c


@pytest.mark.parametrize("b,threefry", ((1, True), (1, False), (4, False)))
def test_encode_flat2d_chunk_rows(b, threefry):
    """Threefry chunks against the reference's unchunked encode; counter-
    hash chunks against its chunked encode (and its unchunked one)."""
    flat2d = np.random.default_rng(5).standard_normal((b, D)).astype(
        np.float32)
    jkeys = (jax.random.PRNGKey(6) if threefry
             else jax.random.split(jax.random.PRNGKey(6), b))
    tkeys = (prng.PRNGKey(6) if threefry
             else prng.split(prng.PRNGKey(6), b))
    whole = jencode_flat2d(jnp.asarray(flat2d), jkeys, 4, threefry=threefry)
    for c in (1, 2, 5):
        p, nm = qsgd_encode_flat2d(torch.from_numpy(flat2d), tkeys, 4,
                                   threefry=threefry, chunk_rows=c)
        assert _same(p, whole[0]) and _same(nm, whole[1]), c
        if not threefry:
            jp, jn = jencode_flat2d(jnp.asarray(flat2d), jkeys, 4,
                                    chunk_rows=c)
            assert _same(p, jp) and _same(nm, jn), c


# ---------------------------------------------------------------------------
# The cohort step and the streamed uplink on the quad
# ---------------------------------------------------------------------------


def _jquad_loss(params, batch, key):
    del key
    return jnp.sum((params["w"] - batch["target"]) ** 2)


def _tquad_loss(params, batch, key):
    del key
    return torch.sum((params["w"] - batch["target"]) ** 2)


QCFG = dict(client_lr=0.1, server_lr=1.2, server_momentum=0.3,
            buffer_size=3, local_steps=2, client_quantizer="qsgd4",
            server_quantizer="qsgd4")


@pytest.mark.parametrize("b,chunk_rows", ((5, 1), (5, 2), (1, 1), (1, 2)))
def test_cohort_step_chunk_rows_matches_reference(b, chunk_rows):
    """b = 5 against the reference's step at the same ``chunk_rows`` (its
    counter-hash chunks are exact); b = 1 (the delta formed chunk by
    chunk, K1 at row offsets) against its unchunked threefry step."""
    w0 = _flat(D, 9)
    targets = np.random.default_rng(3).standard_normal(
        (b, 2, D)).astype(np.float32)
    jq, tq = JConfig(**QCFG), QAFeLConfig(**QCFG)
    jflat, jlayout = jflatten({"w": jnp.asarray(w0)})
    tflat, tlayout = flatten_tree({"w": torch.from_numpy(w0)})
    jkeys = jax.random.split(jax.random.PRNGKey(4), 2 * b)
    tkeys = prng.split(prng.PRNGKey(4), 2 * b)
    jb = {"target": jnp.asarray(targets if b > 1 else targets[0])}
    tb = {"target": torch.from_numpy(targets if b > 1 else targets[0])}
    jk = (jkeys[:b], jkeys[b:]) if b > 1 else (jkeys[0], jkeys[1])
    tk = (tkeys[:b], tkeys[b:]) if b > 1 else (tkeys[0], tkeys[1])
    want = jops.cohort_train_encode_step(
        _jquad_loss, jq, jq.cq().spec, jlayout, jflat, jb, *jk,
        jnp.asarray(True), b=b, chunk_rows=chunk_rows if b > 1 else None)
    got = client_update_flat(_tquad_loss, tq, make_quantizer("qsgd4").spec,
                             tlayout, tflat, tb, *tk, b=b,
                             chunk_rows=chunk_rows)
    assert _same(got["packed"], want["packed"])
    assert _same(got["norms"], want["norms"])


def _quad_pair(chunk_rows):
    w0 = np.zeros(D, np.float32)
    jalgo = JQAFeL(JConfig(**QCFG), _jquad_loss, {"w": jnp.asarray(w0)})
    talgo = QAFeL(QAFeLConfig(**QCFG), _tquad_loss,
                  {"w": torch.from_numpy(w0)}, device="cpu",
                  chunk_rows=chunk_rows)
    return jalgo, talgo


def _states_equal(jalgo, talgo) -> bool:
    js, ts = jalgo.state, talgo.state
    return (js.t == ts.t and all(
        _same(getattr(ts, f), np.asarray(getattr(js, f)))
        for f in ("x_flat", "hidden_flat", "momentum_flat")))


@pytest.mark.parametrize("chunk_rows", (1, 2))
def test_streamed_upload_matches_reference_run_client(chunk_rows):
    """Seven streamed uploads (chunks of 1 or 2 of the 3 rows, delivered
    last chunk first) against the reference's ``run_client`` uploads:
    codes, bytes, every broadcast, the state and the meters."""
    jalgo, talgo = _quad_pair(chunk_rows)
    rng = np.random.default_rng(11)
    key = jax.random.PRNGKey(11)
    tkey = prng.PRNGKey(11)
    flushes = 0
    for u in range(7):
        key, k2, k3 = jax.random.split(key, 3)
        tkey, t2, t3 = prng.split(tkey, 3)
        target = (rng.standard_normal(D) + 3.0).astype(np.float32)
        target = np.broadcast_to(target, (2, D)).copy()
        jm, _ = jalgo.run_client({"target": jnp.asarray(target)}, k2)
        msgs, version = talgo.run_client_stream(
            {"target": torch.from_numpy(target)}, t2)
        assert version == jm.meta["version"]
        assert len(msgs) == -(-3 // chunk_rows)
        assert sum(m.wire_bytes for m in msgs) == jm.wire_bytes
        assert _same(torch.cat([m.payload["packed"] for m in msgs]),
                     jm.payload["packed"])
        assert _same(torch.cat([m.payload["norms"] for m in msgs]),
                     jm.payload["norms"])
        jr = jalgo.receive(jm, k3)
        rs = [talgo.receive(m, t3) for m in msgs[::-1]]
        assert all(r is None for r in rs[:-1])
        assert (jr is None) == (rs[-1] is None)
        if jr is not None:
            flushes += 1
            assert rs[-1].wire_bytes == jr.wire_bytes
            assert _same(rs[-1].payload["packed"], jr.payload["packed"])
            assert _same(rs[-1].payload["norms"], jr.payload["norms"])
        assert _states_equal(jalgo, talgo), u
    assert flushes == 2
    assert talgo.meter.summary() == jalgo.meter.summary()
    assert talgo.staleness.summary() == jalgo.staleness.summary()


def test_interleaved_streams_at_one_version_match_reference():
    """Three clients stream at the same version (a row per chunk), their
    chunks interleaved: no stream completes from another's chunks (A's
    rows 0 and 2 with B's row 1 would cover a message), each completes on
    its own last row, and the server ends as the reference's does after
    ``run_client`` uploads received in the streams' completion order:
    the broadcast, the state and the meters."""
    jalgo, talgo = _quad_pair(1)
    rng = np.random.default_rng(13)
    key, tkey = jax.random.PRNGKey(13), prng.PRNGKey(13)
    jmsgs, streams = [], []
    for cid in range(3):
        key, k2 = jax.random.split(key)
        tkey, t2 = prng.split(tkey)
        target = np.broadcast_to(rng.standard_normal(D).astype(np.float32),
                                 (2, D)).copy()
        jmsgs.append(jalgo.run_client({"target": jnp.asarray(target)},
                                      k2)[0])
        msgs, _ = talgo.run_client_stream(
            {"target": torch.from_numpy(target)}, t2, client=cid)
        assert len(msgs) == 3
        assert all(m.meta["client"] == cid for m in msgs)
        streams.append(msgs)
    assert len({m[0].meta["stream"] for m in streams}) == 3
    a, b, c = streams
    order = [a[0], b[1], a[2], c[1], b[0], c[0], b[2], a[1], c[2]]
    done = {6: 1, 7: 0, 8: 2}  # position in ``order`` -> client completed
    key, k3 = jax.random.split(key)
    tkey, t3 = prng.split(tkey)
    for i, m in enumerate(order):
        r = talgo.receive(m, t3)
        assert talgo.meter.uploads == sum(j <= i for j in done), i
        if i in done:
            jr = jalgo.receive(jmsgs[done[i]], k3)
            assert (r is None) == (jr is None)
        else:
            assert r is None
    assert jr is not None and r is not None
    assert _same(r.payload["packed"], jr.payload["packed"])
    assert _states_equal(jalgo, talgo) and talgo.state.t == 1
    assert talgo.meter.summary() == jalgo.meter.summary()
    assert not talgo._pending_chunks


def test_malformed_stream_leaves_the_server_as_it_was():
    """A stream whose rows add up with a chunk twice (rows 0, 0, 1 of
    three) completes, fails validation and raises before the meters, the
    staleness monitor, the telemetry or the buffer change; the stream is
    discarded."""
    from repro_torch.obs import RunTracer

    _, talgo = _quad_pair(1)
    talgo.telemetry = RunTracer(taps=False)
    msgs, _ = talgo.run_client_stream({"target": torch.ones(2, D)},
                                      prng.PRNGKey(3), client=7)
    meters = talgo.meter.summary()
    stale = talgo.staleness.summary()
    assert talgo.receive(msgs[0], prng.PRNGKey(4)) is None
    assert talgo.receive(msgs[0], prng.PRNGKey(4)) is None
    with pytest.raises(ValueError, match="gap or overlap"):
        talgo.receive(msgs[1], prng.PRNGKey(4))
    assert talgo.meter.summary() == meters
    assert talgo.staleness.summary() == stale
    assert len(talgo.telemetry.events()) == 0
    assert talgo.buffer.count == 0 and talgo.buffer.layout is None
    assert not talgo._pending_chunks


def test_chunk_rows_run_client_matches_reference():
    """``QAFeL(chunk_rows=)``'s ``run_client`` (the delta formed and
    encoded a row at a time) against the reference's unchunked server."""
    jalgo, talgo = _quad_pair(1)
    rng = np.random.default_rng(12)
    key, tkey = jax.random.PRNGKey(12), prng.PRNGKey(12)
    for _ in range(6):
        key, k2, k3 = jax.random.split(key, 3)
        tkey, t2, t3 = prng.split(tkey, 3)
        target = np.broadcast_to(rng.standard_normal(D).astype(np.float32),
                                 (2, D)).copy()
        jm, _ = jalgo.run_client({"target": jnp.asarray(target)}, k2)
        tm, _ = talgo.run_client({"target": torch.from_numpy(target)}, t2)
        assert _same(tm.payload["packed"], jm.payload["packed"])
        jalgo.receive(jm, k3)
        talgo.receive(tm, t3)
    assert _states_equal(jalgo, talgo) and talgo.state.t == 2


def test_streamed_upload_cnn_matches_run_client():
    """The paper's CNN (18 leaves, 624 rows): ``run_client_stream`` in
    chunks of 100 rows, then ``receive``, against the port's own
    ``run_client`` on a second server: every upload's codes, the
    broadcasts, the state and the meters."""
    from repro_torch.examples.cohort_scenarios import cnn_task, qafel_config

    task = cnn_task("cpu", samples=200)
    qcfg = qafel_config(buffer=2)
    a = QAFeL(qcfg, task.loss_fn, task.params0, device="cpu")
    b = QAFeL(qcfg, task.loss_fn, task.params0, device="cpu")
    key = prng.PRNGKey(5)
    for cid in range(4):
        key, k2, k3 = prng.split(key, 3)
        batches = task.client_batches(cid % 20, None)
        ma, _ = a.run_client(batches, k2)
        msgs, _ = b.run_client_stream(batches, k2, chunk_rows=100)
        assert len(msgs) == 7
        assert _same(torch.cat([m.payload["packed"] for m in msgs]),
                     ma.payload["packed"])
        ra = a.receive(ma, k3)
        rb = [b.receive(m, k3) for m in msgs][-1]
        assert (ra is None) == (rb is None)
        if ra is not None:
            assert _same(ra.payload["packed"], rb.payload["packed"])
    assert a.state.t == b.state.t == 2
    for f in ("x_flat", "hidden_flat", "momentum_flat"):
        assert _same(getattr(a.state, f), getattr(b.state, f))
    assert a.meter.summary() == b.meter.summary()


def test_run_client_stream_refusals():
    _, talgo = _quad_pair(None)
    batches = {"target": torch.zeros(2, D)}
    with pytest.raises(ValueError, match="chunk_rows"):
        talgo.run_client_stream(batches, prng.PRNGKey(0))
    with pytest.raises(ValueError, match="chunk_rows"):
        talgo.run_client_stream(batches, prng.PRNGKey(0), chunk_rows=0)
    with pytest.raises(ValueError, match="chunk_rows"):
        QAFeL(QAFeLConfig(**QCFG), _tquad_loss, {"w": torch.zeros(D)},
              device="cpu", chunk_rows=0)
    lr = QAFeL(QAFeLConfig(**dict(QCFG, client_quantizer="lowrank4g32")),
               _tquad_loss, {"w": torch.zeros(D)}, device="cpu")
    with pytest.raises(ValueError, match="qsgd"):
        lr.run_client_stream(batches, prng.PRNGKey(0), chunk_rows=1)


# ---------------------------------------------------------------------------
# add_encoded_chunks' refusals
# ---------------------------------------------------------------------------


def _stream_chunks(n=D, bits=4, c=1, layout=None):
    layout = layout or TreeLayout.of({"w": torch.zeros(n)})
    flat = torch.from_numpy(_flat(n, 4))
    rows = tops.rows_for(n)
    out = []
    for i, r0 in enumerate(range(0, rows, c)):
        p, nm = tops.qsgd_quantize_chunk(flat[r0 * 128:(r0 + c) * 128],
                                         prng.PRNGKey(1), r0, bits=bits,
                                         total_rows=rows)
        out.append(packed_qsgd_chunk_payload(p, nm, bits, n, layout, row0=r0,
                                             seq=i, last=r0 + c >= rows))
    return out


def _refusals():
    ch = _stream_chunks()
    other = TreeLayout.of({"v": torch.zeros(D)})
    whole = dict(ch[0], format="packed")
    return {
        "empty": ([], "empty"),
        "gap": ([ch[0], ch[2]], "gap"),
        "duplicate": ([ch[0], ch[0], ch[1], ch[2]], "gap or overlap"),
        "layout": ([ch[0], dict(ch[1], layout=other), ch[2]], "inconsistent"),
        "n": ([ch[0], dict(ch[1], n=D + 1), ch[2]], "inconsistent"),
        "bits": ([ch[0], dict(ch[1], bits=2), ch[2]], "inconsistent"),
        "short": (ch[:2], "covers"),
        "not_chunk": ([whole, ch[1], ch[2]], "packed_chunk"),
        "rows": ([ch[0], dict(ch[1], rows=2), ch[2]], "corrupt"),
    }


@pytest.mark.parametrize("case", sorted(_refusals()))
def test_add_encoded_chunks_refusals(case):
    chunks, match = _refusals()[case]
    buf = UpdateBuffer(capacity=3, quantizer=make_quantizer("qsgd4"))
    with pytest.raises(ValueError, match=match):
        buf.add_encoded_chunks(chunks)
    assert buf.count == 0 and buf.layout is None


def test_add_encoded_chunks_refuses_a_window_mismatch():
    """A stream of another layout or bits than the window's uploads, and
    any stream into a non-qsgd buffer."""
    buf = UpdateBuffer(capacity=3, quantizer=make_quantizer("qsgd4"))
    buf.add_encoded_chunks(_stream_chunks()[::-1])
    other = TreeLayout.of({"v": torch.zeros(D)})
    with pytest.raises(ValueError, match="layout mismatch"):
        buf.add_encoded_chunks(_stream_chunks(layout=other))
    with pytest.raises(ValueError, match="bits mismatch"):
        buf.add_encoded_chunks(_stream_chunks(bits=2))
    assert buf.count == 1
    lr = UpdateBuffer(capacity=3, quantizer=make_quantizer("top_k0.1"))
    with pytest.raises(ValueError, match="qsgd"):
        lr.add_encoded_chunks(_stream_chunks())
    assert lr.count == 0


def test_add_encoded_chunks_stores_the_whole_upload():
    """Chunks in any order are stored as the unstreamed upload would be:
    the window's stack equals ``add_encoded`` of the whole message."""
    flat = torch.from_numpy(_flat(D, 4))
    layout = TreeLayout.of({"w": torch.zeros(D)})
    p, nm = tops.qsgd_quantize(flat, prng.PRNGKey(1), 4)
    a = UpdateBuffer(capacity=1, quantizer=make_quantizer("qsgd4"))
    b = UpdateBuffer(capacity=1, quantizer=make_quantizer("qsgd4"))
    a.add_encoded({"format": "packed", "kind": "qsgd", "packed": p,
                   "norms": nm, "bits": 4, "n": D, "layout": layout},
                  weight=0.5)
    chunks = _stream_chunks(c=2)
    b.add_encoded_chunks([chunks[1], chunks[0]], weight=0.5)
    ba, bb = a.drain(), b.drain()
    assert _same(ba.stack, bb.stack) and _same(ba.norms, bb.norms)
    assert _same(ba.weights, bb.weights) and ba.n == bb.n
