"""The port's top_k / rand_k messages in both directions against the JAX
package's, on the CPU.

Bit for bit (``np.array_equal`` on the bit patterns): ``prng.choice``
against ``jax.random.choice(replace=False)`` at n = 1,000 (one shuffle
round), 2,048 and 79,842 (two rounds); top_k with forced magnitude ties
and rand_k (scaled and not) at those sizes, their ``encode_flat``,
``encode_batch``, ``decode_flat``; the buffer's scatter-add drain of a
sparse window; the quad's (d = 2048) sequential engine, 40 uploads,
qsgd4 clients under a ``top_k0.1`` server and ``rand_k0.1`` clients under
a qsgd4 server (x, x-hat, momentum, every broadcast, every metric but the
hidden drift, which is compared within 1e-6 relative), and the cohort
engine, cohorts of 4, ``top_k0.1`` clients under a ``rand_k0.1`` server.

Within a stated tolerance: the paper's CNN (SyntheticCelebA(200), 20
clients, K = 10, 20 uploads) with qsgd4 clients under a ``top_k0.1``
server, whose gradients agree with the reference's only to f32 rounding
(tests/test_torch_sim.py): traffic, staleness and the event timeline
exactly, replicas in sync, accuracy within 0.05 absolute.

Lowrank uploads under a top_k or rand_k server are bit for bit too: the
reference's non-fused flush decodes the window op by op, dividing by s,
and the port's chain takes K3's eager variant there."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import QAFeL as JQAFeL
from repro.core import QAFeLConfig as JConfig
from repro.core import quantizers as J
from repro.core.buffer import UpdateBuffer as JBuffer
from repro.data import FederatedPartition as JPartition
from repro.data import SyntheticCelebA as JCelebA
from repro.models.cnn import cnn_accuracy as jaccuracy
from repro.models.cnn import cnn_loss as jcnn_loss
from repro.models.cnn import init_cnn as jinit
from repro.sim import AsyncFLSimulator as JSeq
from repro.sim import CohortAsyncFLSimulator as JCohort
from repro.sim import SimConfig as JSimConfig
from repro_torch.common import prng
from repro_torch.convert import params_from_jax
from repro_torch.core import QAFeL, QAFeLConfig
from repro_torch.core import quantizers as T
from repro_torch.core.buffer import UpdateBuffer
from repro_torch.examples import cohort_scenarios, federated_celeba
from repro_torch.sim import AsyncFLSimulator, CohortAsyncFLSimulator, SimConfig

D = cohort_scenarios.QUAD_D
SIZES = (1000, 2048, 79_842)
QCFG = dict(client_lr=0.05, server_lr=1.0, server_momentum=0.3, local_steps=2,
            buffer_size=4)


@pytest.fixture(scope="module", autouse=True)
def _cold_jax_caches_after():
    """This module compiles the reference's jitted entries (the client
    step, the flush) on the quad's shapes. Clearing JAX's caches when it
    is done leaves a later test in the same process that expects a cold
    compile (the reference's compile watch and trace counters) a cold
    cache."""
    yield
    jax.clear_caches()


def _bits(a) -> np.ndarray:
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(a, b) -> bool:
    a, b = _bits(a), _bits(b)
    return a.shape == b.shape and np.array_equal(a, b)


def _vector(n: int, seed: int = 0) -> np.ndarray:
    """Random values with forced magnitude ties (+-0.5 in blocks, zeros)."""
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    x[: n // 20] = 0.5
    x[n // 20: n // 10: 2] = -0.5
    x[-n // 50:] = 0.0
    return x


@pytest.mark.parametrize("n", SIZES)
def test_choice_matches_reference(n):
    k = -(-n // 10)
    for seed in (7, 123):
        want = jax.random.choice(jax.random.PRNGKey(seed), n, (k,),
                                 replace=False)
        got = prng.choice(prng.PRNGKey(seed), n, k)
        assert np.array_equal(np.asarray(want), got.numpy())
    assert prng._shuffle_rounds(n) == (1 if n == 1000 else 2)
    perm = prng.permutation(prng.PRNGKey(1), n)
    assert torch.equal(torch.sort(perm).values, torch.arange(n))
    with pytest.raises(ValueError):
        prng.choice(prng.PRNGKey(1), n, n + 1)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", ["top_k0.1", "rand_k0.1", "rand_k0.05"])
def test_encode_decode_match_reference(name, n):
    x = _vector(n, n)
    jflat, jlayout = J.flatten_tree({"w": jnp.asarray(x)})
    tflat, tlayout = T.flatten_tree({"w": torch.from_numpy(x)})
    jq, tq = J.make_quantizer(name), T.make_quantizer(name)
    jenc = jq.encode_flat(jflat, jlayout, jax.random.PRNGKey(5))
    tenc = tq.encode_flat(tflat, tlayout, prng.PRNGKey(5))
    assert tenc["kind"] == jenc["kind"] and tenc["n"] == jenc["n"] == n
    assert tenc["idx"].dtype == torch.int32
    assert _same(jenc["idx"], tenc["idx"]) and _same(jenc["vals"],
                                                     tenc["vals"])
    assert _same(jq.decode_flat(jenc), tq.decode_flat(tenc))
    assert _same(jq.decode(jenc)["w"], tq.decode(tenc)["w"])


def test_unscaled_rand_k_matches_reference():
    x = _vector(2048)
    spec = dict(kind="rand_k", fraction=0.2, scaled=False)
    jq, tq = J.Quantizer(J.QuantizerSpec(**spec)), T.Quantizer(
        T.QuantizerSpec(**spec))
    jflat, jlayout = J.flatten_tree({"w": jnp.asarray(x)})
    tflat, tlayout = T.flatten_tree({"w": torch.from_numpy(x)})
    jenc = jq.encode_flat(jflat, jlayout, jax.random.PRNGKey(2))
    tenc = tq.encode_flat(tflat, tlayout, prng.PRNGKey(2))
    assert _same(jenc["vals"], tenc["vals"])
    assert _same(jq.qdq_flat(jflat, jax.random.PRNGKey(3)),
                 tq.qdq_flat(tflat, prng.PRNGKey(3)))


@pytest.mark.parametrize("name", ["top_k0.1", "rand_k0.1", "qsgd4",
                                  "identity"])
def test_encode_batch_matches_reference(name):
    b = 3
    x = np.stack([_vector(1000, s) for s in range(b)])
    tree_j = {"a": jnp.asarray(x[:, :300].reshape(b, 30, 10)),
              "b": jnp.asarray(x[:, 300:])}
    tree_t = {"a": torch.from_numpy(x[:, :300].reshape(b, 30, 10)),
              "b": torch.from_numpy(x[:, 300:])}
    jkeys = jax.random.split(jax.random.PRNGKey(9), b)
    tkeys = prng.split(prng.PRNGKey(9), b)
    jencs = J.make_quantizer(name).encode_batch(tree_j, jkeys)
    tencs = T.make_quantizer(name).encode_batch(tree_t, tkeys)
    fields = {"top_k0.1": ("idx", "vals"), "rand_k0.1": ("idx", "vals"),
              "qsgd4": ("packed", "norms"), "identity": ("payload",)}[name]
    for jenc, tenc in zip(jencs, tencs):
        for f in fields:
            assert _same(jenc[f], tenc[f]), f
    one_j = J.make_quantizer(name).encode_batch(
        {"w": jnp.asarray(x[:1])}, jkeys[:1])[0]
    one_t = T.make_quantizer(name).encode_batch(
        {"w": torch.from_numpy(x[:1])}, tkeys[:1])[0]
    for f in fields:
        assert _same(one_j[f], one_t[f]), f


@pytest.mark.parametrize("name", ["top_k0.1", "rand_k0.1"])
def test_buffer_scatter_add_drain_matches_reference(name):
    """K sparse uploads with overlapping indices and staleness weights,
    and one decoded tier upload: the drained flat ``extra`` is the
    reference's, bit for bit."""
    k, n = 5, 2048
    jq, tq = J.make_quantizer(name), T.make_quantizer(name)
    jbuf, tbuf = JBuffer(capacity=k + 1, quantizer=jq), UpdateBuffer(
        capacity=k + 1, quantizer=tq)
    for i in range(k):
        x = _vector(n, 10 + i)
        w = 1.0 / np.sqrt(1.0 + i)
        jflat, jlayout = J.flatten_tree({"w": jnp.asarray(x)})
        tflat, tlayout = T.flatten_tree({"w": torch.from_numpy(x)})
        jbuf.add_encoded(jq.encode_flat(jflat, jlayout,
                                        jax.random.PRNGKey(i)), weight=w)
        tbuf.add_encoded(tq.encode_flat(tflat, tlayout, prng.PRNGKey(i)),
                         weight=w)
    extra = _vector(n, 99) * 0.1
    jbuf.add_decoded_flat(jnp.asarray(extra), 0.5, layout=jlayout)
    tbuf.add_decoded_flat(torch.from_numpy(extra), 0.5, layout=tlayout)
    jb, tb = jbuf.drain(), tbuf.drain()
    assert tb.stack is None and jb.stack is None
    assert _same(jb.extra, tb.extra)
    assert _same(jb.reduce(), tb.reduce())


def _quad_run(cq, sq, *, engine="sequential", cohort_size=1, uploads=40,
              taps=False):
    """Both packages' engines on the quad task, with taps-on tracers when
    ``taps`` (``algo.telemetry``); returns (jalgo, jres, jsent, talgo,
    tres, tsent)."""
    from repro.obs import RunTracer as JRunTracer
    from repro_torch.obs import RunTracer

    wstar = cohort_scenarios.quad_optimum()

    def jbatches(cids, keys):
        return {"target": jnp.asarray(
            cohort_scenarios.quad_targets(wstar, cids))}
    jbatches.batched = True

    def jbatch1(cid, key):
        return {"target": jnp.asarray(
            cohort_scenarios.quad_targets(wstar, [cid])[0])}

    def jeval(p):
        return float(1.0 - np.linalg.norm(np.asarray(p["w"]) - wstar)
                     / np.linalg.norm(wstar))

    def jloss(params, batch, key):
        del key
        return jnp.sum((params["w"] - batch["target"]) ** 2)

    def record(algo, sent):
        inner = algo.receive

        def receive(msg, key, n_receivers=1):
            bmsg = inner(msg, key, n_receivers)
            if bmsg is not None:
                sent.append(bmsg.payload)
            return bmsg
        algo.receive = receive

    kw = dict(QCFG, client_quantizer=cq, server_quantizer=sq)
    scfg = dict(concurrency=8, max_uploads=uploads, eval_every_steps=3,
                seed=0)
    jalgo = JQAFeL(JConfig(**kw), jloss, {"w": jnp.zeros((D,), jnp.float32)},
                   telemetry=JRunTracer(taps=True) if taps else None)
    jsent = []
    record(jalgo, jsent)
    task = cohort_scenarios.quad_task("cpu")
    stacked = task.client_batches

    def one(cid, key):
        return {k: v[0] for k, v in stacked([cid], [key]).items()}

    talgo = QAFeL(QAFeLConfig(**kw), task.loss_fn, task.params0,
                  device="cpu",
                  telemetry=RunTracer(taps=True) if taps else None)
    tsent = []
    record(talgo, tsent)
    if engine == "sequential":
        jres = JSeq(jalgo, JSimConfig(**scfg), jbatch1, jeval).run()
        tres = AsyncFLSimulator(talgo, SimConfig(**scfg), one,
                                task.eval_fn).run()
    else:
        big = cohort_size > 1
        jres = JCohort(jalgo, JSimConfig(**scfg), jbatches if big else
                       jbatch1, jeval, cohort_size=cohort_size).run()
        tres = CohortAsyncFLSimulator(
            talgo, SimConfig(**scfg), stacked if big else one, task.eval_fn,
            cohort_size=cohort_size).run()
    return jalgo, jres, jsent, talgo, tres, tsent


PAYLOAD_FIELDS = ("packed", "norms", "idx", "vals", "payload")


def assert_same_run(run, *, drift_rel=1e-6):
    jalgo, jres, jsent, talgo, tres, tsent = run
    for name in ("x_flat", "hidden_flat", "momentum_flat"):
        assert _same(getattr(jalgo.state, name),
                     getattr(talgo.state, name)), name
    assert len(tsent) == len(jsent) == jalgo.state.t > 0
    for jp, tp in zip(jsent, tsent):
        assert jp["kind"] == tp["kind"]
        for f in PAYLOAD_FIELDS:
            if f in jp:
                assert _same(jp[f], tp[f]), f
    jm, tm = jres.metrics, tres.metrics
    assert set(jm) == set(tm)
    for key in jm:
        if key.startswith(("upload/", "flush/")):  # tap series: rtol 1e-5
            np.testing.assert_allclose(tm[key], jm[key], rtol=1e-5, atol=0)
        elif key != "hidden_drift":
            assert tm[key] == jm[key], key
    assert tm["hidden_drift"] == pytest.approx(jm["hidden_drift"],
                                               rel=drift_rel)
    assert tres.sim_time == jres.sim_time
    assert tm["replicas_in_sync"]


@pytest.mark.parametrize("cq,sq", [("qsgd4", "top_k0.1"),
                                   ("rand_k0.1", "qsgd4")])
def test_quad_sequential_engine_matches_reference(cq, sq):
    run = _quad_run(cq, sq)
    assert_same_run(run)
    tm = run[4].metrics
    if sq == "top_k0.1":  # 205 pairs of 64 bits per broadcast
        assert tm["kB_per_broadcast"] == pytest.approx(64 * 205 / 8 / 1e3)
    else:
        assert tm["kB_per_upload/rand_k"] == pytest.approx(64 * 205 / 8
                                                           / 1e3)


def test_quad_cohort_engine_sparse_both_ways():
    assert_same_run(_quad_run("top_k0.1", "rand_k0.1", engine="cohort",
                              cohort_size=4))


def test_lowrank_uploads_under_top_k_server_within_tolerance():
    """The non-fused flush chain over a lowrank window, in the reference's
    op-by-op order (K3's eager decode): bit for bit. (Held within atol
    1e-6 until the eager decode existed; the name is kept.)"""
    run = _quad_run("lowrank4g32", "top_k0.1")
    assert_same_run(run)
    assert run[4].metrics["kB_per_upload/lowrank4g32"] > 0


def test_lowrank_cohorts_under_rand_k_server_match_reference():
    """Lowrank cohorts of 4 under a rand_k0.1 server, the non-fused chain
    at K = 4 with mixed basis seeds: bit for bit."""
    assert_same_run(_quad_run("lowrank4g32", "rand_k0.1", engine="cohort",
                              cohort_size=4))


# ---------------------------------------------------------------------------
# The paper's CNN: traffic and staleness
# ---------------------------------------------------------------------------

N_SAMPLES, N_CLIENTS, UPLOADS = 200, 20, 20


@pytest.fixture
def one_torch_thread():
    """The CNN runs thousands of small ops; beside other test processes,
    torch's thread pool would spin on every one of them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_cnn_run(params0, scfg, cq, sq):
    ds = JCelebA(n_samples=N_SAMPLES)
    part = JPartition(labels=ds.labels, n_clients=N_CLIENTS)
    rng = np.random.default_rng(0)

    def loss_fn(params, batch, key):
        return jcnn_loss(params, batch, train=True, key=key)[0]

    def client_batches(cid, key):
        b = [part.client_batch(ds, cid, 8, rng) for _ in range(2)]
        return {k: jnp.stack([jnp.asarray(bi[k]) for bi in b]) for k in b[0]}

    test_idx = part.split_indices(part.val_clients)[:512]
    test = {k: jnp.asarray(v) for k, v in ds.batch(test_idx).items()}
    cfg = JConfig(client_lr=0.05, server_lr=1.0, server_momentum=0.3,
                  buffer_size=10, local_steps=2, client_quantizer=cq,
                  server_quantizer=sq)
    return JSeq(JQAFeL(cfg, loss_fn, params0), scfg, client_batches,
                jax.jit(lambda p: jaccuracy(p, test))).run()


def test_cnn_top_k_server_traffic_and_staleness_match_reference(
        one_torch_thread):
    params0 = jinit(jax.random.PRNGKey(0))
    kw = dict(concurrency=16, max_uploads=UPLOADS, eval_every_steps=3)
    jres = _jax_cnn_run(params0, JSimConfig(**kw), "qsgd4", "top_k0.1")
    task = federated_celeba.celeba_task("cpu", n_samples=N_SAMPLES,
                                        n_clients=N_CLIENTS)
    tres = federated_celeba.run_one(
        task, params_from_jax(jax.tree.map(np.asarray, params0), device="cpu"),
        federated_celeba.qafel_config("qsgd4", "top_k0.1"), SimConfig(**kw),
        "cpu")
    jm, tm = jres.metrics, tres.metrics
    assert tm["replicas_in_sync"] and jm["replicas_in_sync"]
    assert tres.server_steps == jres.server_steps == UPLOADS // 10
    assert tm["kB_per_broadcast"] == jm["kB_per_broadcast"] == 63.88
    for key in jm:
        if key not in ("hidden_drift", "replicas_in_sync"):
            assert tm[key] == jm[key], key
    assert tres.final_accuracy == pytest.approx(jres.final_accuracy, abs=0.05)
    assert tres.sim_time == jres.sim_time
