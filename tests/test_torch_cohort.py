"""The port's cohort engine (repro_torch.sim.cohort and the modules under
it) against the JAX package's, on the CPU.

Bit for bit (``np.array_equal`` on the f32 bit patterns, signed zeros
included): the scenario draws; the quad task's (d = 2048) cohort step at
b = 4 in qsgd2/4/8 and identity; member chunking on the quad; the cohort
engine at ``cohort_size`` 1 and 4 under ``identity``, ``lognormal_dropout``
and ``tiered_bits`` (x, x-hat, momentum, every broadcast's codes and
norms, traffic, staleness, dropped uploads, sim clock); the cohort engine
at ``cohort_size=1`` against the port's own sequential engine on the CNN;
a mixed-tier window through the server; the vmapped dropout masks.

Within a stated tolerance: the CNN's per-member gradients under vmap and
the deltas of two SGD steps built from them, rtol 1e-5 and atol 1e-6, as
in tests/test_torch_cnn.py (XLA's and ATen's convolutions sum in other
orders); the CNN at b = 4 through both engines,
traffic and staleness exact, accuracy within 0.05 absolute, as in
tests/test_torch_sim.py; member chunking on the CNN, which changes the
batch the vmapped convolutions see and so their rounding: atol 1e-6 on
the deltas (observed 1.2e-7)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import QAFeL as JQAFeL
from repro.core import QAFeLConfig as JConfig
from repro.core import hidden_apply as jhidden_apply
from repro.core import server_broadcast_delta as jserver_broadcast_delta
from repro.core.protocol import CLIENT_UPDATE as J_UPDATE
from repro.core.protocol import Message as JMessage
from repro.core.quantizers import flatten_tree as jflatten
from repro.core.quantizers import make_quantizer as jmake_quantizer
from repro.core.quantizers import packed_qsgd_payload as jqsgd
from repro.data import FederatedPartition as JPartition
from repro.data import SyntheticCelebA as JCelebA
from repro.kernels import ops as jops
from repro.models.cnn import cnn_accuracy as jaccuracy
from repro.models.cnn import cnn_loss as jloss
from repro.models.cnn import init_cnn as jinit
from repro.sim import CohortAsyncFLSimulator as JCohort
from repro.sim import SimConfig as JSimConfig
from repro.sim import scenarios as jscenarios
from repro_torch.common import prng
from repro_torch.common.tree import tree_leaves
from repro_torch.convert import params_from_jax
from repro_torch.core import (QAFeL, QAFeLConfig, hidden_apply,
                              make_quantizer, server_broadcast_delta)
from repro_torch.core.protocol import CLIENT_UPDATE, Message
from repro_torch.core.qafel import client_update_flat
from repro_torch.core.quantizers import flatten_tree, packed_qsgd_payload
from repro_torch.data import FederatedPartition, SyntheticCelebA
from repro_torch.examples import cohort_scenarios, federated_celeba
from repro_torch.models.cnn import DROPOUT, cnn_accuracy, cnn_loss
from repro_torch.sim import (AsyncFLSimulator, CohortAsyncFLSimulator,
                             SimConfig, scenarios)
from repro_torch.sim.cohort import auto_member_chunk

RTOL, ATOL = 1e-5, 1e-6
D = cohort_scenarios.QUAD_D


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The CNN runs thousands of small ops; beside other test processes,
    torch's thread pool would spin on every one of them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bits(a) -> np.ndarray:
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(a, b) -> bool:
    a, b = _bits(a), _bits(b)
    return a.shape == b.shape and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# Scenarios
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(jscenarios.SCENARIOS))
def test_scenario_draws_match_reference(name):
    """Every preset: the same config, rate and draws, in the cohort
    engine's order, from one generator each."""
    jcfg, tcfg = jscenarios.get_scenario(name), scenarios.get_scenario(name)
    assert tcfg.__dict__ == jcfg.__dict__ and set(scenarios.SCENARIOS) == \
        set(jscenarios.SCENARIOS)
    js = jscenarios.ScenarioSampler(jcfg, 100, np.random.default_rng(5))
    ts = scenarios.ScenarioSampler(tcfg, 100, np.random.default_rng(5))
    assert ts.rate == js.rate
    for size in (1, 4, 7, 32):
        for draw in ("interarrivals", "tier_indices", "durations",
                     "dropouts"):
            want, got = getattr(js, draw)(size), getattr(ts, draw)(size)
            assert want.dtype == got.dtype and np.array_equal(want, got), \
                (draw, size)


# ---------------------------------------------------------------------------
# The cohort step on the quad task
# ---------------------------------------------------------------------------


def _jquad_loss(params, batch, key):
    del key
    return jnp.sum((params["w"] - batch["target"]) ** 2)


def _quad_inputs(b):
    wstar = cohort_scenarios.quad_optimum()
    targets = cohort_scenarios.quad_targets(wstar, range(3, 3 + b))
    w0 = (wstar * 0.3).astype(np.float32)
    jkeys = jax.random.split(jax.random.PRNGKey(11), 2 * b).reshape(b, 2, 2)
    tkeys = torch.from_numpy(np.asarray(jkeys).astype(np.int64))
    return w0, targets, jkeys, tkeys


QCFG = dict(client_lr=0.05, server_lr=1.0, server_momentum=0.3, local_steps=2)


@pytest.mark.parametrize("qname", ["qsgd2", "qsgd4", "qsgd8", "identity"])
def test_cohort_step_matches_reference(qname):
    b = 4
    w0, targets, jkeys, tkeys = _quad_inputs(b)
    jflat, jlayout = jflatten({"w": jnp.asarray(w0)})
    tflat, tlayout = flatten_tree({"w": torch.from_numpy(w0)})
    jout = jops.cohort_train_encode_step(
        _jquad_loss, JConfig(**QCFG), jmake_quantizer(qname).spec, jlayout,
        jflat, {"target": jnp.asarray(targets)}, jkeys[:, 0], jkeys[:, 1],
        jnp.asarray(True), b=b)
    tout = client_update_flat(
        cohort_scenarios.quad_loss, QAFeLConfig(**QCFG),
        make_quantizer(qname).spec, tlayout, tflat,
        {"target": torch.from_numpy(targets)}, tkeys[:, 0], tkeys[:, 1], b=b)
    assert set(jout) == set(tout)
    for name in tout:
        assert _same(jout[name], tout[name]), name


@pytest.mark.parametrize("chunk", [1, 2, 3])
def test_member_chunk_is_bit_invisible(chunk):
    """On the quad, members trained ``chunk`` at a time give the bits of
    the whole-cohort vmap: codes, norms and the identity deltas."""
    b = 5
    w0, targets, _, tkeys = _quad_inputs(b)
    flat, layout = flatten_tree({"w": torch.from_numpy(w0)})
    for qname in ("qsgd4", "identity"):
        args = (cohort_scenarios.quad_loss, QAFeLConfig(**QCFG),
                make_quantizer(qname).spec, layout, flat,
                {"target": torch.from_numpy(targets)}, tkeys[:, 0],
                tkeys[:, 1])
        whole = client_update_flat(*args, b=b)
        chunked = client_update_flat(*args, b=b, member_chunk=chunk)
        for name in whole:
            assert _same(whole[name], chunked[name]), (qname, name)


def test_auto_member_chunk_policy():
    """One rule on every device: the whole cohort in one vmap while b
    members of ``_BYTES_PER_MEMBER_PARAM * d`` bytes fit in half the free
    memory, else as many members as fit, at least one."""
    from repro_torch.sim.cohort import _BYTES_PER_MEMBER_PARAM as per
    cnn = 79_842
    assert auto_member_chunk(1, 10**8, free_bytes=0) is None
    assert auto_member_chunk(32, cnn, free_bytes=2 * 32 * cnn * per) is None
    assert auto_member_chunk(32, cnn, free_bytes=2 * 32 * cnn * per - 1) \
        == 31
    assert auto_member_chunk(32, cnn, free_bytes=2 * 5 * cnn * per) == 5
    assert auto_member_chunk(32, cnn, free_bytes=0) == 1
    assert auto_member_chunk(32, cnn, "cpu") in (None, *range(1, 33))


# ---------------------------------------------------------------------------
# The engine on the quad task, against the reference's engine
# ---------------------------------------------------------------------------


def _record_broadcasts(algo, out):
    inner = algo.receive

    def receive(msg, key, n_receivers=1):
        bmsg = inner(msg, key, n_receivers)
        if bmsg is not None:
            out.append(bmsg.payload)
        return bmsg

    algo.receive = receive


def _jquad_run(scenario, cohort_size, uploads):
    wstar = cohort_scenarios.quad_optimum()

    def batches(cids, keys):
        return {"target": jnp.asarray(
            cohort_scenarios.quad_targets(wstar, cids))}
    batches.batched = True

    def batch1(cid, key):
        return {"target": jnp.asarray(
            cohort_scenarios.quad_targets(wstar, [cid])[0])}

    def eval_fn(p):
        return float(1.0 - np.linalg.norm(np.asarray(p["w"]) - wstar)
                     / np.linalg.norm(wstar))

    algo = JQAFeL(JConfig(**QCFG, buffer_size=4), _jquad_loss,
                  {"w": jnp.zeros((D,), jnp.float32)})
    sent = []
    _record_broadcasts(algo, sent)
    res = JCohort(algo, JSimConfig(concurrency=8, max_uploads=uploads,
                                   eval_every_steps=3, seed=0),
                  batches if cohort_size > 1 else batch1, eval_fn,
                  scenario=scenario, cohort_size=cohort_size).run()
    return algo, res, sent


@pytest.mark.parametrize("cohort_size", [1, 4])
@pytest.mark.parametrize("scenario",
                         ["identity", "lognormal_dropout", "tiered_bits"])
def test_quad_engine_matches_reference(scenario, cohort_size):
    uploads = 40
    jalgo, jres, jsent = _jquad_run(scenario, cohort_size, uploads)
    task = cohort_scenarios.quad_task("cpu")
    if cohort_size == 1:  # the reference's run feeds unstacked batches
        stacked = task.client_batches

        def one(cid, key):
            return {k: v[0] for k, v in stacked([cid], [key]).items()}
        task = task._replace(client_batches=one)
    talgo = QAFeL(cohort_scenarios.qafel_config(4), task.loss_fn,
                  task.params0, device="cpu")
    tsent = []
    _record_broadcasts(talgo, tsent)
    tres = CohortAsyncFLSimulator(
        talgo, SimConfig(concurrency=8, max_uploads=uploads,
                         eval_every_steps=3, seed=0),
        task.client_batches, task.eval_fn, scenario=scenario,
        cohort_size=cohort_size).run()
    for name in ("x_flat", "hidden_flat", "momentum_flat"):
        assert _same(getattr(jalgo.state, name),
                     getattr(talgo.state, name)), name
    assert len(tsent) == len(jsent) == jalgo.state.t > 0
    for jp, tp in zip(jsent, tsent):
        assert _same(jp["packed"], tp["packed"])
        assert _same(jp["norms"], tp["norms"])
    jm, tm = jres.metrics, tres.metrics
    assert set(jm) == set(tm)
    for key in jm:
        if key != "hidden_drift":
            assert tm[key] == jm[key], key
    assert tres.sim_time == jres.sim_time
    assert tres.uploads == jres.uploads == uploads
    if scenario == "tiered_bits":
        assert tm["kB_per_upload/qsgd2"] > 0  # the tier decode ran
    if scenario == "lognormal_dropout":
        assert tm["dropped_uploads"] > 0


# ---------------------------------------------------------------------------
# The CNN
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cnn_task():
    """The fixture of tests/test_cohort_engine.py, in both packages."""
    ds, jds = SyntheticCelebA(n_samples=400), JCelebA(n_samples=400)
    part = FederatedPartition(labels=ds.labels, n_clients=40)
    jpart = JPartition(labels=jds.labels, n_clients=40)

    def batches_np(p, d, cid):
        rng = np.random.default_rng(cid * 1009 + 7)
        b = [p.client_batch(d, cid, 8, rng) for _ in range(2)]
        return {k: np.stack([bi[k] for bi in b]) for k in b[0]}

    def tbatches(cid, key):
        return {k: torch.from_numpy(v)
                for k, v in batches_np(part, ds, cid).items()}

    def jbatches(cid, key):
        return {k: jnp.asarray(v)
                for k, v in batches_np(jpart, jds, cid).items()}

    test_idx = part.split_indices(part.val_clients)[:128]
    ttest = {k: torch.from_numpy(v) for k, v in ds.batch(test_idx).items()}
    jtest = {k: jnp.asarray(v) for k, v in jds.batch(test_idx).items()}
    jparams = jinit(jax.random.PRNGKey(0))
    return dict(
        tbatches=tbatches, jbatches=jbatches, jparams=jparams,
        tparams=params_from_jax(jax.tree.map(np.asarray, jparams),
                                device="cpu"),
        teval=lambda p: float(cnn_accuracy(p, ttest)),
        jeval=jax.jit(lambda p: jaccuracy(p, jtest)))


def _tloss(params, batch, key):
    return cnn_loss(params, batch, train=True, key=key)[0]


def _jloss(params, batch, key):
    return jloss(params, batch, train=True, key=key)[0]


CNN_CFG = dict(client_lr=0.05, server_lr=1.0, server_momentum=0.3,
               buffer_size=4, local_steps=2)


def _cnn_sim_cfg(uploads):
    return dict(concurrency=8, max_uploads=uploads, eval_every_steps=2,
                seed=0, track_hidden_replicas=1)


def test_cohort_size1_reproduces_sequential_on_cnn(cnn_task):
    """cohort_size=1 under identity: the trace, sim clock, traffic and
    x-hat of the port's sequential engine, exactly."""
    runs = []
    for engine in ("sequential", "cohort"):
        algo = QAFeL(QAFeLConfig(**CNN_CFG), _tloss, cnn_task["tparams"],
                     device="cpu")
        cfg = SimConfig(**_cnn_sim_cfg(16))
        if engine == "sequential":
            sim = AsyncFLSimulator(algo, cfg, cnn_task["tbatches"],
                                   cnn_task["teval"])
        else:
            sim = CohortAsyncFLSimulator(algo, cfg, cnn_task["tbatches"],
                                         cnn_task["teval"], cohort_size=1)
        runs.append((algo, sim.run()))
    (sa, sr), (ca, cr) = runs
    assert cr.accuracy_trace == sr.accuracy_trace
    assert cr.final_accuracy == sr.final_accuracy
    assert cr.sim_time == sr.sim_time
    assert cr.server_steps == sr.server_steps == 4
    for key, value in sr.metrics.items():
        assert cr.metrics[key] == value, key
    assert cr.metrics["dropped_uploads"] == 0
    for name in ("x_flat", "hidden_flat", "momentum_flat"):
        assert _same(sa.state.__dict__[name], ca.state.__dict__[name]), name


def test_cnn_vmapped_gradients_match_reference(cnn_task):
    """Per-member gradients of a b = 4 cohort under vmap, and the deltas of
    the cohort step's two SGD steps. The reference side is composed from
    eager ``jax.vmap(jax.grad)`` steps: its fused cohort step is jitted,
    and XLA:CPU's jitted CNN gradient is not its eager one (up to 4.5e-3
    apart on conv1/w on these batches)."""
    b = 4
    tb = [cnn_task["tbatches"](c, None) for c in range(b)]
    stacked = {k: torch.stack([x[k] for x in tb]) for k in tb[0]}
    jb = {k: jnp.asarray(v.numpy()) for k, v in stacked.items()}
    jkeys = jax.random.split(jax.random.PRNGKey(3), b)
    tkeys = torch.from_numpy(np.asarray(jkeys).astype(np.int64))
    te = prng.split_each(tkeys)
    step_keys = prng.split_each(te[:, 0])  # the keys of the two SGD steps
    jstep_keys = jnp.asarray(step_keys.numpy().astype(np.uint32))
    tg = torch.func.vmap(torch.func.grad(_tloss), in_dims=(None, 0, 0))(
        cnn_task["tparams"], {k: v[:, 0] for k, v in stacked.items()},
        step_keys[:, 0])
    y = jax.tree.map(lambda x: jnp.broadcast_to(x, (b,) + x.shape),
                     cnn_task["jparams"])
    for p in range(2):
        g = jax.vmap(jax.grad(_jloss))(
            y, {k: v[:, p] for k, v in jb.items()}, jstep_keys[:, p])
        if p == 0:
            for j, t in zip(jax.tree.leaves(g), tree_leaves(tg)):
                np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                           rtol=RTOL, atol=ATOL)
        y = jax.tree.map(lambda yi, gi: yi - 0.05 * gi, y, g)
    want = np.concatenate(
        [np.asarray(yi - x0).reshape(b, -1) for yi, x0 in
         zip(jax.tree.leaves(y), jax.tree.leaves(cnn_task["jparams"]))],
        axis=1)
    flat, layout = flatten_tree(cnn_task["tparams"])
    spec = make_quantizer("identity").spec
    tout = client_update_flat(
        _tloss, QAFeLConfig(**CNN_CFG), spec, layout, flat, stacked,
        te[:, 0], te[:, 1], b=b)
    np.testing.assert_allclose(tout["flat"].numpy(), want, rtol=RTOL,
                               atol=ATOL)
    # members trained one at a time: the convolutions see another batch
    chunked = client_update_flat(
        _tloss, QAFeLConfig(**CNN_CFG), spec, layout, flat, stacked,
        te[:, 0], te[:, 1], b=b, member_chunk=1)
    np.testing.assert_allclose(chunked["flat"].numpy(), tout["flat"].numpy(),
                               rtol=0, atol=ATOL)


def test_cnn_cohort4_matches_reference(cnn_task):
    """b = 4 through both engines: traffic and staleness exact, accuracy
    within 0.05, replicas in sync."""
    jalgo = JQAFeL(JConfig(**CNN_CFG), _jloss, cnn_task["jparams"])
    jres = JCohort(jalgo, JSimConfig(**_cnn_sim_cfg(16)),
                   cnn_task["jbatches"], cnn_task["jeval"],
                   cohort_size=4).run()
    talgo = QAFeL(QAFeLConfig(**CNN_CFG), _tloss, cnn_task["tparams"],
                  device="cpu")
    tres = CohortAsyncFLSimulator(talgo, SimConfig(**_cnn_sim_cfg(16)),
                                  cnn_task["tbatches"], cnn_task["teval"],
                                  cohort_size=4).run()
    jm, tm = jres.metrics, tres.metrics
    assert tm["replicas_in_sync"] and jm["replicas_in_sync"]
    for key in jm:
        if key != "hidden_drift":
            assert tm[key] == jm[key], key
    assert tres.sim_time == jres.sim_time
    assert tres.final_accuracy == pytest.approx(jres.final_accuracy, abs=0.05)


# ---------------------------------------------------------------------------
# The server's tier branch, dropout masks, the hidden state
# ---------------------------------------------------------------------------


def test_mixed_tier_window_matches_reference():
    """qsgd4 uploads stay packed, qsgd2 ones are decoded on arrival; windows
    of both, of tiers only and of packed only give the reference's x,
    x-hat, momentum and broadcast bits."""
    w0 = np.random.default_rng(1).standard_normal(D).astype(np.float32)
    cfg = dict(client_lr=0.1, server_lr=1.0, server_momentum=0.3,
               buffer_size=4)
    jalgo = JQAFeL(JConfig(**cfg), _jquad_loss, {"w": jnp.asarray(w0)})
    talgo = QAFeL(QAFeLConfig(**cfg), cohort_scenarios.quad_loss,
                  {"w": torch.from_numpy(w0)}, device="cpu")
    rng = np.random.default_rng(2)
    tiers = (4, 2, 4, 4, 2, 2, 2, 2, 4, 4, 4, 4, 2, 4, 2, 4)
    staleness = (0, 1, 0, 2, 0, 1, 0, 0, 3, 0, 1, 0, 2, 0, 0, 1)
    for i, bits in enumerate(tiers):
        delta = (rng.standard_normal(D) * 0.01).astype(np.float32)
        p, nm = jops.qsgd_quantize(jnp.asarray(delta), jax.random.PRNGKey(i),
                                   bits)
        version = max(0, jalgo.state.t - staleness[i])
        jmsg = JMessage(J_UPDATE, jqsgd(p, nm, bits, D, jalgo.state.layout),
                        0.0, {"version": version})
        tmsg = Message(CLIENT_UPDATE, packed_qsgd_payload(
            torch.from_numpy(np.array(p)), torch.from_numpy(np.array(nm)),
            bits, D, talgo.state.layout), 0.0, {"version": version})
        key = jax.random.PRNGKey(100 + i)
        jb = jalgo.receive(jmsg, key)
        tb = talgo.receive(tmsg, torch.from_numpy(
            np.asarray(key).astype(np.int64)))
        assert (jb is None) == (tb is None)
        if tb is not None:
            assert _same(jb.payload["packed"], tb.payload["packed"])
            assert _same(jb.payload["norms"], tb.payload["norms"])
            for name in ("x_flat", "hidden_flat", "momentum_flat"):
                assert _same(getattr(jalgo.state, name),
                             getattr(talgo.state, name)), (i, name)
    assert talgo.state.t == 4
    assert talgo.meter.summary() == jalgo.meter.summary()


def test_vmapped_dropout_masks_match_jax():
    """The CNN's masks, drawn under torch.func.vmap over member keys (on
    x-hat's device, as the cohort step draws them), equal
    jax.vmap(jax.random.bernoulli)'s."""
    jkeys = jax.random.split(jax.random.PRNGKey(9), 6)
    shape = (8, 128)
    want = jax.vmap(lambda k: jax.random.bernoulli(k, 1.0 - DROPOUT,
                                                   shape))(jkeys)
    tkeys = torch.from_numpy(np.asarray(jkeys).astype(np.int64))
    got = torch.func.vmap(
        lambda k: prng.bernoulli(k, 1.0 - DROPOUT, shape))(tkeys)
    assert np.array_equal(np.asarray(want), got.numpy())
    # and a split of each key, as the engine makes the train/encode keys
    assert np.array_equal(
        np.asarray(jax.vmap(jax.random.split)(jkeys)).astype(np.int64),
        prng.split_each(tkeys).numpy())


@pytest.mark.parametrize("qname", ["qsgd2", "qsgd4", "qsgd8", "identity"])
def test_hidden_state_matches_reference(qname):
    """hidden_apply is the reference's leafwise add, and
    server_broadcast_delta its per-leaf quantize-dequantize with a key per
    leaf, bit for bit on the CNN's parameter tree (its 32-element bias
    leaves fill part of one bucket)."""
    rng = np.random.default_rng(4)
    tree = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(
        np.float32), jinit(jax.random.PRNGKey(0)))
    q = jax.tree.map(lambda x: (x * 0.01).astype(np.float32), tree)
    totorch = lambda t: jax.tree.map(torch.from_numpy, t)  # noqa: E731
    want = jhidden_apply(jax.tree.map(jnp.asarray, tree),
                         jax.tree.map(jnp.asarray, q))
    got = hidden_apply(totorch(tree), totorch(q))
    for w, g in zip(jax.tree.leaves(want), tree_leaves(got)):
        assert _same(w, g)
    x_new = jax.tree.map(lambda a, b: a + b, tree, q)
    want = jserver_broadcast_delta(jmake_quantizer(qname),
                                   jax.tree.map(jnp.asarray, x_new),
                                   jax.tree.map(jnp.asarray, tree),
                                   jax.random.PRNGKey(3))
    got = server_broadcast_delta(make_quantizer(qname), totorch(x_new),
                                 totorch(tree), prng.PRNGKey(3))
    for w, g in zip(jax.tree.leaves(want), tree_leaves(got)):
        assert _same(w, g)


def test_cohort_entry_points_default_to_cuda(monkeypatch):
    """The new entry points ask for CUDA unless given the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cohort_scenarios.main(["--uploads", "1", "--model", "quad"])
    with pytest.raises(RuntimeError, match="CUDA"):
        federated_celeba.main(["--uploads", "1", "--engine", "cohort"])
    cohort_scenarios.main(["--uploads", "4", "--model", "quad",
                           "--device", "cpu"])
