"""The port's sequential simulator and quickstart against the JAX package's.

CNN run (SyntheticCelebA(n_samples=200), 20 clients, 20 uploads, K = 10,
the federated example's configuration) from the same converted weights:
the event timeline, keys, data draws and dropout masks are the reference's
exactly, but the client gradients go through other convolution code and
agree only to float32 rounding (test_torch_cnn), so the codes of an upload
can differ wherever a last-ulp difference flips a stochastic rounding. So:
replicas in sync and the staleness and traffic summaries are compared
exactly, the accuracy within 0.05 absolute (observed: equal) and the
hidden drift within 1e-3 relative (observed: 1e-5).

Quickstart (d = 2048, 40 uploads, K = 4): bit-exact. Its gradients are
exact in both packages, and the port rounds the SGD step once, as XLA's
fused multiply-add does."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import QAFeL as JQAFeL
from repro.core import QAFeLConfig as JConfig
from repro.data import FederatedPartition as JPartition
from repro.data import SyntheticCelebA as JCelebA
from repro.models.cnn import cnn_accuracy as jaccuracy
from repro.models.cnn import cnn_loss as jloss
from repro.models.cnn import init_cnn as jinit
from repro.sim import AsyncFLSimulator as JSimulator
from repro.sim import SimConfig as JSimConfig
from repro_torch.convert import params_from_jax
from repro_torch.data import FederatedPartition, SyntheticCelebA
from repro_torch.examples import federated_celeba, quickstart
from repro_torch.sim import SimConfig


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The module's tests on one torch thread, restored after: the suite
    runs six workers on the CPU's cores, where a pool of threads per
    worker spends its time waiting on the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


N_SAMPLES, N_CLIENTS, UPLOADS = 200, 20, 20
# metered as the reference meters: 4 bits per coordinate + one f32 per row
BYTES_PER_UPLOAD = (4 * 79_842) // 8 + 4 * 624


def test_data_copies_match_reference():
    jds, tds = JCelebA(n_samples=N_SAMPLES), SyntheticCelebA(n_samples=N_SAMPLES)
    assert np.array_equal(jds.images, tds.images)
    assert np.array_equal(jds.labels, tds.labels)
    jp = JPartition(labels=jds.labels, n_clients=N_CLIENTS)
    tp = FederatedPartition(labels=tds.labels, n_clients=N_CLIENTS)
    assert all(np.array_equal(a, b) for a, b in zip(jp.shards, tp.shards))
    assert np.array_equal(jp.val_clients, tp.val_clients)


def _jax_cnn_run(params0, scfg):
    ds = JCelebA(n_samples=N_SAMPLES)
    part = JPartition(labels=ds.labels, n_clients=N_CLIENTS)
    rng = np.random.default_rng(0)

    def loss_fn(params, batch, key):
        return jloss(params, batch, train=True, key=key)[0]

    def client_batches(cid, key):
        b = [part.client_batch(ds, cid, 8, rng) for _ in range(2)]
        return {k: jnp.stack([jnp.asarray(bi[k]) for bi in b]) for k in b[0]}

    test_idx = part.split_indices(part.val_clients)[:512]
    test = {k: jnp.asarray(v) for k, v in ds.batch(test_idx).items()}
    eval_fn = jax.jit(lambda p: jaccuracy(p, test))
    cfg = JConfig(client_lr=0.05, server_lr=1.0, server_momentum=0.3,
                  buffer_size=10, local_steps=2)
    return JSimulator(JQAFeL(cfg, loss_fn, params0), scfg, client_batches,
                      eval_fn).run()


def test_cnn_simulator_matches_reference():
    params0 = jinit(jax.random.PRNGKey(0))
    kw = dict(concurrency=16, max_uploads=UPLOADS, eval_every_steps=3)
    jres = _jax_cnn_run(params0, JSimConfig(**kw))
    task = federated_celeba.celeba_task("cpu", n_samples=N_SAMPLES,
                                        n_clients=N_CLIENTS)
    tres = federated_celeba.run_one(
        task, params_from_jax(jax.tree.map(np.asarray, params0), device="cpu"),
        federated_celeba.qafel_config(), SimConfig(**kw), "cpu")
    jm, tm = jres.metrics, tres.metrics
    assert tm["replicas_in_sync"] and jm["replicas_in_sync"]
    assert tres.uploads == jres.uploads == UPLOADS
    assert tres.server_steps == jres.server_steps == UPLOADS // 10
    assert tm["upload_MB"] * 1e6 == pytest.approx(UPLOADS * BYTES_PER_UPLOAD)
    for key in ("tau_max", "tau_mean", "n", "stale_dropped", "tau_hist"):
        assert tm[key] == jm[key], key
    for key in jm:
        if key not in ("hidden_drift", "replicas_in_sync"):
            assert tm[key] == jm[key], key
    assert tm["hidden_drift"] == pytest.approx(jm["hidden_drift"], rel=1e-3)
    assert np.isfinite(tres.final_accuracy)
    assert tres.final_accuracy == pytest.approx(jres.final_accuracy, abs=0.05)
    assert [(p.uploads, p.step) for p in tres.accuracy_trace] == [
        (p.uploads, p.step) for p in jres.accuracy_trace]
    assert tres.sim_time == jres.sim_time


def test_quickstart_matches_reference_bit_exact():
    d, p = quickstart.D, quickstart.CONFIG.local_steps
    c = quickstart.CONFIG
    cfg = JConfig(client_lr=c.client_lr, server_lr=c.server_lr,
                  server_momentum=c.server_momentum,
                  buffer_size=c.buffer_size, local_steps=c.local_steps,
                  client_quantizer=c.client_quantizer,
                  server_quantizer=c.server_quantizer)
    algo = JQAFeL(cfg, lambda w, b, k: jnp.mean((w["w"] - b["target"]) ** 2),
                  {"w": jnp.zeros((d,))})
    key, rng = jax.random.PRNGKey(0), np.random.default_rng(0)
    for _ in range(40):
        key, _, k2, k3 = jax.random.split(key, 4)
        noise = rng.standard_normal((p, d), dtype=np.float32)
        batches = {"target": jnp.full((p, d), quickstart.TARGET)
                   + 0.1 * jnp.asarray(noise)}
        msg, _ = algo.run_client(batches, k2)
        algo.receive(msg, k3)
    talgo, in_sync = quickstart.run("cpu", 40, verbose=False)
    assert in_sync and talgo.state.t == algo.state.t == 10
    for name in ("x_flat", "hidden_flat", "momentum_flat"):
        want = np.asarray(getattr(algo.state, name)).view(np.int32)
        got = getattr(talgo.state, name).numpy().view(np.int32)
        assert np.array_equal(want, got), name
    assert algo.meter.summary() == talgo.meter.summary()
