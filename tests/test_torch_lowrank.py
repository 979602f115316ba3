"""The port's low-rank sketched uplink with error feedback against the JAX
package's, on the CPU.

Bit for bit (``np.array_equal`` on the f32 bit patterns): the basis seed
pairs and the Rademacher signs; the projection against the reference's
jitted ``lowrank_project_flat2d`` at (1, 2048), (1, 79,842) and
(32, 79,842) for group 32 and at (2, 2048) for every group 2..128, and
against its eager call (the non-fused order) at every group; the expand;
``lowrank_window_delta`` at K = 1, 4 and 10 with mixed seeds against the
reference's fused flush; the client step at b = 1 and b = 4 with a
residual (codes, norms, new residual); the quad's (d = 2048) cohort engine
under lowrank4g32 clients and a qsgd4 server at cohort sizes 1 and 4
(x, x-hat, momentum, every upload and broadcast, every residual, every
metric but the hidden drift, within 1e-6 relative); the sequential engine
under a lowrank4g32 server; checkpoint archives with residuals and a
lowrank window, both ways.

Within a stated tolerance: ``S S^T = I`` (atol 1e-6: the scale is
fl32(1/sqrt(group)), squared and summed in f32), and the lowrank taps,
within rtol 1e-5 as the other taps (the port sums squares in the tap
kernels' fixed order, the reference in XLA's)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import QAFeL as JQAFeL
from repro.core import QAFeLConfig as JConfig
from repro.core import load_checkpoint as jload
from repro.core import save_checkpoint as jsave
from repro.core import quantizers as J
from repro.kernels import ops as jops
from repro.kernels import qsgd as jkq
from repro_torch.common import prng
from repro_torch.core import (QAFeL, QAFeLConfig, load_checkpoint,
                              make_quantizer, save_checkpoint)
from repro_torch.core import quantizers as T
from repro_torch.core.qafel import client_update_flat
from repro_torch.examples import cohort_scenarios
from repro_torch.kernels import ops as tops
from repro_torch.kernels import qsgd as tkq
from repro_torch.obs.taps import named_cohort_taps
from test_torch_sparse import _quad_run, assert_same_run

D = cohort_scenarios.QUAD_D
CNN_N = 79_842
QCFG = dict(client_lr=0.05, server_lr=1.0, server_momentum=0.3, local_steps=2)


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


def _jseeds(seeds: torch.Tensor):
    return jnp.asarray(seeds.numpy().astype(np.uint32))


@pytest.mark.parametrize("basis_seed,version", [(0, 0), (0, 1), (12345, 7),
                                                (2**32 - 1, 99)])
def test_basis_seeds_and_signs_match_reference(basis_seed, version):
    seeds = tkq.basis_seeds(basis_seed, version)
    assert np.array_equal(
        np.asarray(jkq.basis_seeds(basis_seed, version)).astype(np.int64),
        seeds.numpy())
    idx = np.arange(0, 10**8, 997, dtype=np.int64)
    want = jkq.sketch_signs(_jseeds(seeds)[0], _jseeds(seeds)[1],
                            jnp.asarray(idx.astype(np.uint32)))
    assert _same(want, tkq.sketch_signs(seeds, torch.from_numpy(idx)))
    stack = torch.stack([seeds, tkq.basis_seeds(basis_seed, version + 1)])
    both = tkq.sketch_signs(stack, torch.from_numpy(idx[:100]))
    assert torch.equal(both[0], tkq.sketch_signs(stack[0],
                                                 torch.from_numpy(idx[:100])))


_jit_project = jax.jit(J.lowrank_project_flat2d, static_argnums=2)


@pytest.mark.parametrize("b,n", [(1, 2048), (1, CNN_N), (32, CNN_N)])
def test_projection_matches_jitted_reference(b, n):
    c = np.random.default_rng(n + b).standard_normal((b, n)).astype(
        np.float32)
    seeds = tkq.basis_seeds(3, 5)
    want = _jit_project(jnp.asarray(c), _jseeds(seeds), 32)
    got = T.lowrank_project_flat2d(torch.from_numpy(c), seeds, 32)
    assert got.shape == (b, -(-n // 128) * 4)
    assert _same(want, got)


@pytest.mark.parametrize("group", [2, 4, 8, 16, 32, 64, 128])
def test_projection_orders_of_every_group(group):
    """The jitted (fused) order and the eager one, per group size."""
    c = np.random.default_rng(group).standard_normal((2, 2000)).astype(
        np.float32)
    seeds = tkq.basis_seeds(1, 2)
    for fused, fn in ((True, _jit_project), (False, J.lowrank_project_flat2d)):
        want = fn(jnp.asarray(c), _jseeds(seeds), group)
        got = T.lowrank_project_flat2d(torch.from_numpy(c), seeds, group,
                                       fused=fused)
        assert _same(want, got), fused


@pytest.mark.parametrize("group,offset", [(32, 0), (16, 128), (128, 256)])
def test_expand_matches_reference(group, offset):
    y = np.random.default_rng(group).standard_normal((3, 40)).astype(
        np.float32)
    seeds = tkq.basis_seeds(4, 1)
    want = J.lowrank_expand_flat2d(jnp.asarray(y), _jseeds(seeds), group,
                                   None, offset)
    got = T.lowrank_expand_flat2d(torch.from_numpy(y), seeds, group, None,
                                  offset)
    assert _same(want, got)
    assert _same(J.lowrank_expand_flat2d(jnp.asarray(y), _jseeds(seeds),
                                         group, 1000),
                 T.lowrank_expand_flat2d(torch.from_numpy(y), seeds, group,
                                         1000))


@pytest.mark.parametrize("group", [8, 32, 128])
def test_sketch_rows_are_orthonormal(group):
    rank = 2048 // group
    eye = torch.eye(rank)
    seeds = tkq.basis_seeds(9, 9)
    s_st = tkq.sketch_project(tkq.sketch_expand(eye, seeds, group), seeds,
                              group)
    torch.testing.assert_close(s_st, eye, rtol=0, atol=1e-6)


def _window(k: int, seed: int = 0):
    """K rank-length qsgd4 uploads of the quad's rank (64), their mixed
    seeds (three versions) and staleness weights."""
    rng = np.random.default_rng(seed)
    packed, norms = [], []
    for i in range(k):
        y = rng.standard_normal(64).astype(np.float32)
        y[rng.random(64) < 0.3] = 0.0
        p, nm = tops.qsgd_quantize(torch.from_numpy(y), prng.PRNGKey(i), 4)
        packed.append(p)
        norms.append(nm)
    seeds = torch.stack([tkq.basis_seeds(0, v % 3) for v in range(k)])
    w = torch.from_numpy((np.float32(1.0) / np.sqrt(
        1.0 + np.arange(k) % 3).astype(np.float32)
        / np.float32(k)).astype(np.float32))
    return torch.stack(packed), torch.stack(norms), w, seeds


@pytest.mark.parametrize("k", [1, 4, 10])
def test_window_delta_matches_reference_flush(k):
    """The reference's fused flush without momentum gives the window's
    delta as its new momentum, signed zeros included; the port's window
    delta is that, and its own flush gives the reference's state."""
    stack, norms, w, seeds = _window(k, k)
    z = np.zeros(D, np.float32)
    jout = jops.server_flush_step(
        jnp.asarray(z), jnp.asarray(z), jnp.asarray(z),
        jnp.asarray(stack.numpy()), jnp.asarray(norms.numpy()),
        jnp.asarray(w.numpy()), None, None, jnp.asarray(True), bits=4,
        sbits=None, n=D, lr=1.0, beta=None, group=32, lseeds=_jseeds(seeds))
    got = tops.lowrank_window_delta(stack, norms, w, seeds, bits=4, group=32,
                                    n=D)
    assert _same(jout[2], got)
    tz = torch.zeros(D)
    tout = tops.server_flush_step(tz, tz, tz, stack, norms, w, None, None,
                                  bits=4, sbits=None, n=D, lr=1.0, beta=None,
                                  group=32, lseeds=seeds)
    for j, t in zip(jout[:3], tout[:3]):
        assert _same(j, t)


def _step_inputs(b):
    wstar = cohort_scenarios.quad_optimum()
    targets = cohort_scenarios.quad_targets(wstar, range(3, 3 + b))
    w0 = (wstar * 0.3).astype(np.float32)
    jkeys = jax.random.split(jax.random.PRNGKey(11), 2 * b).reshape(b, 2, 2)
    tkeys = torch.from_numpy(np.asarray(jkeys).astype(np.int64))
    res = (np.random.default_rng(1).standard_normal((b, D)) * 0.01).astype(
        np.float32)
    return w0, targets, jkeys, tkeys, res


def _jloss(params, batch, key):
    del key
    return jnp.sum((params["w"] - batch["target"]) ** 2)


@pytest.mark.parametrize("b", [1, 4])
def test_client_step_matches_reference(b):
    """Codes, norms and the new residual exactly; the three taps within
    rtol 1e-5."""
    w0, targets, jkeys, tkeys, res = _step_inputs(b)
    jflat, jlayout = J.flatten_tree({"w": jnp.asarray(w0)})
    tflat, tlayout = T.flatten_tree({"w": torch.from_numpy(w0)})
    seeds = tkq.basis_seeds(0, 3)
    if b == 1:
        jargs = ({"target": jnp.asarray(targets[0])}, jkeys[0, 0],
                 jkeys[0, 1])
        targs = ({"target": torch.from_numpy(targets[0])}, tkeys[0, 0],
                 tkeys[0, 1])
    else:
        jargs = ({"target": jnp.asarray(targets)}, jkeys[:, 0], jkeys[:, 1])
        targs = ({"target": torch.from_numpy(targets)}, tkeys[:, 0],
                 tkeys[:, 1])
    jout = jops.cohort_train_encode_step(
        _jloss, JConfig(**QCFG), J.make_quantizer("lowrank4g32").spec,
        jlayout, jflat, *jargs, jnp.asarray(True), b=b,
        residual=jnp.asarray(res), basis_seed=_jseeds(seeds), taps=True)
    tout = client_update_flat(
        cohort_scenarios.quad_loss, QAFeLConfig(**QCFG),
        make_quantizer("lowrank4g32").spec, tlayout, tflat, *targs, b=b,
        residual=torch.from_numpy(res), basis_seed=seeds, taps=True)
    assert set(jout) == set(tout) == {"packed", "norms", "residual", "taps"}
    for name in ("packed", "norms", "residual"):
        assert _same(jout[name], tout[name]), name
    np.testing.assert_allclose(tout["taps"].numpy(), np.asarray(jout["taps"]),
                               rtol=1e-5, atol=0)
    assert set(named_cohort_taps(tout["taps"][0])) == {
        "delta_norm", "upload_qerr_rel", "subspace_qerr_rel"}
    with pytest.raises(ValueError, match="basis seed"):
        client_update_flat(
            cohort_scenarios.quad_loss, QAFeLConfig(**QCFG),
            make_quantizer("lowrank4g32").spec, tlayout, tflat, *targs, b=b)


class _Uploads:
    """Records every upload's payload on its way into ``receive``."""

    def __init__(self, algo):
        self.payloads = []
        inner = algo.receive

        def receive(msg, key, n_receivers=1):
            self.payloads.append(msg.payload)
            return inner(msg, key, n_receivers)
        algo.receive = receive


@pytest.mark.parametrize("cohort_size", [1, 4])
def test_quad_cohort_engine_matches_reference(cohort_size, monkeypatch):
    ups = {}
    for pkg, cls in (("j", JQAFeL), ("t", QAFeL)):
        orig = cls.__init__

        def init(self, *a, _orig=orig, _pkg=pkg, **kw):
            _orig(self, *a, **kw)
            ups[_pkg] = _Uploads(self)
        monkeypatch.setattr(cls, "__init__", init)
    run = _quad_run("lowrank4g32", "qsgd4", engine="cohort",
                    cohort_size=cohort_size)
    assert_same_run(run)
    jalgo, talgo = run[0], run[3]
    assert len(ups["j"].payloads) == len(ups["t"].payloads) == 40
    for jp, tp in zip(ups["j"].payloads, ups["t"].payloads):
        assert tp["kind"] == "lowrank" and tp["rank"] == jp["rank"] == 64
        assert np.array_equal(np.asarray(jp["seed"]).astype(np.int64),
                              tp["seed"].numpy())
        assert _same(jp["packed"], tp["packed"])
        assert _same(jp["norms"], tp["norms"])
    assert set(jalgo._residuals) == set(talgo._residuals)
    for cid, r in jalgo._residuals.items():
        assert _same(r, talgo._residuals[cid]), cid
    assert run[4].metrics["kB_per_upload/lowrank4g32"] == pytest.approx(
        (4 * 64 + 32) / 8 / 1e3)


def test_quad_sequential_engine_lowrank_server_matches_reference():
    """A lowrank server quantizer: the non-fused flush chain, its
    projection in the reference's eager order, K1 over the rank
    coordinates and the decode through K3."""
    assert_same_run(_quad_run("qsgd4", "lowrank4g32"))


# ---------------------------------------------------------------------------
# Checkpoints with residuals and a lowrank window
# ---------------------------------------------------------------------------

TARGETS = np.random.default_rng(0).standard_normal((30, 2, D)).astype(
    np.float32) + 1.0
CKPT_CFG = dict(QCFG, buffer_size=3, client_quantizer="lowrank4g32",
                server_quantizer="qsgd4")


def _tloss(params, batch, key):
    del key
    return torch.sum((params["w"] - batch["target"]) ** 2)


def make_talgo(basis_seed=5):
    return QAFeL(QAFeLConfig(**CKPT_CFG), _tloss, {"w": torch.zeros(D)},
                 device="cpu", basis_seed=basis_seed)


def make_jalgo(basis_seed=5):
    return JQAFeL(JConfig(**CKPT_CFG), _jloss, {"w": jnp.zeros((D,))},
                  basis_seed=basis_seed)


def drive(algo, lo, hi, torch_side: bool):
    """Uploads lo..hi-1 (client i % 4, and every fifth one the shared
    slot None), each from the model version of its predecessor."""
    split = prng.split if torch_side else jax.random.split
    key = prng.PRNGKey(4) if torch_side else jax.random.PRNGKey(4)
    pending = None
    for i in range(hi):
        key, k2, k3 = split(key, 3)
        if i < lo:
            continue
        t = TARGETS[i]
        batches = {"target": torch.from_numpy(t) if torch_side
                   else jnp.asarray(t)}
        msg, _ = algo.run_client(batches, k2,
                                 client=None if i % 5 == 4 else i % 4)
        if pending is not None:
            algo.receive(*pending)
        pending = (msg, k3)
    algo.receive(*pending)
    return algo


def assert_same_state(j, t):
    for name in ("x_flat", "hidden_flat", "momentum_flat"):
        assert _same(getattr(j.state, name), getattr(t.state, name)), name
    assert j.state.t == t.state.t
    assert j.meter.summary() == t.meter.summary()
    assert j.buffer.count == t.buffer.count
    assert set(j._residuals) == set(t._residuals)
    for cid in j._residuals:
        assert _same(j._residuals[cid], t._residuals[cid]), cid


def test_reference_archive_with_residuals_continues_in_the_port(tmp_path):
    path = tmp_path / "ref.npz"
    jalgo = drive(make_jalgo(), 0, 8, False)
    assert jalgo.buffer.count == 2 and len(jalgo.buffer._seeds) == 2
    assert None in jalgo._residuals
    jsave(str(path), jalgo)
    talgo = load_checkpoint(path, make_talgo())
    assert_same_state(jalgo, talgo)
    assert talgo.buffer._rank == 64 and talgo.buffer._group == 32
    drive(jalgo, 8, 20, False)
    drive(talgo, 8, 20, True)
    assert talgo.state.t == 6
    assert_same_state(jalgo, talgo)


def test_port_archive_with_residuals_continues_in_the_reference(tmp_path):
    path = tmp_path / "port.npz"
    talgo = drive(make_talgo(), 0, 7, True)
    assert talgo.buffer.count == 1 and len(talgo.buffer._seeds) == 1
    save_checkpoint(path, talgo)
    jalgo = jload(str(path), make_jalgo())
    assert_same_state(jalgo, talgo)
    drive(jalgo, 7, 19, False)
    drive(talgo, 7, 19, True)
    assert_same_state(jalgo, talgo)


def test_basis_seed_mismatch_is_refused(tmp_path):
    path = tmp_path / "ckpt.npz"
    save_checkpoint(path, drive(make_talgo(), 0, 4, True))
    target = make_talgo(basis_seed=6)
    with pytest.raises(ValueError, match="basis_seed"):
        load_checkpoint(path, target)
    assert target.state.t == 0 and not target._residuals
    resumed = load_checkpoint(path, make_talgo())
    assert resumed.state.t == 1 and len(resumed._residuals) == 4


def test_lowrank_tier_of_another_group_decodes_on_arrival():
    """A lowrank2g16 upload into a lowrank4g32 window lies in another
    subspace: both servers decode it on arrival (K3 at 2 bits, its own
    expand) into the flat sum beside the packed window."""
    from repro.core.protocol import CLIENT_UPDATE as J_UPDATE
    from repro.core.protocol import Message as JMessage
    from repro_torch.core.protocol import CLIENT_UPDATE, Message

    jalgo, talgo = make_jalgo(), make_talgo()
    jtier, ttier = J.make_quantizer("lowrank2g16"), T.make_quantizer(
        "lowrank2g16")
    key, jkey = prng.PRNGKey(30), jax.random.PRNGKey(30)
    for i in range(6):
        key, k2, k3 = prng.split(key, 3)
        jkey, jk2, jk3 = jax.random.split(jkey, 3)
        if i % 3 == 1:
            x = TARGETS[i, 0] * 0.01
            jflat, jlayout = J.flatten_tree({"w": jnp.asarray(x)})
            tflat, tlayout = T.flatten_tree({"w": torch.from_numpy(x)})
            jmsg = JMessage(J_UPDATE, jtier.encode_flat(jflat, jlayout, jk2),
                            0.0, {"version": jalgo.state.t})
            tmsg = Message(CLIENT_UPDATE, ttier.encode_flat(tflat, tlayout,
                                                            k2),
                           0.0, {"version": talgo.state.t})
        else:
            batches = TARGETS[i]
            jmsg, _ = jalgo.run_client({"target": jnp.asarray(batches)}, jk2,
                                       client=i)
            tmsg, _ = talgo.run_client({"target": torch.from_numpy(batches)},
                                       k2, client=i)
        jalgo.receive(jmsg, jk3)
        talgo.receive(tmsg, k3)
    assert talgo.state.t == 2
    assert talgo.meter.uploads_by_kind == {"lowrank4g32": 4, "lowrank2g16": 2}
    assert_same_state(jalgo, talgo)


@pytest.mark.parametrize("cq,sq", [("lowrank4g32", "qsgd4"),
                                   ("qsgd4", "top_k0.1")])
def test_traced_stream_matches_reference(cq, sq):
    """Cohorts of 4 with taps on: every event field exact, the taps (three
    per lowrank upload, none on a non-fused flush) within rtol 1e-5, the
    state bit for bit."""
    run = _quad_run(cq, sq, engine="cohort", cohort_size=4, taps=True)
    assert_same_run(run)
    jalgo, talgo = run[0], run[3]

    def stream(tracer):
        return [e.comparable() for e in tracer.events()
                if e.kind != "compile"]

    jev, tev = stream(jalgo.telemetry), stream(talgo.telemetry)
    assert len(jev) == len(tev) > 0
    for j, t in zip(jev, tev):
        assert set(j) == set(t), (j, t)
        for key in j:
            if key == "taps":
                assert list(j[key]) == list(t[key])
                np.testing.assert_allclose(list(t[key].values()),
                                           list(j[key].values()),
                                           rtol=1e-5, atol=0)
            else:
                assert t[key] == j[key], (key, j, t)
    uploads = [e for e in tev if e["kind"] == "upload"]
    assert uploads and all(len(e["taps"]) == (3 if cq.startswith("lowrank")
                                              else 2) for e in uploads)
    flushes = [e for e in tev if e["kind"] == "flush"]
    assert flushes and all(("taps" in e) == (sq == "qsgd4") for e in flushes)
