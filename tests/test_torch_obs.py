"""The port's telemetry (repro_torch.obs and the taps in
repro_torch.kernels) on the CPU, on its own and against the JAX package's.

On its own, as tests/test_obs.py pins the reference on one device: the
records, the tracer's ring, the schema, the JSONL round trip; taps on
leave the trajectory, the wire bits and the legacy metrics bit-identical
to a run with no tracer; the identity quantizers' errors are exactly 0;
the sequential engine and the cohort engine at ``cohort_size=1`` give the
same event stream; taps on call each tap function once per flush and per
client step; the compile watch; the reports.

Against the reference, on the same seed: the comparable event streams
(no wall clock, no compile events) field for field, every field exact,
the tap values too — the port's taps sum in XLA:CPU's own order for
``jnp.sum`` (``kernels.ref.xla_sum``: windows of 32 with the padding
split evenly, recursively) and fuse the upload error's last product as
XLA does. The plain tap functions against ``repro.obs.taps`` under
``jax.jit`` (as the reference's dispatches compute them) on numpy inputs,
bit for bit, and bit for bit across cohort sizes; the law against the
jitted ``jnp.sum``.

The quad task of tests/test_obs.py: 300 + 7 parameters, K = 3, P = 2,
concurrency 4, 12 uploads; its batches come from a numpy generator seeded
with the client's key, so both packages' engines see the same data.
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import QAFeL as JQAFeL
from repro.core import QAFeLConfig as JConfig
from repro.kernels import ops as jops
from repro.obs import RunTracer as JRunTracer
from repro.obs import taps as jtaps
from repro.sim import AsyncFLSimulator as JAsync
from repro.sim import CohortAsyncFLSimulator as JCohort
from repro.sim import SimConfig as JSimConfig
from repro_torch.core import QAFeL, QAFeLConfig
from repro_torch.core.staleness import StalenessMonitor
from repro_torch.examples import cohort_scenarios
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import taps as ktaps
from repro_torch.obs import (COHORT_TAP_NAMES, FLUSH_TAP_NAMES, AccuracyPoint,
                             CompileWatch, Event, RunTracer, summary_table,
                             validate_events, validate_jsonl, write_jsonl)
from repro_torch.obs.report import report_rows
from repro_torch.obs.schema import _selftest
from repro_torch.obs.taps import named_population_counts
from repro_torch.sim import AsyncFLSimulator, CohortAsyncFLSimulator, SimConfig

D = 300
QCFG = dict(client_lr=0.1, server_lr=1.2, server_momentum=0.3, buffer_size=3,
            local_steps=2, client_quantizer="qsgd4", server_quantizer="qsgd4")
SIM = dict(concurrency=4, eval_every_steps=1, track_hidden_replicas=1)


def _bits(a) -> np.ndarray:
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(a, b) -> bool:
    a, b = _bits(a), _bits(b)
    return a.shape == b.shape and np.array_equal(a, b)


def _key_target(key) -> np.ndarray:
    """The client's (2, D) targets from a generator seeded with its key's
    two words (a torch or a JAX key: the port's keys are JAX's)."""
    if isinstance(key, torch.Tensor):
        key = key.numpy()
    w0, w1 = (int(w) & 0xFFFFFFFF for w in np.asarray(key).reshape(-1))
    t = np.random.default_rng([w0, w1]).standard_normal(D).astype(np.float32)
    return np.broadcast_to(t + np.float32(3.0), (2, D)).copy()


def _mean_w(w: np.ndarray) -> float:
    return float(np.asarray(w, dtype=np.float64).mean())


# -- the port's run ---------------------------------------------------------


def quad_loss(params, batch, key):
    del key
    return torch.sum((params["w"] - batch["target"]) ** 2)


def client_batches(cid, key):
    del cid
    return {"target": torch.from_numpy(_key_target(key))}


def eval_fn(params):
    return _mean_w(params["w"].numpy())


def run_sim(engine="sequential", taps=True, seed=0, max_uploads=12,
            **qkw):
    """One port run; ``taps`` None attaches no tracer. Returns the result,
    the tracer, the algorithm and every broadcast's payload."""
    tracer = None if taps is None else RunTracer(taps=taps)
    params0 = {"w": torch.zeros(D), "b": torch.ones(7)}
    algo = QAFeL(QAFeLConfig(**{**QCFG, **qkw}), quad_loss, params0,
                 device="cpu", telemetry=tracer)
    sent, inner = [], algo.receive

    def receive(msg, key, n_receivers=1):
        bmsg = inner(msg, key, n_receivers)
        if bmsg is not None:
            sent.append(bmsg.payload)
        return bmsg
    algo.receive = receive
    scfg = SimConfig(max_uploads=max_uploads, seed=seed, **SIM)
    if engine == "sequential":
        sim = AsyncFLSimulator(algo, scfg, client_batches, eval_fn)
    else:
        sim = CohortAsyncFLSimulator(algo, scfg, client_batches, eval_fn,
                                     scenario="identity", cohort_size=1)
    return sim.run(), tracer, algo, sent


@pytest.fixture(scope="module")
def traced_run():
    return run_sim()


@pytest.fixture(scope="module", autouse=True)
def _cold_jax_caches_after():
    """This module compiles the reference's taps-on dispatches at the
    shapes of tests/test_obs.py. Clearing JAX's caches when it is done
    leaves a later test in the same process that expects a cold compile
    (the reference's compile watch) a cold cache."""
    yield
    jax.clear_caches()


def _comparable_stream(tracer):
    # compile events depend on what the process loaded before
    return [e.comparable() for e in tracer.events() if e.kind != "compile"]


# -- records and registries -------------------------------------------------


def test_accuracy_point_is_a_tuple():
    p = AccuracyPoint(1.5, 12, 4, 0.75)
    assert p == (1.5, 12, 4, 0.75)
    assert isinstance(p, tuple)
    t_sim, uploads, step, acc = p
    assert (p[0], p[1], p[2], p[3]) == (t_sim, uploads, step, acc)
    assert p.accuracy == 0.75
    assert p.as_dict() == {"t_sim": 1.5, "uploads": 12, "step": 4,
                           "accuracy": 0.75}


def test_staleness_histogram():
    mon = StalenessMonitor()
    for tau in (0, 0, 1, 2, 3, 4, 8, 100):
        mon.observe(tau)
    mon.record_dropped(7)
    h = mon.histogram(bins=4)
    assert h["edges"] == (0, 1, 2, 4)
    assert h["accepted"] == (2, 1, 2, 3)
    assert h["dropped"] == (0, 0, 0, 1)
    with pytest.raises(ValueError):
        mon.histogram(bins=1)
    assert mon.summary()["tau_hist"] == mon.histogram()


def test_tracer_ring_eviction():
    t = RunTracer(capacity=4)
    for i in range(6):
        t.emit("flush", step=i, window=3)
    assert len(t.events()) == 4
    assert t.dropped_events == 2
    assert t.counters()["events_evicted"] == 2
    assert [e.step for e in t.events()] == [2, 3, 4, 5]
    with pytest.raises(ValueError):
        RunTracer(capacity=0)


def test_event_comparable_drops_wall_clock():
    t = RunTracer()
    t.emit("eval", step=1, accuracy=0.5)
    (e,) = t.events()
    assert isinstance(e, Event)
    assert "t_wall" in e.as_dict()
    assert "t_wall" not in e.comparable()


def test_tracer_rejects_unknown_kind():
    with pytest.raises(ValueError):
        RunTracer().emit("not_a_kind")


def test_named_views_check_their_length():
    from repro_torch.obs.taps import named_cohort_taps, named_flush_taps
    assert list(named_flush_taps(torch.arange(7.0))) == list(FLUSH_TAP_NAMES)
    assert len(named_cohort_taps(np.zeros(3, np.float32))) == 3  # low-rank
    assert named_population_counts([5, 1, 0, 2]) == {
        "idle": 5, "working": 1, "offline": 0, "dropped": 2}
    with pytest.raises(ValueError):
        named_flush_taps(torch.zeros(6))
    with pytest.raises(ValueError):
        named_population_counts([1, 2])


# -- schema -----------------------------------------------------------------


def test_schema_selftest():
    assert _selftest() == []


def test_schema_rejects_malformed_streams():
    t = RunTracer()
    t.set_sim_time(1.0)
    t.emit("flush", step=1, window=3)
    rows = [e.as_dict() for e in t.events()]
    assert validate_events(rows) == []
    assert validate_events([]) != []
    assert validate_events([dict(rows[0]), dict(rows[0])]) != []  # seq
    missing = dict(rows[0])
    del missing["window"]
    assert validate_events([missing]) != []
    assert validate_events([dict(rows[0], kind="telemetry")]) != []
    assert validate_events([dict(rows[0], taps={"nope": 1.0})]) != []


def test_schema_cli(tmp_path, capsys):
    from repro_torch.obs.schema import main
    good, bad = tmp_path / "good.jsonl", tmp_path / "bad.jsonl"
    t = RunTracer()
    t.emit("eval", step=0, accuracy=0.5)
    write_jsonl(t, str(good))
    bad.write_text("{not json}\n")
    assert main(["--selftest", str(good)]) == 0
    assert main([str(bad)]) == 1
    assert "OK" in capsys.readouterr().out


def test_run_trace_jsonl_roundtrip(traced_run, tmp_path):
    tracer = traced_run[1]
    path = tmp_path / "trace.jsonl"
    assert write_jsonl(tracer, str(path)) == len(tracer)
    assert validate_jsonl(str(path)) == []
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert rows == [e.as_dict() for e in tracer.events()]
    assert {"upload", "flush", "broadcast", "eval"} <= {r["kind"]
                                                         for r in rows}


# -- taps: bit-invisible when off, right when on ----------------------------


def test_taps_off_run_is_bit_identical(traced_run):
    """A taps-on tracer changes no bit: the same trajectory, the same
    broadcast bits, the same legacy metrics and accuracy trace as a run
    with no tracer and one with a taps-off tracer."""
    res_on, tracer, algo_on, sent_on = traced_run
    for taps in (None, False):
        res_off, tr_off, algo_off, sent = run_sim(taps=taps)
        for name in ("x_flat", "hidden_flat", "momentum_flat"):
            assert _same(getattr(algo_on.state, name),
                         getattr(algo_off.state, name)), (taps, name)
        assert res_off.accuracy_trace == res_on.accuracy_trace
        m_on = {k: v for k, v in res_on.metrics.items()
                if not k.startswith(("flush/", "upload/"))}
        assert m_on == res_off.metrics
        if tr_off is not None:  # taps off: the events carry no taps
            assert all("taps" not in e.data for e in tr_off.events())
            assert ([e.comparable() for e in tr_off.events()
                     if e.kind != "compile"]
                    == [{k: v for k, v in e.comparable().items()
                         if k != "taps"} for e in tracer.events()
                        if e.kind != "compile"])
        assert len(sent) == len(sent_on) == algo_off.state.t > 0
        for a, b in zip(sent_on, sent):
            assert _same(a["packed"], b["packed"])
            assert _same(a["norms"], b["norms"])
    n_flush = len(tracer.events("flush"))
    for name in FLUSH_TAP_NAMES:
        assert len(res_on.metrics[f"flush/{name}"]) == n_flush
    n_up = len(tracer.events("upload"))
    for name in COHORT_TAP_NAMES:
        assert len(res_on.metrics[f"upload/{name}"]) == n_up


def test_flush_tap_values_identity_server():
    res = run_sim(server_quantizer="identity")[0]
    qerr = res.metrics["flush/bcast_qerr_rel"]
    assert qerr and all(v == 0.0 for v in qerr)
    for name in ("delta_norm", "update_norm", "bcast_diff_norm"):
        assert all(np.isfinite(v) and v > 0.0
                   for v in res.metrics[f"flush/{name}"])
    assert (res.metrics["flush/hidden_step_norm"]
            == res.metrics["flush/bcast_diff_norm"])
    for s, lo in zip(res.metrics["flush/weight_sum"],
                     res.metrics["flush/weight_min"]):
        assert 0.0 < lo <= 1.0 and lo <= s <= QCFG["buffer_size"]


def test_upload_tap_qerr_zero_identity_client():
    res = run_sim(client_quantizer="identity")[0]
    up_qerr = res.metrics["upload/upload_qerr_rel"]
    assert up_qerr and all(v == 0.0 for v in up_qerr)
    assert all(v == 0.0 for v in res.metrics["flush/weight_sum"])
    assert all(v == 0.0 for v in res.metrics["flush/weight_min"])


def test_qsgd_tap_qerr_in_unit_range(traced_run):
    res = traced_run[0]
    for series in (res.metrics["flush/bcast_qerr_rel"],
                   res.metrics["upload/upload_qerr_rel"]):
        assert series and all(0.0 < v < 1.0 for v in series)


def test_event_stream_engine_invariant(traced_run):
    """Sequential engine vs cohort engine at cohort_size=1: the same event
    stream and metrics on the same seed."""
    res_a, tr_a = traced_run[:2]
    res_b, tr_b = run_sim(engine="cohort")[:2]
    assert _comparable_stream(tr_a) == _comparable_stream(tr_b)
    m_b = dict(res_b.metrics)
    assert m_b.pop("dropped_uploads") == 0
    assert m_b == res_a.metrics
    assert res_b.accuracy_trace == res_a.accuracy_trace


@pytest.mark.parametrize("engine", ["sequential", "cohort"])
def test_taps_on_call_each_tap_once_per_step(engine, monkeypatch):
    """Taps ride the existing steps: one flush-tap call per flush and one
    upload-tap call per client step (one launch each on the card); none
    with taps off."""
    calls = {"flush_taps": 0, "upload_taps": 0}
    for name in calls:
        inner = getattr(ktaps, name)

        def counted(*a, _inner=inner, _name=name, **kw):
            calls[_name] += 1
            return _inner(*a, **kw)
        monkeypatch.setattr(ktaps, name, counted)
    steps = []
    inner_step = ops.cohort_train_encode_step

    def counted_step(*a, **kw):
        steps.append(kw.get("taps"))
        return inner_step(*a, **kw)
    monkeypatch.setattr(ops, "cohort_train_encode_step", counted_step)
    for taps in (False, True):
        for name in calls:
            calls[name] = 0
        steps.clear()
        res, _, algo, _ = run_sim(engine=engine, taps=taps)
        want = (algo.state.t, len(steps)) if taps else (0, 0)
        assert (calls["flush_taps"], calls["upload_taps"]) == want
        assert len(steps) >= res.uploads and set(steps) == {taps}


# -- compile tracking and reporting -----------------------------------------


def test_compile_watch_and_events(monkeypatch):
    """A library loaded during a run is one compile event (entry = the
    library, retraces = its loads); the counters carry the totals and
    metrics() leaves them out; a fresh watch sees no new loads. On the CPU
    no library loads, so a load is counted by hand."""
    monkeypatch.setattr(_build, "LOADS", dict(_build.LOADS))
    tracer = RunTracer()
    _build.LOADS["flush_taps"] += 1
    tracer.emit("flush", step=0, window=3)
    assert tracer.poll_compiles(step=1) == 1
    (ev,) = tracer.events("compile")
    assert ev.data == {"entry": "flush_taps", "retraces": 1}
    assert ev.step == 1
    assert tracer.poll_compiles() == 0
    assert tracer.counters()["loads_flush_taps"] == _build.LOADS["flush_taps"]
    assert not any(k.startswith("loads_") for k in tracer.metrics())
    assert all(v == 0 for v in CompileWatch().poll().values())
    assert validate_events([e.as_dict() for e in tracer.events()]) == []


def test_run_polls_compiles_once(monkeypatch):
    monkeypatch.setattr(_build, "LOADS", dict(_build.LOADS))
    calls = []
    monkeypatch.setattr(RunTracer, "poll_compiles",
                        lambda self, step=0: calls.append(step) or 0)
    res = run_sim()[0]
    assert calls == [res.server_steps]


def test_report_rows_and_summary_table(traced_run):
    tracer = traced_run[1]
    rows = []
    n = report_rows(tracer, lambda name, us, derived="": rows.append(
        (name, us, derived)))
    names = [r[0] for r in rows]
    assert n == len(rows) and "obs/events" in names
    assert any(name.startswith("obs/flush/") for name in names)
    assert any(name.startswith("obs/upload/") for name in names)
    table = summary_table(tracer)
    assert "events_flush" in table and "flush/bcast_qerr_rel" in table
    assert "(no events recorded)" in summary_table(RunTracer())


def test_metrics_surface_keeps_legacy_keys(traced_run):
    res = traced_run[0]
    for key in ("upload_MB", "broadcast_MB", "kB_per_upload", "tau_max",
                "tau_mean", "tau_hist", "server_steps", "hidden_drift",
                "replicas_in_sync"):
        assert key in res.metrics, key


# -- against the reference --------------------------------------------------

def _jquad_loss(params, batch, key):
    del key
    return jnp.sum((params["w"] - batch["target"]) ** 2)


def _jbatches(cid, key):
    del cid
    return {"target": jnp.asarray(_key_target(key))}


def _jeval(params):
    return _mean_w(np.asarray(params["w"]))


def _assert_taps_equal(got, want):
    """Tap values equal to the reference's, bit for bit."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert (got.view(np.uint32) == want.view(np.uint32)).all(), (got, want)


def _assert_streams_match(jtracer, ttracer):
    """Event for event: every field exact, the taps too."""
    jev, tev = _comparable_stream(jtracer), _comparable_stream(ttracer)
    assert len(jev) == len(tev) > 0
    for j, t in zip(jev, tev):
        assert set(j) == set(t), (j, t)
        for key in j:
            if key == "taps":
                assert list(j[key]) == list(t[key])
                _assert_taps_equal(list(t[key].values()),
                                   list(j[key].values()))
            else:
                assert t[key] == j[key], (key, j, t)
                assert type(t[key]) is type(j[key]), key


def test_sequential_stream_matches_reference(traced_run):
    jtracer = JRunTracer(taps=True)
    jalgo = JQAFeL(JConfig(**QCFG), _jquad_loss,
                   {"w": jnp.zeros((D,), jnp.float32),
                    "b": jnp.ones((7,), jnp.float32)}, telemetry=jtracer)
    jres = JAsync(jalgo, JSimConfig(max_uploads=12, seed=0, **SIM),
                  _jbatches, _jeval).run()
    tres, ttracer, talgo = traced_run[:3]
    for name in ("x_flat", "hidden_flat", "momentum_flat"):
        assert _same(getattr(jalgo.state, name),
                     getattr(talgo.state, name)), name
    _assert_streams_match(jtracer, ttracer)
    assert tres.accuracy_trace == jres.accuracy_trace


def _quad_cohort_run(jax_side, scenario, cohort_size, uploads=40):
    """The quad task of the cohort tests (d = 2048, K = 4) through one
    package's cohort engine with a taps-on tracer."""
    wstar = cohort_scenarios.quad_optimum()
    if jax_side:
        def batches(cids, keys):
            return {"target": jnp.asarray(
                cohort_scenarios.quad_targets(wstar, cids))}
        batches.batched = True

        def batch1(cid, key):
            return {"target": jnp.asarray(
                cohort_scenarios.quad_targets(wstar, [cid])[0])}

        def evalf(p):
            w = np.asarray(p["w"])
            return float(1.0 - np.linalg.norm(w - wstar)
                         / np.linalg.norm(wstar))
        tracer = JRunTracer(taps=True)
        algo = JQAFeL(JConfig(client_lr=0.05, server_lr=1.0,
                              server_momentum=0.3, local_steps=2,
                              buffer_size=4), _jquad_loss,
                      {"w": jnp.zeros((wstar.size,), jnp.float32)},
                      telemetry=tracer)
        sim = JCohort(algo, JSimConfig(concurrency=8, max_uploads=uploads,
                                       eval_every_steps=3, seed=0),
                      batches if cohort_size > 1 else batch1, evalf,
                      scenario=scenario, cohort_size=cohort_size)
        return sim.run(), tracer, algo
    task = cohort_scenarios.quad_task("cpu")
    if cohort_size == 1:  # the reference's run feeds unstacked batches
        stacked = task.client_batches

        def one(cid, key):
            return {k: v[0] for k, v in stacked([cid], [key]).items()}
        task = task._replace(client_batches=one)
    tracer = RunTracer(taps=True)
    algo = QAFeL(cohort_scenarios.qafel_config(4), task.loss_fn, task.params0,
                 device="cpu", telemetry=tracer)
    sim = CohortAsyncFLSimulator(
        algo, SimConfig(concurrency=8, max_uploads=uploads,
                        eval_every_steps=3, seed=0),
        task.client_batches, task.eval_fn, scenario=scenario,
        cohort_size=cohort_size)
    return sim.run(), tracer, algo


@pytest.mark.parametrize("cohort_size", [1, 4])
@pytest.mark.parametrize("scenario",
                         ["identity", "lognormal_dropout", "tiered_bits"])
def test_cohort_stream_matches_reference(scenario, cohort_size):
    jres, jtracer, jalgo = _quad_cohort_run(True, scenario, cohort_size)
    tres, ttracer, talgo = _quad_cohort_run(False, scenario, cohort_size)
    for name in ("x_flat", "hidden_flat", "momentum_flat"):
        assert _same(getattr(jalgo.state, name),
                     getattr(talgo.state, name)), name
    _assert_streams_match(jtracer, ttracer)
    assert tres.accuracy_trace == jres.accuracy_trace
    if scenario == "lognormal_dropout":
        assert ttracer.counters()["events_drop"] > 0
    assert validate_events(list(ttracer.iter_dicts())) == []


# -- the plain tap functions ------------------------------------------------


@jax.jit
def _jit_flush_taps(x_old, x_new, delta, diff, q, weights, flag):
    """The reference's flush taps as its jitted flush computes them: the
    squares behind a hard boundary on a traced flag."""
    return jtaps.flush_tap_vector(functools.partial(jops.hard_boundary, flag),
                                  x_old, x_new, delta, diff, q, weights)


@functools.partial(jax.jit, static_argnames=("bits", "d"))
def _jit_upload_taps(flat2d, packed, norms, flag, *, bits, d):
    """The reference's upload taps as its jitted cohort step computes them:
    the wire bits decoded in the same computation, the squares behind a
    hard boundary on a traced flag."""
    q2d = None if bits is None else jtaps.decode_qsgd_stack(packed, norms,
                                                            bits, d)
    return jtaps.cohort_tap_rows(functools.partial(jops.hard_boundary, flag),
                                 flat2d, q2d)


def _flush_inputs(n, seed, identity=False, k=5):
    rng = np.random.default_rng(seed)
    x_old = rng.standard_normal(n).astype(np.float32)
    x_new = (x_old + 0.01 * rng.standard_normal(n)).astype(np.float32)
    delta = (0.02 * rng.standard_normal(n)).astype(np.float32)
    diff = (0.05 * rng.standard_normal(n)).astype(np.float32)
    q = diff.copy() if identity else (
        diff + 0.01 * rng.standard_normal(n)).astype(np.float32)
    w = (rng.uniform(0.2, 1.0, k) / k).astype(np.float32) if k else None
    return x_old, x_new, delta, diff, q, w


@pytest.mark.parametrize("n,identity,k", [
    (307, False, 3), (79_842, False, 10), (79_842, True, 4),
    (3 * 4096 + 77, False, 0), (1, False, 1)])
def test_plain_flush_taps_match_reference(n, identity, k):
    args = _flush_inputs(n, n + k, identity, k)
    want = np.asarray(_jit_flush_taps(
        *(jnp.asarray(a) for a in args[:5]),
        None if args[5] is None else jnp.asarray(args[5]), jnp.asarray(True)))
    got = ktaps.flush_taps(*(torch.from_numpy(a) for a in args[:5]),
                           None if args[5] is None
                           else torch.from_numpy(args[5]))
    assert got.dtype == torch.float32 and got.shape == (7,)
    _assert_taps_equal(got.numpy(), want)
    if identity:
        assert got[3].item() == 0.0 and _same(got[2], got[4])
    if k == 0:
        assert got[5].item() == got[6].item() == 0.0


def _upload_inputs(b, d, bits, seed):
    """A (b, d) delta stack and its wire codes from the port's batched
    encode (bit-equal to the reference's)."""
    rng = np.random.default_rng(seed)
    flat = (0.01 * rng.standard_normal((b, d))).astype(np.float32)
    flat[0, :300] = 0.0  # an all-zero bucket
    if b > 2:
        flat[2] = 0.0  # an all-zero message: its error must be 0, not NaN
    if bits is None:
        return flat, None, None
    seeds = torch.from_numpy(rng.integers(0, 2**32, (b, 2)))
    packed, norms = ops.qsgd_quantize_batch(torch.from_numpy(flat), seeds,
                                            bits)
    return flat, packed, norms


@pytest.mark.parametrize("bits", [2, 4, 8, None])
@pytest.mark.parametrize("b,d", [(4, 2048), (3, 79_842), (2, 5 * 4096 + 9)])
def test_plain_upload_taps_match_reference(b, d, bits):
    flat, packed, norms = _upload_inputs(b, d, bits, b * d)
    want = np.asarray(_jit_upload_taps(
        jnp.asarray(flat), None if bits is None else jnp.asarray(
            packed.numpy()), None if bits is None else jnp.asarray(
                norms.numpy()), jnp.asarray(True), bits=bits, d=d))
    got = ktaps.upload_taps(torch.from_numpy(flat), packed, norms, bits)
    assert got.dtype == torch.float32 and got.shape == (b, 2)
    _assert_taps_equal(got.numpy(), want)
    if b > 2:
        assert got[2].tolist() == [0.0, 0.0]
    if bits is None:
        assert (got[:, 1] == 0.0).all()


@pytest.mark.parametrize("bits", [4, None])
def test_plain_upload_taps_batch_invariant(bits):
    """Row i of a (4, d) stack has the taps of the same message alone, bit
    for bit: the order of a row's sums depends on d only."""
    b, d = 4, 79_842
    flat, packed, norms = _upload_inputs(b, d, bits, 7)
    whole = ktaps.upload_taps(torch.from_numpy(flat), packed, norms, bits)
    for i in range(b):
        one = ktaps.upload_taps(
            torch.from_numpy(flat[i:i + 1]),
            None if packed is None else packed[i:i + 1].contiguous(),
            None if norms is None else norms[i:i + 1].contiguous(), bits)
        assert _same(whole[i:i + 1], one), i


def _law_sum(v: np.ndarray) -> np.float32:
    """The taps' reduction law written out element by element in float32:
    windows of 32 with floor(pad/2) zeros in front and the rest behind,
    each summed in order from +0, the window sums again so until 32 or
    fewer are left, summed in order."""
    v = v.astype(np.float32)
    while v.size > 32:
        windows = -(-v.size // 32)
        pad = windows * 32 - v.size
        v = np.concatenate([np.zeros(pad // 2, np.float32), v,
                            np.zeros(pad - pad // 2, np.float32)])
        sums = np.zeros(windows, np.float32)
        for w in range(windows):
            acc = np.float32(0.0)
            for x in v[32 * w:32 * w + 32]:
                acc = np.float32(acc + x)
            sums[w] = acc
        v = sums
    acc = np.float32(0.0)
    for x in v:
        acc = np.float32(acc + x)
    return acc


@pytest.mark.parametrize("n", [1, 255, 4096, 3 * 4096 + 77, 257 * 4096 + 5])
def test_tap_sum_is_the_written_law(n):
    rng = np.random.default_rng(n)
    v = (rng.standard_normal(n).astype(np.float32)) ** 2
    got = ref.tap_sum(torch.from_numpy(v))
    assert _same(got, np.asarray(_law_sum(v), np.float32))
    # and it is a sum: close to the float64 one
    assert got.item() == pytest.approx(float(v.astype(np.float64).sum()),
                                       rel=1e-5)


_JSUM = jax.jit(jnp.sum)


@pytest.mark.parametrize("sizes", [
    range(1, 70), range(70, 300, 3), range(300, 4101, 37),
    (65, 100, 129, 200, 1000, 1024, 1025, 2055, 4100, 32768, 32769,
     79_842, 100_000)], ids=["1-69", "70-299", "300-4100", "named"])
def test_xla_sum_is_jitted_jnp_sum(sizes):
    """``ref.xla_sum`` equals XLA:CPU's jitted f32 ``jnp.sum`` bit for bit,
    signed values (not only squares), three vectors per size."""
    for n in sizes:
        for t in range(3):
            v = np.random.default_rng(1000 * n + t).standard_normal(
                n).astype(np.float32)
            assert _same(ref.xla_sum(torch.from_numpy(v)), _JSUM(v)), n


def test_xla_sum_along_rows():
    """Per-row sums of a 2-D array (axis 1, as the upload taps take them)
    follow the same law row by row."""
    for n in (65, 100, 129, 200, 2048, 79_842):
        v = np.random.default_rng(n).standard_normal((8, n)).astype(
            np.float32) ** 2
        want = jax.jit(lambda a: jnp.sum(a, axis=1))(v)
        assert _same(ref.xla_sum(torch.from_numpy(v), dim=1), want), n


def test_tap_wrappers_check_inputs():
    v = torch.zeros(10)
    with pytest.raises(ValueError):
        ktaps.flush_taps(v, v, v, v, torch.zeros(11))
    with pytest.raises(TypeError):
        ktaps.flush_taps(v, v, v, v, v.double())
    with pytest.raises(ValueError):
        ktaps.upload_taps(torch.zeros(2, 10), torch.zeros(2, 1, 64,
                                                          dtype=torch.uint8))
    with pytest.raises(ValueError):
        ktaps.upload_taps(torch.zeros(2, 10), torch.zeros(
            2, 2, 64, dtype=torch.uint8), torch.zeros(2, 2), 4)
    with pytest.raises(ValueError):
        ktaps.upload_taps(torch.zeros(0, 10))
