"""The port's population engine (repro_torch.kernels.population,
ops.population_advance, sim.population) against the JAX package's, on the
CPU.

Bit for bit (``np.array_equal`` on the f32 bit patterns): the scenario
draws of every preset at cohort sizes 1, 4, 32 and 512 against the
reference's jitted draws (XLA:CPU's log, log1p, exp, erfinv and ndtri
spelled in ``kernels.xla_math``, its cumsum in ``xla_cumsum``); the macro
step from ``init_population`` for 60 steps, host-fed and in-step draws,
every ``PopStepOut`` field and every state array, including equal
deadlines at the pop boundary, dropout reaps and the capacity error, on
every preset and on 12 configurations off the presets (poisson arrivals
under a latency scale or stragglers, where XLA:CPU fuses the last
interarrival's product into the next arrival); the
population simulator on the quad task (d = 2048) under host draws and
under in-step draws (``trace_replay`` and ``lognormal_dropout``): x,
x-hat, momentum, traffic, staleness, the accuracy trace, the sim clock and
the event stream; ``PopulationEngine`` metrics on every preset;
``StalenessMonitor.observe_batch``, violations included.

Port against port on the paper's CNN: the population engine under host
draws reproduces the port's cohort engine (the reference's equivalence
pin): event sequence and state bit for bit, times within rtol 1e-5 (f32
device clock against the cohort engine's float64 clock).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import QAFeL as JQAFeL
from repro.core import QAFeLConfig as JConfig
from repro.core.staleness import StalenessMonitor as JMonitor
from repro.kernels import ops as jops
from repro.kernels import population as jpop
from repro.obs.events import RunTracer as JRunTracer
from repro.sim import PopulationAsyncFLSimulator as JPopulation
from repro.sim import PopulationEngine as JEngine
from repro.sim import SimConfig as JSimConfig
from repro.sim import population as jsimpop
from repro.sim import scenarios as jscenarios
from repro_torch.core import QAFeL, QAFeLConfig
from repro_torch.core.staleness import StalenessMonitor
from repro_torch.data import FederatedPartition, SyntheticCelebA
from repro_torch.examples import cohort_scenarios
from repro_torch.kernels import ops as tops
from repro_torch.kernels import population as tpop
from repro_torch.kernels import xla_math
from repro_torch.models.cnn import cnn_accuracy, cnn_loss, init_cnn
from repro_torch.obs import RunTracer
from repro_torch.obs.schema import validate_jsonl
from repro_torch.obs.taps import POPULATION_STATE_NAMES
from repro_torch.sim import (SCENARIOS, CohortAsyncFLSimulator,
                             PopulationAsyncFLSimulator, PopulationEngine,
                             ScenarioConfig, SimConfig)
from repro_torch.sim import population as tsimpop

D = cohort_scenarios.QUAD_D
QCFG = dict(client_lr=0.05, server_lr=1.0, server_momentum=0.3,
            local_steps=2, buffer_size=4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
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


def _compiled(cfg, concurrency):
    jscn = jsimpop.compile_scenario(cfg, concurrency)
    tscn = tsimpop.compile_scenario(cfg, concurrency)
    assert tscn.__dict__ == jscn.__dict__
    return jscn, tscn


# ---------------------------------------------------------------------------
# Draws
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b", [1, 4, 32, 512])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_draws_match_reference(name, b):
    """Every preset, a cohort of b ids from 1000: the reference's jitted
    draws, bit for bit and dtype for dtype."""
    jscn, tscn = _compiled(SCENARIOS[name], 100)
    draw = jax.jit(lambda s, c: jpop.scenario_draws(jscn, s, c))
    want = draw(jpop.run_seeds(11), jnp.arange(1000, 1000 + b,
                                               dtype=jnp.int32))
    got = tpop.scenario_draws(tscn, tpop.run_seeds(11),
                              torch.arange(1000, 1000 + b))
    assert _same(tpop.run_seeds(11), np.asarray(jpop.run_seeds(11))
                 .astype(np.int64))
    for k, (w, g) in enumerate(zip(want, got)):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, k
        assert _same(w, g), (name, b, k)


def test_scenario_draws_are_batch_invariant():
    """A client's draws depend only on (seed, cid): splitting the ids into
    admissions of any size gives the same values."""
    cfg = ScenarioConfig(latency="lognormal", arrival="poisson", dropout=0.2,
                         straggler_frac=0.3, straggler_mult=2.0,
                         tiers=((0.3, "qsgd2"),))
    _, scn = _compiled(cfg, 64)
    seeds, cids = tpop.run_seeds(7), torch.arange(96)
    full = tpop.scenario_draws(scn, seeds, cids)
    for chunk in (1, 7, 32):
        parts = [tpop.scenario_draws(scn, seeds, cids[i:i + chunk])
                 for i in range(0, 96, chunk)]
        for k in range(4):
            assert _same(torch.cat([p[k] for p in parts]), full[k]), \
                (chunk, k)


def _uniform_grid(n=60_000):
    """Hash-uniform values k * 2**-24 spread over [0, 1), both ends in."""
    k = np.unique(np.concatenate([
        np.random.default_rng(0).integers(0, 1 << 24, n),
        [0, 1, 2, (1 << 24) - 2, (1 << 24) - 1]]))
    return (k.astype(np.float32) * np.float32(1.0 / (1 << 24)))


@pytest.mark.parametrize("fn", ["log", "log1p", "exp", "erfinv", "ndtri"])
def test_xla_math_matches_xla(fn):
    """Each spelled function against XLA:CPU's jitted one, bit for bit, on
    the inputs the draws give it and beyond."""
    u = _uniform_grid()
    x = {"log": np.concatenate([u[u > 0], u[u > 0] * 7.5 + 1.0]),
         "log1p": np.concatenate([-u, u]),
         "exp": np.concatenate([u * 20.0 - 10.0, u - 0.5]),
         "erfinv": u, "ndtri": u}[fn].astype(np.float32)
    jfn = {"log": jnp.log, "log1p": jnp.log1p, "exp": jnp.exp,
           "erfinv": jax.scipy.special.erfinv,
           "ndtri": jax.scipy.special.ndtri}[fn]
    want = np.asarray(jax.jit(jfn)(jnp.asarray(x)))
    got = getattr(xla_math, fn)(torch.from_numpy(x))
    assert _same(want, got)


@pytest.mark.parametrize("n", [1, 2, 15, 16, 17, 31, 100, 256, 511, 1023])
def test_xla_cumsum_matches_jnp(n):
    """XLA:CPU's cumsum order (blocks of 16, block totals scanned by the
    same law), against the jitted ``jnp.cumsum`` on interarrival-like
    values."""
    x = np.random.default_rng(n).exponential(0.01, n).astype(np.float32)
    want = np.asarray(jax.jit(jnp.cumsum)(jnp.asarray(x)))
    assert _same(want, tpop.xla_cumsum(torch.from_numpy(x)))


# ---------------------------------------------------------------------------
# The macro step
# ---------------------------------------------------------------------------


def _host_draws(sampler, b, admitting):
    if not admitting:
        return None
    return {"inter": sampler.interarrivals(b).astype(np.float32),
            "tier": sampler.tier_indices(b).astype(np.int32),
            "dur": sampler.durations(b).astype(np.float32),
            "drop": np.asarray(sampler.dropouts(b), bool)}


def _zero_draws(b):
    return {"inter": np.zeros(b, np.float32), "dur": np.zeros(b, np.float32),
            "drop": np.zeros(b, bool), "tier": np.full(b, -1, np.int32)}


def _step_both(cfg, b, d, steps, *, host, concurrency=16, capacity=None,
               draw_fn=None):
    """Drive the reference's and the port's macro step from
    ``init_population`` on the same inputs, comparing every output field
    and state array after each step. Returns the reference's outputs."""
    jscn, tscn = _compiled(cfg, concurrency)
    capacity = capacity or tsimpop._sizing(concurrency, b)
    nb, w = tpop.wheel_shape(capacity)
    statics = dict(capacity=capacity, buckets=nb, bucket_width=w, admit=b,
                   deliver=d, queue_cap=4096)
    jstate = jpop.init_population(capacity, nb, w, 4096)
    tstate = tpop.init_population(capacity, nb, w, 4096, device="cpu")
    sampler = jscenarios.ScenarioSampler(cfg, concurrency,
                                         np.random.default_rng(3))
    draw_fn = draw_fn or (lambda i, admitting: _host_draws(sampler, b,
                                                           admitting))
    admitting, version, outs = True, 0, []
    for i in range(steps):
        draws = draw_fn(i, admitting) if host else None
        # the reference's jitted step takes zero draws when it delivers
        jdraws = (_zero_draws(b) if draws is None else draws) if host \
            else None
        jstate, jout = jops.population_advance(
            jstate, jpop.run_seeds(5), version, jdraws, scenario=jscn,
            **statics)
        jo = jpop.PopStepOut(jax.device_get(jout), b, d)
        to = tpop.PopStepOut(tops.population_advance(
            tstate, tpop.run_seeds(5), version, draws, admitting=admitting,
            scenario=tscn, **statics), b, d)
        assert set(to.keys()) == set(jo.keys())
        for k in jo.keys():
            assert _same(jo[k], to[k]), (i, k, jo[k], to[k])
        assert set(tstate) == set(jstate)
        for k, v in jstate.items():
            assert _same(v, tstate[k]), (i, k)
        # the host's branch is the device's own admission decision
        assert bool(to["admitted"]) == admitting
        outs.append(jo)
        if jo["error"]:
            break
        admitting = bool(jo["will_admit"])
        version = int(jo["delivered_total"]) // 4
    return outs


@pytest.mark.parametrize("host", [True, False], ids=["host", "device"])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_macro_step_matches_reference(name, host):
    """60 macro steps at cohorts of 4 and pops of 3."""
    outs = _step_both(SCENARIOS[name], 4, 3, 60, host=host)
    assert sum(o["admitted"] for o in outs) > 10
    assert outs[-1]["delivered_total"] > 20
    if SCENARIOS[name].dropout:
        assert outs[-1]["discarded_total"] > 0  # dropouts were reaped


@pytest.mark.parametrize("scale,straggle", [(2.0, False), (0.7, False),
                                           (1.0, True), (2.0, True)],
                         ids=["scale2", "scale0.7", "stragglers",
                              "scale2-stragglers"])
@pytest.mark.parametrize("latency", ["half_normal", "lognormal", "uniform"])
def test_macro_step_off_preset_configurations(latency, scale, straggle):
    """Poisson arrivals under a latency scale or stragglers, in-step draws:
    XLA:CPU contracts the last interarrival's product into the next
    arrival's add, ``fma(-log1p(-u), fl32(1/rate), arr[-1])``, as it does
    the duration's into the deadline; 60 macro steps bit for bit."""
    cfg = ScenarioConfig(latency=latency, arrival="poisson",
                         latency_scale=scale,
                         straggler_frac=0.3 if straggle else 0.0,
                         straggler_mult=2.0)
    outs = _step_both(cfg, 4, 3, 60, host=False)
    assert sum(o["admitted"] for o in outs) > 10


@pytest.mark.parametrize("b,d,steps", [(1, 1, 60), (32, 32, 40),
                                       (512, 512, 12)])
@pytest.mark.parametrize("name", ["identity", "lognormal_dropout"])
def test_macro_step_cohort_sizes(name, b, d, steps):
    """In-step draws at cohort sizes 1, 32 and 512 (the cumsum beyond one
    block of 16, and at two levels)."""
    _step_both(SCENARIOS[name], b, d, steps, host=False,
               concurrency=max(16, 2 * b))


def test_macro_step_equal_deadlines_at_the_boundary():
    """Cohorts arriving at one instant with one duration: equal deadlines
    straddle the pop boundary, and both packages pop the lower slots."""
    b, d = 6, 4

    def draws(i, admitting):
        # six members at one instant, the next cohort 3.0 later
        if not admitting:
            return None
        return {"inter": np.float32([0, 0, 0, 0, 0, 3.0]),
                "dur": np.full(b, 0.5, np.float32),
                "drop": np.zeros(b, bool), "tier": np.full(b, -1, np.int32)}
    outs = _step_both(ScenarioConfig(), b, d, 6, host=True, draw_fn=draws)
    pops = [o for o in outs if not o["admitted"]]
    assert pops
    first = pops[0]
    # the whole pop is one deadline and the cohort has more members at it
    assert first["deliver_valid"].all()
    assert len(set(first["deliver_t"].tolist())) == 1
    assert list(first["deliver_slots"]) == sorted(first["deliver_slots"])


def test_macro_step_capacity_error_matches_reference():
    """A wheel too small for the arrival rate: the error flag is set on
    the same step, with every field equal up to it."""
    outs = _step_both(SCENARIOS["identity"], 8, 4, 80, host=False,
                      concurrency=64, capacity=24)
    assert outs[-1]["error"]


def test_host_branch_mismatch_raises():
    """A branch the device does not take is refused."""
    eng = PopulationEngine("identity", concurrency=32, horizon=2.0,
                           admit_batch=4, device="cpu")
    eng.step()
    eng._admitting = not eng._admitting
    with pytest.raises(AssertionError, match="branch"):
        eng.step()


# ---------------------------------------------------------------------------
# The simulator on the quad task, against the reference
# ---------------------------------------------------------------------------


def _jquad_loss(params, batch, key):
    del key
    return jnp.sum((params["w"] - batch["target"]) ** 2)


def _quad_run(jax_side, scenario, draws, cohort_size=4, uploads=40,
              tracer=None, **kw):
    wstar = cohort_scenarios.quad_optimum()
    cfg = dict(concurrency=8, max_uploads=uploads, eval_every_steps=3,
               seed=0)
    if jax_side:
        def batches(cids, keys):
            return {"target": jnp.asarray(
                cohort_scenarios.quad_targets(wstar, cids))}
        batches.batched = True

        def eval_fn(p):
            return float(1.0 - np.linalg.norm(np.asarray(p["w"]) - wstar)
                         / np.linalg.norm(wstar))
        algo = JQAFeL(JConfig(**QCFG), _jquad_loss,
                      {"w": jnp.zeros((D,), jnp.float32)}, telemetry=tracer)
        sim = JPopulation(algo, JSimConfig(**cfg), batches, eval_fn,
                          scenario=scenario, cohort_size=cohort_size,
                          draws=draws, **kw)
    else:
        task = cohort_scenarios.quad_task("cpu")
        algo = QAFeL(cohort_scenarios.qafel_config(4), task.loss_fn,
                     task.params0, device="cpu", telemetry=tracer)
        sim = PopulationAsyncFLSimulator(
            algo, SimConfig(**cfg), task.client_batches, task.eval_fn,
            scenario=scenario, cohort_size=cohort_size, draws=draws, **kw)
    return algo, sim.run()


def _events(tracer):
    return [e.comparable() for e in tracer.events() if e.kind != "compile"]


@pytest.mark.parametrize("scenario,draws", [
    ("identity", "host"), ("lognormal_dropout", "host"),
    ("tiered_bits", "host"), ("trace_replay", "device"),
    ("lognormal_dropout", "device")])
def test_quad_run_matches_reference(scenario, draws):
    """The population simulator on the quad, cohorts of 4, 40 uploads:
    state, metrics, accuracy trace, sim clock and the event stream (taps
    off) bit for bit."""
    jtr, ttr = JRunTracer(taps=False), RunTracer(taps=False)
    jalgo, jres = _quad_run(True, scenario, draws, tracer=jtr)
    talgo, tres = _quad_run(False, scenario, draws, tracer=ttr)
    for name in ("x_flat", "hidden_flat", "momentum_flat"):
        assert _same(getattr(jalgo.state, name),
                     getattr(talgo.state, name)), name
    jm, tm = jres.metrics, tres.metrics
    assert set(jm) == set(tm)
    for key in jm:
        if key != "hidden_drift":
            assert tm[key] == jm[key], key
    assert tres.accuracy_trace == jres.accuracy_trace
    assert tres.sim_time == jres.sim_time
    assert tres.uploads == jres.uploads == 40
    jev, tev = _events(jtr), _events(ttr)
    assert tev == jev
    assert any("population" in e for e in tev)
    if scenario == "lognormal_dropout":
        assert tm["dropped_uploads"] > 0


def test_quad_deliver_batch_is_trajectory_invariant():
    """Popping 1 or 8 completions per step gives the same run."""
    r = [_quad_run(False, "lognormal_dropout", "host", deliver_batch=d)[1]
         for d in (1, 8)]
    assert r[0].accuracy_trace == r[1].accuracy_trace
    strip = [{k: v for k, v in x.metrics.items()
              if k not in ("population_states", "hidden_drift")} for x in r]
    assert strip[0] == strip[1]


def test_quad_device_draws_deterministic_and_seed_sensitive():
    task = cohort_scenarios.quad_task("cpu")

    def run(seed):
        algo = QAFeL(cohort_scenarios.qafel_config(4), task.loss_fn,
                     task.params0, device="cpu")
        return PopulationAsyncFLSimulator(
            algo, SimConfig(concurrency=8, max_uploads=12, seed=seed),
            task.client_batches, task.eval_fn, scenario="lognormal_dropout",
            cohort_size=4).run()
    r1, r2, r3 = run(3), run(3), run(4)
    assert r1.accuracy_trace == r2.accuracy_trace
    assert {k: v for k, v in r1.metrics.items() if k != "hidden_drift"} == \
        {k: v for k, v in r2.metrics.items() if k != "hidden_drift"}
    assert r1.sim_time != r3.sim_time


def test_population_counts_on_eval_events(tmp_path):
    """Eval events carry the per-state counts; they surface as metric
    series and the JSONL validates."""
    tracer = RunTracer(taps=False)
    _, res = _quad_run(False, "lognormal_dropout", "device", tracer=tracer)
    states = res.metrics["population_states"]
    assert set(states) == set(POPULATION_STATE_NAMES)
    assert all(isinstance(v, int) and v >= 0 for v in states.values())
    evs = tracer.events("eval")
    assert evs and all("population" in e.data for e in evs)
    m = tracer.metrics()
    for name in POPULATION_STATE_NAMES:
        assert len(m[f"population/{name}"]) == len(evs)
    path = tmp_path / "pop.jsonl"
    tracer.to_jsonl(path)
    assert validate_jsonl(path) == []


# ---------------------------------------------------------------------------
# Port against port on the paper's CNN: the equivalence pin
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cnn_task():
    ds = SyntheticCelebA(n_samples=400)
    part = FederatedPartition(labels=ds.labels, n_clients=40)

    def client_batches(cid, key):
        rng = np.random.default_rng(int(cid) * 1009 + 7)
        b = [part.client_batch(ds, int(cid), 8, rng) for _ in range(2)]
        return {k: torch.from_numpy(np.stack([bi[k] for bi in b]))
                for k in b[0]}

    test_idx = part.split_indices(part.val_clients)[:128]
    test = {k: torch.from_numpy(v) for k, v in ds.batch(test_idx).items()}

    def loss_fn(params, batch, key):
        return cnn_loss(params, batch, train=True, key=key)[0]
    return loss_fn, client_batches, lambda p: float(cnn_accuracy(p, test))


@pytest.mark.parametrize("scenario", ["identity", "lognormal_dropout"])
def test_cnn_host_draws_match_cohort_engine(cnn_task, scenario):
    """The population engine under host draws against the cohort engine on
    the CNN, cohorts of 4, 16 uploads: state and traffic bit for bit, the
    event sequence equal, times within rtol 1e-5."""
    loss_fn, batches, eval_fn = cnn_task
    runs = []
    for engine in ("cohort", "population"):
        tracer = RunTracer(taps=False)
        algo = QAFeL(QAFeLConfig(**QCFG, client_quantizer="qsgd4",
                                 server_quantizer="qsgd4"), loss_fn,
                     init_cnn(0, device="cpu"), device="cpu",
                     telemetry=tracer)
        cfg = SimConfig(concurrency=8, max_uploads=16, eval_every_steps=2,
                        seed=0, track_hidden_replicas=1)
        kw = {"draws": "host"} if engine == "population" else {}
        cls = (PopulationAsyncFLSimulator if engine == "population"
               else CohortAsyncFLSimulator)
        res = cls(algo, cfg, batches, eval_fn, scenario=scenario,
                  cohort_size=4, **kw).run()
        runs.append((algo, res, tracer))
    (ca, cr, ct), (pa, pr, pt) = runs
    for name in ("x_flat", "hidden_flat", "momentum_flat"):
        assert _same(getattr(ca.state, name), getattr(pa.state, name)), name
    assert pr.uploads == cr.uploads and pr.server_steps == cr.server_steps
    assert [p[1:] for p in pr.accuracy_trace] == \
        [p[1:] for p in cr.accuracy_trace]
    np.testing.assert_allclose([p[0] for p in pr.accuracy_trace],
                               [p[0] for p in cr.accuracy_trace], rtol=1e-5)
    np.testing.assert_allclose(pr.sim_time, cr.sim_time, rtol=1e-5)
    assert {k: v for k, v in pr.metrics.items()
            if k != "population_states"
            and not k.startswith("population/")} == cr.metrics
    assert pr.metrics["replicas_in_sync"]
    seq_c, seq_p = _events(ct), _events(pt)
    times_c = [e.pop("t_sim") for e in seq_c]
    times_p = [e.pop("t_sim") for e in seq_p]
    for e in seq_p:
        e.pop("population", None)
    assert seq_p == seq_c
    np.testing.assert_allclose(times_p, times_c, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# StalenessMonitor.observe_batch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("taus,max_allowed,error", [
    ([0, 3, 1, 0, 7, 2], 0, None),
    ([1, 0, -2, 5], 0, ValueError),
    ([2, 3, 4], 3, RuntimeError),
    ([], 0, None)])
def test_observe_batch_matches_reference(taus, max_allowed, error):
    """Bit-equal to the reference's ``observe_batch`` and to repeated
    ``observe``: the same history (the prefix on a violation), summary
    and error."""
    monitors = [StalenessMonitor(max_allowed=max_allowed),
                StalenessMonitor(max_allowed=max_allowed),
                JMonitor(max_allowed=max_allowed)]
    raised = []
    for i, m in enumerate(monitors):
        try:
            if i == 1:
                for t in taus:
                    m.observe(int(t))
            else:
                m.observe_batch(np.asarray(taus, np.int32))
        except (ValueError, RuntimeError) as e:
            raised.append((type(e), str(e)))
    if error is None:
        assert raised == []
    else:
        assert len(raised) == 3 and len(set(raised)) == 1
        assert raised[0][0] is error
    assert monitors[0].history == monitors[1].history == monitors[2].history
    assert monitors[0].summary() == monitors[2].summary()


# ---------------------------------------------------------------------------
# PopulationEngine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_engine_matches_reference(name):
    """Every preset at concurrency 32 to horizon 4: the reference's
    metrics, staleness summary and macro steps exactly, and the lifecycle
    conserved."""
    kw = dict(concurrency=32, horizon=4.0, seed=1, admit_batch=4,
              deliver_batch=4)
    want = JEngine(name, **kw).advance_to(4.0)
    eng = PopulationEngine(name, device="cpu", **kw)
    m = eng.advance_to(4.0)
    assert m == want
    states = m["population_states"]
    assert sum(states.values()) == eng.capacity
    assert m["admitted"] == (states["working"] + states["offline"]
                             + m["delivered"] + m["discarded"])
    assert m["delivered"] > 0 and m["staleness"]["n"] == m["delivered"]
    assert sum(eng.steps_by_kind.values()) == m["macro_steps"]


def test_engine_deterministic_and_seed_sensitive():
    def run(seed):
        return PopulationEngine("lognormal_dropout", concurrency=64,
                                horizon=3.0, seed=seed, admit_batch=8,
                                device="cpu").advance_to(3.0)
    assert run(5) == run(5)
    assert run(6) != run(5)


def test_engine_capacity_exhaustion_raises():
    with pytest.raises(RuntimeError, match="capacity exhausted"):
        PopulationEngine("identity", concurrency=64, horizon=4.0,
                         admit_batch=8, capacity=16,
                         device="cpu").advance_to(4.0)


def test_population_entry_points_default_to_cuda(monkeypatch):
    """The engine and ``--engine population`` ask for CUDA unless given
    the CPU, and run on the CPU when asked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PopulationEngine("identity", concurrency=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        cohort_scenarios.main(["--uploads", "1", "--model", "quad",
                               "--engine", "population"])
    cohort_scenarios.main(["--uploads", "8", "--model", "quad",
                           "--engine", "population", "--device", "cpu",
                           "--scenario", "lognormal_dropout"])
