"""The port's flat mesh (``sharding.rules``, ``launch.mesh``,
``kernels.ops.server_flush_step_sharded``, ``QAFeL(mesh=)``, the cohort
step and engine on a mesh, checkpoints across meshes) against the JAX
package, on the CPU.

The rules' flat math runs here against ``repro.sharding.rules``. The rest
runs once for the module in one gloo group of 4 processes
(``tests/mesh_ranks.py``, each rank on one torch thread), on a (4,) mesh
and a (2, 2) one, and rank 0 hands back what the ranks made; everything is
held bit for bit (f32 bit patterns, codes, and every meter, staleness and
tap figure exactly):

* the sharded flush in row chunks of 1 with taps, at d = 307 (three wire
  rows, the last ragged: the reference's non-dividing edge), against the
  reference's unsharded ``server_flush_step``, and in a subprocess against
  its own ``server_flush_step_sharded`` on 4 virtual CPU devices (taps
  off: its taps raise on this jax at a non-dividing n), whose segment
  indices are the port's too;
* ``QAFeL(mesh=)`` over ten uploads (a qsgd2 tier in every third) against
  the reference's meshless ``QAFeL``, flush by flush: qsgd4 both ways,
  identity with no momentum, a top_k0.2 server, a lowrank4g32 window,
  ``chunk_rows=1`` (held to the reference's unchunked run: its chunked
  threefry encode is no oracle on this jax, ROADMAP queue C) and taps;
* the cohort step at b = 5 over the data ranks against the reference's
  ``cohort_train_encode_step``;
* the cohort engine on the quad (``tiered_bits``, cohorts of 5) against
  the port's meshless run: accuracy trace, meters, staleness, replicas;
* one run through archives on 4 ranks, then 2, then none, then 4 again,
  against the reference's uninterrupted meshless run.

The LLM round on ("data", "model") meshes (``make_qafel_round(mesh=)``),
in the same group (``mesh_ranks.LLM_CASES``: reduced gemma2-2b on (4, 1),
(2, 2) and (1, 4), reduced granite-34b on (1, 4); K = 2, P = 1, local
batch 2, seq 32). Before the ranks start, this process runs the
reference's unsharded jitted rounds and the port's meshless round with
its messages captured, and hands the ranks the states and messages
(``llm_in.npz``); the reference subprocess runs the reference's round
under its own rules (``state_pspecs``) on an ``AxisType.Auto`` mesh of 4
virtual devices (GSPMD):

* (4, 1) is the port's meshless round bit for bit (x, x-hat, m, the loss,
  the wire bytes, the taps);
* (2, 2) (two rounds, each from the reference's state) and (1, 4) meet
  ``test_torch_llm_round``'s bounds against the reference's unsharded
  round and against its GSPMD round; codeqwen1.5-7b (qkv biases) on (2,
  2) and qwen3-14b (qk-norm) on (1, 4) the same bounds against the port's
  meshless round;
* remat changes no bit on (2, 2); the server half fed the meshless
  round's messages gives its x, x-hat, m, broadcast codes and norms and
  taps bit for bit;
* on (1, 4) rank 0 makes no floating tensor beyond its shards, their
  gradients and the client's working copy larger than its segment or the
  largest leaf.

The specs (``param_pspecs``, ``state_pspecs``, ``batch_pspecs``,
``cache_pspecs``) equal the reference's on all 10 archs and five meshes
in process, and ``sharded_bytes`` the dry run's on all 40 arch x shape
pairs (read in the reference subprocess: ``repro.launch.dryrun`` sets
``XLA_FLAGS`` at import).
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mesh_ranks as R
import test_torch_llm_round as LR
from repro import configs as JC
from repro.core import QAFeL as JQAFeL
from repro.core import QAFeLConfig as JConfig
from repro.core.protocol import CLIENT_UPDATE as J_UPDATE
from repro.core.protocol import decode_message_flat as jdecode
from repro.core.protocol import frame_cohort_messages as jframe
from repro.core.quantizers import make_quantizer as jmake_quantizer
from repro.kernels import ops as jops
from repro.core.qafel import QAFeLConfig as JLConfig
from repro.core.quantizers import flatten_tree as jflatten
from repro.data.synthetic import synthetic_batch_for_config as jbatch
from repro.distributed import steps as JS
from repro.launch import shapes as JSH
from repro.obs import RunTracer as JTracer
from repro.sharding import rules as JR
from repro_torch import configs as TC
from repro_torch.common import prng
from repro_torch.convert import round_state_from_jax
from repro_torch.core.qafel import QAFeLConfig as TLConfig
from repro_torch.distributed import steps as TS
from repro_torch.launch import shapes as TSH
from repro_torch.sharding import rules as TR

ROOT = Path(__file__).resolve().parents[1]
MESHES = tuple(R.MESHES)


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(a, b) -> bool:
    a, b = _bits(a), _bits(b)
    return a.shape == b.shape and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# The rules' flat math, in process
# ---------------------------------------------------------------------------

SHAPES = {"1d": (("data",), (4,)), "2d": (("data", "model"), (2, 2)),
          "2d_tall": (("data", "model"), (3, 2)),
          "pods": (("pod", "data", "model"), (2, 2, 4)),
          "model_only": (("model",), (4,))}


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_flat_rules_match_reference(case):
    """The axes, extents and padded lengths of meshes of each layout,
    against ``repro.sharding.rules`` over n up to 3,000 and segment counts
    1-9; the port's segment index as the data-major fold of every
    coordinate."""
    names, shape = SHAPES[case]
    jmesh = SimpleNamespace(axis_names=names, shape=dict(zip(names, shape)))
    coords = list(np.ndindex(*shape))
    tmesh = lambda c=None: SimpleNamespace(
        mesh_dim_names=names, shape=shape, get_coordinate=lambda: c)
    for fn in ("flat_axes", "mesh_data_extent", "mesh_model_extent",
               "mesh_flat_extent"):
        assert getattr(TR, fn)(tmesh()) == getattr(JR, fn)(jmesh), fn
        assert getattr(TR, fn)(None) == getattr(JR, fn)(None), fn
    for a in names:
        assert TR.mesh_extent_of(tmesh(), a) == JR.mesh_extent_of(jmesh, a)
    for n in (1, 127, 128, 129, 307, 1000, 2999, 3000):
        for ndev in range(1, 10):
            assert TR.flat_padded_len(n, ndev) == JR.flat_padded_len(n,
                                                                     ndev)
    flat = JR.flat_axes(jmesh)
    want = sorted(int(np.ravel_multi_index(
        [c[names.index(a)] for a in flat],
        [dict(zip(names, shape))[a] for a in flat])) for c in coords)
    got = sorted(TR.flat_segment_index(tmesh(list(c))) for c in coords)
    assert got == want
    assert TR.flat_segment_index(None) == 0
    with pytest.raises(ValueError, match="not in the mesh"):
        TR.flat_segment_index(tmesh(None))


def test_meshes_need_an_initialised_group():
    """The mesh constructors never start a group of their own."""
    from repro_torch.launch import mesh as TM
    for fn in (TM.make_sim_mesh, TM.make_sim_mesh2d, TM.make_host_mesh,
               TM.make_production_mesh):
        with pytest.raises(RuntimeError, match="init_process_group"):
            fn()


# ---------------------------------------------------------------------------
# The 4-rank group, once for the module
# ---------------------------------------------------------------------------


def test_mesh_constructors_on_four_ranks(ranks):
    """On the 4-rank group: a mesh larger than the group raises naming the
    world size it needs; the host mesh is rank 0's alone, a 2-rank mesh
    ranks 0 and 1's; ``make_sim_mesh()`` takes all 4."""
    api = ranks.info["mesh_api"]
    for r, a in enumerate(api):
        assert "needs 8 ranks" in a["sim8"] and "has 4" in a["sim8"]
        assert "needs 8 ranks" in a["sim2d_4x2"]
        assert "needs 256 ranks" in a["production"]
        assert a["host"] == ([0, 0] if r == 0 else None)
        assert a["sub2"] == ([r] if r < 2 else None)
        assert a["default"] == [4]


def _jround_batch(cfg, step: int) -> dict:
    """``mesh_ranks.llm_batch`` drawn by the reference's function."""
    rng = np.random.default_rng(0)
    k, p = R.LLM_Q["buffer_size"], R.LLM_Q["local_steps"]
    for _ in range(step + 1):
        raw = jbatch(cfg, rng, k * p * R.LLM_LOCAL, R.LLM_SEQ)
    return {n: v.reshape((k, p, R.LLM_LOCAL) + v.shape[1:])
            for n, v in raw.items()}


def _llm_inputs(out: Path) -> SimpleNamespace:
    """The reference's unsharded jitted rounds (gemma2-2b: two, each from
    its own state before it; granite-34b: one) and the port's meshless
    round of gemma2-2b from the same state, its messages captured
    (``on_message``), with taps; the states and messages go to
    ``llm_in.npz`` for the ranks."""
    arrays, ref = {}, {}
    for arch, rounds in (("gemma2-2b", 2), ("granite-34b", 1)):
        jc = JC.get_reduced(arch)
        jround = jax.jit(JS.make_qafel_round(jc, JLConfig(**R.LLM_Q),
                                             remat=False))
        state = jax.device_get(JS.init_round_state(jc, jax.random.PRNGKey(0)))
        states, losses = [state], []
        for r in range(rounds):
            state, met = jround(state, {k: jnp.asarray(v) for k, v in
                                        _jround_batch(jc, r).items()},
                                jnp.asarray(R.LLM_WEIGHTS),
                                jax.random.PRNGKey(r))
            state = jax.device_get(state)
            states.append(state)
            losses.append(float(met["loss"]))
        for r, st in enumerate(states):
            for name in R.STATE:
                arrays[f"{arch}/r{r}/{name}"] = np.asarray(
                    jflatten(getattr(st, name))[0], np.float32)
            arrays[f"{arch}/r{r}/t"] = np.asarray(st.t)
        ref[arch] = {"states": states, "losses": losses}
    cfg = TC.get_reduced("gemma2-2b")
    msgs = {}

    def record(kind, k, a, b):
        msgs[f"{kind}{k if kind == 'upload' else ''}"] = (a.clone(),
                                                          b.clone())
    fn = TS.make_qafel_round(cfg, TLConfig(**R.LLM_Q), remat=False,
                             taps=True, on_message=record)
    tstate = round_state_from_jax(ref["gemma2-2b"]["states"][0],
                                  device="cpu")
    tstate, met = fn(tstate, R.llm_batch(cfg, 0),
                     torch.from_numpy(R.LLM_WEIGHTS), prng.PRNGKey(0))
    for k in range(R.LLM_Q["buffer_size"]):
        arrays[f"msg/upload{k}_packed"] = msgs[f"upload{k}"][0].numpy()
        arrays[f"msg/upload{k}_norms"] = msgs[f"upload{k}"][1].numpy()
    meshless = {name: f.numpy().copy() for name, f in zip(R.STATE,
                                                          tstate.flat)}
    meshless.update(packed=msgs["broadcast"][0].numpy(),
                    norms=msgs["broadcast"][1].numpy(),
                    taps=met["taps"].numpy(), loss=float(met["loss"]),
                    upload_bytes=met["upload_bytes"],
                    broadcast_bytes=met["broadcast_bytes"])
    R.write_npz(out / "llm_in.npz", arrays)
    return SimpleNamespace(ref=ref, meshless=meshless)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The 4 ranks' results, and beside them, started at the same time,
    the reference's own sharded flush, its GSPMD rounds and its dry run's
    bytes on 4 virtual devices (``_SHARDED_REFERENCE``, its ``XLA_FLAGS``
    in its environment only); before them, this process's LLM rounds
    (``_llm_inputs``), on one torch thread, while the ranks and the
    subprocess run what needs none of it."""
    out = tmp_path_factory.mktemp("mesh_ranks")
    path = os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")])
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "mesh_ranks.py"), str(out),
         "--llm"],
        env=dict(os.environ, PYTHONPATH=path, OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
        subprocess.Popen(
        [sys.executable, "-c", _SHARDED_REFERENCE, str(out / "ref.npz"),
         str(ROOT / "src"), str(ROOT / "tests"), str(out / "llm_in.npz"),
         str(out / "ref_bytes.json")],
        env=dict(os.environ, PYTHONPATH=path, JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:  # while the ranks run their flat mesh, which needs none of it
        llm = _llm_inputs(out)
    except BaseException:
        for p in procs:
            p.kill()
        raise
    finally:
        torch.set_num_threads(threads)
    errs = [p.communicate(timeout=600)[1] for p in procs]
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-4000:]
    with np.load(out / "ranks.npz") as data:
        arrays = {k: data[k] for k in data.files}
    return SimpleNamespace(arrays=arrays, out=out, info=json.loads(
        (out / "ranks.json").read_text()), reference=dict(np.load(
            out / "ref.npz")), llm=llm, ref_bytes=json.loads(
            (out / "ref_bytes.json").read_text()))


def _jflush(taps=True):
    f = R.flush_inputs()
    return jops.server_flush_step(
        jnp.asarray(f["x"]), jnp.asarray(f["hidden"]),
        jnp.asarray(f["momentum"]), jnp.asarray(f["stack"]),
        jnp.asarray(f["norms"]), jnp.asarray(f["weights"]), None,
        jnp.asarray(f["key2d"]), jnp.asarray(True), bits=4, sbits=4, n=R.N,
        lr=1.2, beta=0.3, taps=taps)


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_flush_is_the_unsharded_reference(ranks, mesh):
    """The sharded flush (row chunks of 1, taps) on each mesh against the
    reference's ``server_flush_step``: x, x-hat, m, the broadcast's codes
    and norms and the tap vector."""
    want = _jflush()
    got = {k[len(f"flush_{mesh}_"):]: v for k, v in ranks.arrays.items()
           if k.startswith(f"flush_{mesh}_")}
    for name, w in (("x", want[0]), ("hidden", want[1]),
                    ("momentum", want[2]), ("packed", want[3][0]),
                    ("norms", want[3][1]), ("taps", want[4])):
        assert _same(got[name], w), name


def _jalgo(name: str):
    kw = R.variant_config(name)
    tracer = JTracer(taps=True) if R.VARIANTS[name].get("taps") else None
    return JQAFeL(JConfig(**kw), _jloss, {"w": jnp.zeros((R.W,)),
                                          "b": jnp.ones((R.B,))},
                  telemetry=tracer)


def _jloss(params, batch, key):
    del key
    t = batch["target"]
    return (jnp.sum((params["w"] - t[:R.W]) ** 2)
            + jnp.sum((params["b"] - t[R.W:]) ** 2))


def _jdrive(algo, lo, hi, seed=4, record=None):
    """``mesh_ranks.drive``'s uploads into the reference's ``algo``."""
    key = jax.random.PRNGKey(seed)
    q2 = jmake_quantizer("qsgd2")
    for i in range(hi):
        key, k2, k3 = jax.random.split(key, 3)
        if i < lo:
            continue
        batches = {"target": jnp.asarray(R.TARGETS[i])}
        if R.tier(i) and algo.cq.spec.kind == "qsgd":
            st = algo.state
            kt, ke = jax.random.split(k2)
            out = jops.cohort_train_encode_step(
                algo.loss_fn, algo.qcfg, q2.spec, st.layout, st.hidden_flat,
                batches, kt, ke, algo._flag, b=1)
            msg = jframe(J_UPDATE, q2, out, st.layout, enc_keys=[ke],
                         version=st.t)[0]
        else:
            msg, _ = algo.run_client(batches, k2)
        bmsg = algo.receive(msg, k3)
        if bmsg is not None and record is not None:
            record(algo, bmsg)
    return algo


def _jstate(algo) -> dict:
    return {n: np.asarray(getattr(algo.state, n + "_flat"))[:R.N]
            for n in ("x", "hidden", "momentum")}


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", sorted(R.VARIANTS))
def test_qafel_on_mesh_is_the_reference(ranks, name, mesh):
    """``QAFeL(mesh=)`` against the reference's meshless ``QAFeL`` on the
    same uploads, after every flush: x, x-hat, m, the decoded broadcast and
    its bytes; then the meters and the flush taps, and the hidden drift
    against the port's meshless run."""
    algo = _jalgo(name)
    flushes, wire = [], []

    def record(a, bmsg):
        flushes.append(dict(_jstate(a), q=np.asarray(jdecode(a.sq, bmsg))))
        wire.append(bmsg.wire_bytes)
    _jdrive(algo, 0, R.UPLOADS, record=record)
    info = ranks.info[f"{name}_{mesh}"]
    assert len(flushes) == 3 and info["wire_bytes"] == wire
    for i, want in enumerate(flushes, 1):
        for k, w in want.items():
            assert _same(ranks.arrays[f"{name}_{mesh}_{i}_{k}"], w), (i, k)
    assert info["meter"] == algo.meter.summary()
    # the drift's sums are the port's own (tests/test_torch_server.py):
    # held to the port's meshless run
    assert info["drift"] == R.run_variant(name, None)[1]["drift"]
    if R.VARIANTS[name].get("taps"):
        want = [e.data["taps"] for e in algo.telemetry.events("flush")]
        assert info["taps"] == json.loads(json.dumps(want))


@pytest.mark.parametrize("mesh", MESHES)
def test_cohort_step_on_mesh_is_the_reference(ranks, mesh):
    """b = 5 members over the data ranks (4: padded to 8; 2: to 6)
    against the reference's meshless vmapped step: codes, norms, taps."""
    got = {k[len(f"cohort_{mesh}_"):]: v for k, v in ranks.arrays.items()
           if k.startswith(f"cohort_{mesh}_")}
    algo = _jalgo("qsgd4")
    want = jops.cohort_train_encode_step(
        _jloss, algo.qcfg, jmake_quantizer("qsgd4").spec, algo.state.layout,
        jnp.asarray(got["hidden"]),
        {"target": jnp.asarray(R.TARGETS[:R.COHORT_B])},
        jnp.asarray(got["k_train"].astype(np.uint32)),
        jnp.asarray(got["k_enc"].astype(np.uint32)), algo._flag,
        b=R.COHORT_B, taps=True)
    for name in ("packed", "norms", "taps"):
        assert _same(got[name], want[name]), name


@pytest.mark.parametrize("mesh", MESHES)
def test_cohort_sim_on_mesh_is_the_meshless_run(ranks, mesh):
    """The cohort engine on the quad with ``QAFeL(mesh=)`` against the
    port's meshless run: the accuracy trace, meters and staleness, the
    uploads and server steps, the replicas in sync and x."""
    want = json.loads(json.dumps(R.run_sim(None)))
    got = ranks.info[f"sim_{mesh}"]
    assert got == want
    assert got["metrics"]["replicas_in_sync"] is True


def test_checkpoint_reshards_four_two_one_four(ranks):
    """Archives move between 4 ranks, 2, none and 4 again, and the run
    continues as the reference's uninterrupted meshless one, bit for
    bit, at every stage."""
    algo = _jalgo("qsgd4")
    for stage, (lo, hi) in enumerate(((0, 7), (7, 11), (11, 14), (14, 18))):
        _jdrive(algo, lo, hi)
        for k, w in _jstate(algo).items():
            assert _same(ranks.arrays[f"stage{stage}_{k}"], w), (stage, k)
    assert int(ranks.arrays["t"][0]) == algo.state.t == 6
    meta = lambda i: json.loads(bytes(np.load(
        ranks.out / f"reshard_{i}.npz")["__meta__"]).decode())["sharding"]
    assert meta(0)["devices"] == 4 and meta(0)["axes"] == ["data"]
    assert meta(0)["n_padded"] == 4 * 128 and meta(0)["n"] == R.N
    assert meta(1)["mesh_shape"] == [2] and meta(2)["devices"] == 1


_SHARDED_REFERENCE = textwrap.dedent("""
    import sys
    import numpy as np
    import jax, jax.numpy as jnp
    sys.path[:0] = [sys.argv[2], sys.argv[3]]
    import mesh_ranks as R
    from repro.core.qafel import place_flat_on_mesh
    from repro.kernels import ops
    from repro.launch.mesh import make_sim_mesh, make_sim_mesh2d
    from repro.sharding.rules import flat_padded_len, flat_segment_index
    from repro.common.compat import shard_map
    from jax.sharding import PartitionSpec as P
    assert jax.device_count() == 4
    f = R.flush_inputs()
    out = {}
    for name, mesh in (("4", make_sim_mesh(4)),
                       ("2x2", make_sim_mesh2d((2, 2)))):
        rows = flat_padded_len(R.N, 4) // 128
        pad = lambda a: np.concatenate(
            [a, np.zeros((a.shape[0], rows - a.shape[1]) + a.shape[2:],
                         a.dtype)], axis=1)
        res = ops.server_flush_step_sharded(
            *(place_flat_on_mesh(f[k], mesh, R.N)
              for k in ("x", "hidden", "momentum")),
            jnp.asarray(pad(f["stack"])), jnp.asarray(pad(f["norms"])),
            jnp.asarray(f["weights"]), None, jnp.asarray(f["key2d"]),
            jnp.asarray(True), bits=4, sbits=4, lr=1.2, beta=0.3,
            mesh=mesh, n=R.N, chunk_rows=1)
        for k, v in zip(("x", "hidden", "momentum"), res[:3]):
            out[f"{name}_{k}"] = np.asarray(v)[:R.N]
        out[f"{name}_packed"] = np.asarray(res[3][0])
        out[f"{name}_norms"] = np.asarray(res[3][1])
        axes = tuple(mesh.axis_names)
        seg = shard_map(lambda v: v * 0 + flat_segment_index(mesh),
                        mesh=mesh, in_specs=P(axes), out_specs=P(axes),
                        check_vma=False)(jnp.zeros(4, jnp.int32))
        out[f"{name}_segments"] = np.asarray(seg)

    from jax.sharding import AxisType, NamedSharding
    from repro import configs as JC
    from repro.core.qafel import QAFeLConfig
    from repro.core.quantizers import flatten_tree
    from repro.data.synthetic import synthetic_batch_for_config
    from repro.distributed import steps as JS
    from repro.sharding.rules import (ShardingRules, batch_pspecs,
                                      cache_pspecs, param_pspecs,
                                      state_pspecs)

    # the dry run's per-device bytes of every arch x shape on the
    # production meshes (its module sets XLA_FLAGS, here after the
    # devices exist), while the test process makes llm_in.npz
    import json
    from types import SimpleNamespace
    from repro.launch import dryrun
    from repro.launch.shapes import SHAPES, input_specs
    nbytes = {}
    for arch in JC.list_archs():
        cfg = JC.get_config(arch)
        fsdp = cfg.param_count() > dryrun.FSDP_THRESHOLD
        for shape in SHAPES:
            spec = input_specs(cfg, shape, dryrun.default_qcfg())
            for mname, ext in R.PRODUCTION_MESHES.items():
                m = SimpleNamespace(axis_names=tuple(ext), shape=dict(ext))
                rules = ShardingRules(mesh=m, fsdp=fsdp)
                key = f"{arch}|{shape}|{mname}"
                if spec["kind"] == "train":
                    nbytes[key + "|state"] = dryrun.sharded_bytes(
                        spec["state"], state_pspecs(rules, cfg,
                                                    spec["state"]), m)
                    continue
                nbytes[key + "|params"] = dryrun.sharded_bytes(
                    spec["params"], param_pspecs(rules, cfg,
                                                 spec["params"]), m)
                if spec["kind"] == "decode":
                    nbytes[key + "|cache"] = dryrun.sharded_bytes(
                        spec["cache"], cache_pspecs(rules, cfg,
                                                    spec["cache"]), m)
    with open(sys.argv[5], "w") as f:
        json.dump(nbytes, f)

    # the reference's round under its own rules on an Auto-typed mesh
    # (GSPMD; jax.make_mesh's default explicit axes raise on this jax)
    k, p = R.LLM_Q["buffer_size"], R.LLM_Q["local_steps"]

    def batch(cfg, step):
        rng = np.random.default_rng(0)
        for _ in range(step + 1):
            raw = synthetic_batch_for_config(cfg, rng, k * p * R.LLM_LOCAL,
                                             R.LLM_SEQ)
        return {n: jnp.asarray(v.reshape((k, p, R.LLM_LOCAL) + v.shape[1:]))
                for n, v in raw.items()}

    # round 1 from the seed's initial state (the test process's too),
    # later rounds from the unsharded round's state in llm_in.npz
    fns, layouts = {}, {}
    for case, r in (("gemma2-2b_2x2", 0), ("granite-34b_1x4", 0),
                    ("gemma2-2b_2x2", 1)):
        arch, shape = R.LLM_CASES[case][:2]
        cfg = JC.get_reduced(arch)
        if r == 0:
            st = JS.init_round_state(cfg, jax.random.PRNGKey(0))
            layouts[case] = flatten_tree(st.x)[1]
        else:
            llm = np.load(R.wait_for(sys.argv[4]))
            st = JS.RoundState(*(layouts[case].unflatten(jnp.asarray(
                llm[f"{arch}/r{r}/{n}"])) for n in R.STATE),
                t=jnp.asarray(llm[f"{arch}/r{r}/t"]))
        b = batch(cfg, r)
        if case not in fns:
            mesh = jax.make_mesh(shape, ("data", "model"),
                                 axis_types=(AxisType.Auto,) * 2)
            rules = ShardingRules(mesh=mesh)
            sh = lambda specs: jax.tree.map(
                lambda s: NamedSharding(mesh, s), specs,
                is_leaf=lambda x: isinstance(x, P))
            fns[case] = jax.jit(JS.make_qafel_round(
                cfg, QAFeLConfig(**R.LLM_Q), remat=False), in_shardings=(
                sh(state_pspecs(rules, cfg, st)),
                sh(batch_pspecs(rules, b, batch_dim=2)),
                NamedSharding(mesh, P()), NamedSharding(mesh, P())))
        new, met = fns[case](st, b, jnp.asarray(R.LLM_WEIGHTS),
                             jax.random.PRNGKey(r))
        new = jax.device_get(new)
        for n in R.STATE:
            out[f"gspmd_{case}_{r + 1}_{n}"] = np.asarray(
                flatten_tree(getattr(new, n))[0])
        out[f"gspmd_{case}_{r + 1}_t"] = np.asarray(new.t)
        out[f"gspmd_{case}_{r + 1}_loss"] = np.asarray(met["loss"])
    np.savez(sys.argv[1], **out)
""")


def test_sharded_flush_is_the_sharded_reference(ranks):
    """The reference's own ``server_flush_step_sharded`` (row chunks of 1)
    on 4 virtual CPU devices, (4,) and (2, 2), in a subprocess with its
    ``XLA_FLAGS``: the port's sharded flush (with taps, which change no
    bit) equals it bit for bit, and the devices' segment indices
    (row-major over the mesh's devices) are the port's data-major fold.
    The reference's taps are not run here: on this jax its gather of a
    sharded vector cut to n = 307 raises a ``ShardingTypeError``
    (``repro/kernels/ops.py:945``, ROADMAP queue C); the port's taps are
    held to its unsharded flush's above."""
    want = ranks.reference
    for mesh in MESHES:
        for k in ("x", "hidden", "momentum", "packed", "norms"):
            assert _same(ranks.arrays[f"flush_{mesh}_{k}"],
                         want[f"{mesh}_{k}"][:ranks.arrays[
                             f"flush_{mesh}_{k}"].shape[0]]), (mesh, k)
        assert want[f"{mesh}_segments"].tolist() == [0, 1, 2, 3]


# ---------------------------------------------------------------------------
# The specs against the reference's, in process
# ---------------------------------------------------------------------------

SPEC_MESHES = dict(R.PRODUCTION_MESHES, **{
    "1x4": {"data": 1, "model": 4}, "2x2": {"data": 2, "model": 2},
    "4x1": {"data": 4, "model": 1}})


def _jmesh(ext):
    return SimpleNamespace(axis_names=tuple(ext), shape=dict(ext))


def _tmesh(ext):
    return SimpleNamespace(mesh_dim_names=tuple(ext), shape=dict(ext))


def _jspecs(tree) -> list:
    from jax.sharding import PartitionSpec as P
    return [tuple(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, P))]


@pytest.mark.parametrize("arch", sorted(TC.list_archs()))
def test_specs_are_the_references(arch):
    """``param_pspecs``, ``state_pspecs`` (x, x-hat, m and the step),
    ``batch_pspecs`` (the round's batch at dim 2, the prefill inputs at
    dim 0) and ``cache_pspecs`` (decode_32k and long_500k's B = 1, with
    and without ``cache_seq_shard``) of the published config on ``meta``
    against the reference's on its ``ShapeDtypeStruct``s, entry for
    entry, on the production meshes and (1, 4), (2, 2), (4, 1), FSDP on
    and off; and ``to_shardings``' placements of each param spec."""
    from torch.distributed.tensor import Replicate, Shard

    jc, tc = JC.get_config(arch), TC.get_config(arch)
    jin = {s: JSH.input_specs(jc, s) for s in ("train_4k", "prefill_32k",
                                               "decode_32k", "long_500k")}
    tin = {s: TSH.input_specs(tc, s) for s in jin}
    jp, tp = jin["prefill_32k"]["params"], tin["prefill_32k"]["params"]
    for mname, ext in SPEC_MESHES.items():
        for fsdp in (False, True):
            for seq in (False, True):
                jr = JR.ShardingRules(mesh=_jmesh(ext), fsdp=fsdp,
                                      cache_seq_shard=seq)
                tr = TR.ShardingRules(mesh=_tmesh(ext), fsdp=fsdp,
                                      cache_seq_shard=seq)
                tag = (mname, fsdp, seq)
                for s in ("decode_32k", "long_500k"):
                    assert TR.spec_leaves(TR.cache_pspecs(
                        tr, tc, tin[s]["cache"])) == _jspecs(
                        JR.cache_pspecs(jr, jc, jin[s]["cache"])), (tag, s)
                if seq:
                    continue
                tspecs = TR.param_pspecs(tr, tc, tp)
                assert TR.spec_leaves(tspecs) == _jspecs(
                    JR.param_pspecs(jr, jc, jp)), tag
                js = JR.state_pspecs(jr, jc, jin["train_4k"]["state"])
                ts = TR.state_pspecs(tr, tc, tin["train_4k"]["state"])
                for name in ("x", "hidden", "momentum"):
                    assert TR.spec_leaves(getattr(ts, name)) == _jspecs(
                        getattr(js, name)), (tag, name)
                assert ts.t == tuple(js.t) == ()
                for s, dim, key in (("train_4k", 2, "batch"),
                                    ("prefill_32k", 0, "inputs")):
                    assert TR.spec_leaves(TR.batch_pspecs(
                        tr, tin[s][key], batch_dim=dim)) == _jspecs(
                        JR.batch_pspecs(jr, jin[s][key], batch_dim=dim)), (
                        tag, s)
                for spec, pl in zip(TR.spec_leaves(tspecs),
                                    TR.spec_leaves(TR.to_shardings(
                                        tr, tspecs))):
                    for name, place in zip(tuple(ext), pl):
                        dims = [i for i, e in enumerate(spec)
                                if name in TR.spec_axes(e)]
                        assert place == (Shard(dims[0]) if dims
                                         else Replicate())


def test_sharded_bytes_are_the_dry_runs(ranks):
    """``sharded_bytes`` of the state (train shapes), the parameters and
    the cache (decode shapes) of all 40 arch x shape pairs on the
    production meshes, FSDP above the dry run's threshold, against
    ``repro.launch.dryrun.sharded_bytes`` (read in the reference
    subprocess)."""
    want = ranks.ref_bytes
    seen = set()
    for key, nbytes in want.items():
        arch, shape, mname, part = key.split("|")
        seen.add((arch, shape))
        cfg = TC.get_config(arch)
        spec = TSH.input_specs(cfg, shape)
        rules = TR.ShardingRules(
            mesh=_tmesh(R.PRODUCTION_MESHES[mname]),
            fsdp=JC.get_config(arch).param_count() > 8_000_000_000)
        fn = {"state": TR.state_pspecs, "params": TR.param_pspecs,
              "cache": TR.cache_pspecs}[part]
        got = TR.sharded_bytes(spec[part], fn(rules, cfg, spec[part]),
                               rules.mesh)
        assert got == nbytes, key
    assert len(seen) == 40


# ---------------------------------------------------------------------------
# The LLM round on ("data", "model") meshes
# ---------------------------------------------------------------------------


def _llm(ranks, case: str, r: int) -> dict:
    return {n: ranks.arrays[f"llm_{case}_{r}_{n}"] for n in R.STATE}


def test_llm_round_on_4x1_is_the_meshless_round(ranks):
    """On (4, 1) the round is the port's meshless round bit for bit: x,
    x-hat, m, the loss, the wire bytes and the taps."""
    want = ranks.llm.meshless
    got = _llm(ranks, "gemma2-2b_4x1", 1)
    for name in R.STATE:
        assert _same(got[name], want[name]), name
    info = ranks.info["llm"]["gemma2-2b_4x1_1"]
    assert info["loss"] == want["loss"]
    assert info["upload_bytes"] == want["upload_bytes"]
    assert info["broadcast_bytes"] == want["broadcast_bytes"]
    assert _same(ranks.arrays["llm_gemma2-2b_4x1_1_taps"], want["taps"])


# the GSPMD round each case is held to (the reference's runs on (2, 2)
# for gemma2-2b and (1, 4) for granite-34b; the same inputs)
GSPMD_OF = {"gemma2-2b_2x2": "gemma2-2b_2x2",
            "gemma2-2b_1x4": "gemma2-2b_2x2",
            "granite-34b_1x4": "granite-34b_1x4"}


@pytest.mark.parametrize("oracle", ["unsharded", "gspmd"])
@pytest.mark.parametrize("case", ["gemma2-2b_2x2", "gemma2-2b_1x4",
                                  "granite-34b_1x4"])
def test_llm_round_on_mesh_meets_the_round_bounds(ranks, case, oracle):
    """(2, 2) (two rounds, each from the reference's state) and (1, 4)
    against the reference's unsharded jitted round and its GSPMD round
    (``GSPMD_OF``): the losses within ``LOSS_RTOL``, x's
    change and m within ``STATE_L2_RTOL`` in L2, x-hat bit-equal on at
    least ``HIDDEN_EQUAL_FLOOR`` (``test_torch_llm_round.check_rounds``)."""
    arch, _, rounds, _ = R.LLM_CASES[case]
    case_ref = GSPMD_OF[case]
    ref = ranks.llm.ref[arch]
    recs = []
    for r in range(1, rounds + 1):
        if oracle == "unsharded":
            js = ref["states"][r]
            jloss = ref["losses"][r - 1]
        else:
            g = ranks.reference
            js = SimpleNamespace(**{n: g[f"gspmd_{case_ref}_{r}_{n}"]
                                    for n in R.STATE},
                                 t=g[f"gspmd_{case_ref}_{r}_t"])
            jloss = float(g[f"gspmd_{case_ref}_{r}_loss"])
        info = ranks.info["llm"][f"{case}_{r}"]
        recs.append({"x0": LR._flat_bits(ref["states"][r - 1].x),
                     "jstate": js, "t": info["t"],
                     "port": _llm(ranks, case, r)})
        np.testing.assert_allclose(info["loss"], jloss, rtol=LR.LOSS_RTOL)
    LR.check_rounds(recs, f"{case} vs {oracle}")


@pytest.mark.parametrize("case", ["codeqwen1.5-7b_2x2", "qwen3-14b_1x4"])
def test_llm_round_on_mesh_meets_the_bounds_of_the_meshless_round(ranks,
                                                                  case):
    """codeqwen1.5-7b (qkv biases) on (2, 2) and qwen3-14b (qk-norm, 2 KV
    heads on 4 ranks) on (1, 4), one round from the port's seed-0 state,
    against the port's meshless round within the same bounds."""
    arch = R.LLM_CASES[case][0]
    cfg = TC.get_reduced(arch)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        state = TS.init_round_state(cfg, 0, "cpu")
        x0 = state.flat[0].numpy().copy()
        fn = TS.make_qafel_round(cfg, TLConfig(**R.LLM_Q), remat=False)
        state, met = fn(state, R.llm_batch(cfg, 0),
                        torch.from_numpy(R.LLM_WEIGHTS), prng.PRNGKey(0))
    finally:
        torch.set_num_threads(threads)
    js = SimpleNamespace(**{n: f.numpy() for n, f in zip(R.STATE,
                                                          state.flat)},
                         t=state.t)
    info = ranks.info["llm"][f"{case}_1"]
    np.testing.assert_allclose(info["loss"], float(met["loss"]),
                               rtol=LR.LOSS_RTOL)
    LR.check_rounds([{"x0": x0, "jstate": js, "t": info["t"],
                      "port": _llm(ranks, case, 1)}], f"{case} vs meshless")


def test_launcher_takes_the_host_mesh_under_a_group(ranks, tmp_path):
    """``launch.train.run`` under the 4-rank group takes the reference's
    host mesh, (1, 1) on rank 0 (ranks 1-3 outside it return at once),
    and runs the meshless launcher's bits: the losses, x and the
    checkpoint's bytes."""
    from repro_torch.launch import train

    got = ranks.info["llm"]["launcher"]
    assert got["coordinate"] == [0, 0]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = train.run(train.parse_args(R.launcher_argv(tmp_path)))
    finally:
        torch.set_num_threads(threads)
    assert want["mesh"] is None
    assert got["losses"] == want["losses"].tolist()
    assert got["x"] == want["state"].flat[0].view(torch.int32).tolist()
    assert (Path(got["checkpoint"]) / "state.msgpack").read_bytes() == (
        Path(want["checkpoint"]) / "state.msgpack").read_bytes()


def test_llm_round_remat_changes_no_bit(ranks):
    """Remat on a (2, 2) mesh (checkpointing with collectives inside)
    gives the bits of remat off."""
    a = _llm(ranks, "gemma2-2b_2x2_remat", 1)
    b = _llm(ranks, "gemma2-2b_2x2", 1)
    for name in R.STATE:
        assert _same(a[name], b[name]), name
    info = ranks.info["llm"]
    assert info["gemma2-2b_2x2_remat_1"]["loss"] == \
        info["gemma2-2b_2x2_1"]["loss"]


def test_llm_server_half_on_mesh_is_the_meshless_half(ranks):
    """Fed the meshless round's upload messages, the (2, 2) mesh's server
    half (``steps.mesh_server_half``) gives the meshless round's x, x-hat
    and m, its broadcast codes and norms and its taps bit for bit."""
    want = ranks.llm.meshless
    for name in R.STATE + ("packed", "norms", "taps"):
        assert _same(ranks.arrays[f"llm_half_{name}"], want[name]), name


def test_llm_round_on_1x4_holds_no_whole_vector(ranks):
    """On (1, 4), outside its shards, their gradients and the client's
    working copy, rank 0 makes no floating tensor larger than the larger
    of its segment (padded d / 4) and the largest leaf."""
    got = ranks.info["llm"]["largest"]
    print("largest other tensor:", got)
    assert 0 < got["numel"] <= max(got["segment"], got["leaf"]), got
