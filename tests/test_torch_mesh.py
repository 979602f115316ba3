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

import mesh_ranks as R
from repro.core import QAFeL as JQAFeL
from repro.core import QAFeLConfig as JConfig
from repro.core.protocol import CLIENT_UPDATE as J_UPDATE
from repro.core.protocol import decode_message_flat as jdecode
from repro.core.protocol import frame_cohort_messages as jframe
from repro.core.quantizers import make_quantizer as jmake_quantizer
from repro.kernels import ops as jops
from repro.obs import RunTracer as JTracer
from repro.sharding import rules as JR
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


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The 4 ranks' results, and beside them, started at the same time,
    the reference's own sharded flush on 4 virtual devices
    (``_SHARDED_REFERENCE``, its ``XLA_FLAGS`` in its environment only)."""
    out = tmp_path_factory.mktemp("mesh_ranks")
    path = os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")])
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "mesh_ranks.py"), str(out)],
        env=dict(os.environ, PYTHONPATH=path, OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
        subprocess.Popen(
        [sys.executable, "-c", _SHARDED_REFERENCE, str(out / "ref.npz"),
         str(ROOT / "src"), str(ROOT / "tests")],
        env=dict(os.environ, PYTHONPATH=path, JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)]
    errs = [p.communicate(timeout=600)[1] for p in procs]
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-4000:]
    with np.load(out / "ranks.npz") as data:
        arrays = {k: data[k] for k in data.files}
    return SimpleNamespace(arrays=arrays, out=out, info=json.loads(
        (out / "ranks.json").read_text()), reference=dict(np.load(
            out / "ref.npz")))


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
