"""Checkpoints of the port's protocol (repro_torch.core.checkpoint): stop
after any upload and resume bit-identically; archives written by the JAX
package load in the port and the reverse, and both runs continue bit for
bit on the quad task; mismatched layouts, quantizers, capacities,
flat lengths and lowrank archives are refused before anything changes,
and an archive written on a mesh (its vectors at the true length) loads.

Every comparison is exact (``np.array_equal`` on the f32 bit patterns):
x, x-hat, momentum, the TrafficMeter summary and the staleness history.
The uploads are the quad task's (d = 307 over two leaves, K = 3), every
third one from a qsgd2 tier, so a window holds packed codes and the
decoded-tier sum at once."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import QAFeL as JQAFeL
from repro.core import QAFeLConfig as JConfig
from repro.core import load_checkpoint as jload
from repro.core import save_checkpoint as jsave
from repro.core.protocol import CLIENT_UPDATE as J_UPDATE
from repro.core.protocol import frame_cohort_messages as jframe
from repro.core.quantizers import make_quantizer as jmake_quantizer
from repro.kernels import ops as jops
from repro_torch.common import prng
from repro_torch.core import (QAFeL, QAFeLConfig, load_checkpoint,
                              make_quantizer, save_checkpoint)
from repro_torch.core.protocol import CLIENT_UPDATE, frame_cohort_messages
from repro_torch.core.qafel import client_update_flat

W, B = 300, 7  # the two leaves' sizes
TARGETS = np.random.default_rng(0).standard_normal((40, 2, W + B)).astype(
    np.float32) + 3.0


def _cfg(**kw):
    return dict(dict(client_lr=0.1, server_lr=1.2, server_momentum=0.3,
                     buffer_size=3, local_steps=2), **kw)


def _tloss(params, batch, key):
    del key
    t = batch["target"]
    return (torch.sum((params["w"] - t[:W]) ** 2)
            + torch.sum((params["b"] - t[W:]) ** 2))


def _jloss(params, batch, key):
    del key
    t = batch["target"]
    return (jnp.sum((params["w"] - t[:W]) ** 2)
            + jnp.sum((params["b"] - t[W:]) ** 2))


def make_talgo(cq="qsgd4", sq="qsgd4", w=W, **kw):
    return QAFeL(QAFeLConfig(**_cfg(client_quantizer=cq, server_quantizer=sq,
                                    **kw)), _tloss,
                 {"w": torch.zeros(w), "b": torch.ones(B)}, device="cpu")


def make_jalgo(cq="qsgd4", sq="qsgd4", **kw):
    return JQAFeL(JConfig(**_cfg(client_quantizer=cq, server_quantizer=sq,
                                 **kw)), _jloss,
                  {"w": jnp.zeros((W,)), "b": jnp.ones((B,))})


def _tier(i) -> bool:
    return i % 3 == 1


def drive(algo, lo, hi, seed=4):
    """Uploads lo..hi-1 of one key stream into the port's ``algo``."""
    key = prng.PRNGKey(seed)
    q2 = make_quantizer("qsgd2")
    for i in range(hi):
        key, k2, k3 = prng.split(key, 3)
        if i < lo:
            continue
        batches = {"target": torch.from_numpy(TARGETS[i])}
        if _tier(i) and algo.cq.spec.kind == "qsgd":
            st = algo.state
            kt, ke = prng.split(k2)
            out = client_update_flat(
                algo.loss_fn, algo.qcfg, q2.spec, st.layout, st.hidden_flat,
                batches, kt, ke, b=1)
            msg = frame_cohort_messages(CLIENT_UPDATE, q2, out, st.layout,
                                        version=st.t)[0]
        else:
            msg, _ = algo.run_client(batches, k2)
        algo.receive(msg, k3)
    return algo


def jdrive(algo, lo, hi, seed=4):
    """The same uploads into the JAX package's ``algo``."""
    key = jax.random.PRNGKey(seed)
    q2 = jmake_quantizer("qsgd2")
    for i in range(hi):
        key, k2, k3 = jax.random.split(key, 3)
        if i < lo:
            continue
        batches = {"target": jnp.asarray(TARGETS[i])}
        if _tier(i) and algo.cq.spec.kind == "qsgd":
            st = algo.state
            kt, ke = jax.random.split(k2)
            out = jops.cohort_train_encode_step(
                algo.loss_fn, algo.qcfg, q2.spec, st.layout, st.hidden_flat,
                batches, kt, ke, algo._flag, b=1)
            msg = jframe(J_UPDATE, q2, out, st.layout, enc_keys=[ke],
                         version=st.t)[0]
        else:
            msg, _ = algo.run_client(batches, k2)
        algo.receive(msg, k3)
    return algo


def _bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32)


def assert_same_state(a, b):
    for name in ("x_flat", "hidden_flat", "momentum_flat"):
        assert np.array_equal(_bits(getattr(a.state, name)),
                              _bits(getattr(b.state, name))), name
    assert a.state.t == b.state.t
    assert a.meter.summary() == b.meter.summary()
    assert a.staleness.history == b.staleness.history
    assert a.buffer.count == b.buffer.count


@pytest.mark.parametrize("cq,stop", [("qsgd4", n) for n in range(1, 8)]
                         + [("identity", 8)])
def test_resume_continues_bit_identically(tmp_path, cq, stop):
    """Stop after upload ``stop`` (every window position, packed codes and
    the decoded-tier sum in it), resume in a new instance, and continue
    both with the same uploads across several flushes."""
    path = tmp_path / "ckpt.npz"
    algo = drive(make_talgo(cq=cq), 0, stop)
    assert algo.buffer.count == stop % 3
    save_checkpoint(path, algo)
    resumed = load_checkpoint(path, make_talgo(cq=cq))
    assert_same_state(algo, resumed)
    drive(algo, stop, stop + 10)
    drive(resumed, stop, stop + 10)
    assert resumed.state.t >= 3
    assert_same_state(algo, resumed)


def test_reference_archive_continues_in_the_port(tmp_path):
    """Written by the JAX package mid-window (a packed upload and a
    decoded tier upload buffered), loaded by the port; both continue."""
    path = tmp_path / "ref.npz"
    jalgo = jdrive(make_jalgo(), 0, 8)
    assert jalgo.buffer.count == 2 and jalgo.buffer._acc is not None
    jsave(str(path), jalgo)
    talgo = load_checkpoint(path, make_talgo())
    assert_same_state(jalgo, talgo)
    jdrive(jalgo, 8, 20)
    drive(talgo, 8, 20)
    assert talgo.state.t == 6
    assert_same_state(jalgo, talgo)


def test_port_archive_continues_in_the_reference(tmp_path):
    path = tmp_path / "port"  # no extension: both add '.npz'
    talgo = drive(make_talgo(), 0, 5)
    assert talgo.buffer.count == 2 and talgo.buffer._acc is not None
    talgo.save_checkpoint(path)
    jalgo = jload(str(path), make_jalgo())
    assert_same_state(jalgo, talgo)
    jdrive(jalgo, 5, 17)
    drive(talgo, 5, 17)
    assert jalgo.state.t == 5
    assert_same_state(jalgo, talgo)


def test_mismatches_are_refused(tmp_path):
    """Another layout, quantizer, capacity or flat length, or lowrank
    state: refused, and the target keeps its state; an archive whose
    sharding entry says two devices (its vectors canonical) loads."""
    import json
    path = tmp_path / "ckpt.npz"
    save_checkpoint(path, drive(make_talgo(), 0, 4))
    for target, match in ((make_talgo(w=W + 1), "layout"),
                          (make_talgo(cq="qsgd8"), "quantizers"),
                          (make_talgo(sq="identity"), "quantizers"),
                          (make_talgo(buffer_size=4), "capacity")):
        before = target.state.x_flat.clone()
        with pytest.raises(ValueError, match=match):
            load_checkpoint(path, target)
        assert torch.equal(target.state.x_flat, before)
        assert target.state.t == 0 and target.buffer.count == 0

    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    meta = json.loads(bytes(arrays.pop("__meta__")).decode("utf-8"))

    def rewrite(name, **changes):
        out = tmp_path / name
        np.savez(out, __meta__=np.frombuffer(json.dumps(
            dict(meta, **changes)).encode("utf-8"), dtype=np.uint8), **arrays)
        return out

    n = W + B
    sharded = rewrite("sharded.npz", sharding={
        "devices": 2, "axes": ["data"], "mesh_shape": [2], "n": n,
        "n_padded": 512})
    loaded = load_checkpoint(sharded, make_talgo())
    assert loaded.state.t == 1 and np.array_equal(
        loaded.state.x_flat.numpy(), arrays["x_flat"])
    longer = rewrite("longer.npz", sharding={
        "devices": 2, "axes": ["data"], "mesh_shape": [2], "n": n + 1,
        "n_padded": 512})
    with pytest.raises(ValueError, match="coordinate count"):
        load_checkpoint(longer, make_talgo())
    single = rewrite("single.npz", sharding={
        "devices": 1, "axes": None, "mesh_shape": None, "n": n,
        "n_padded": n})
    assert load_checkpoint(single, make_talgo()).state.t == 1
    lowrank = rewrite("lowrank.npz", basis_seed=7)
    with pytest.raises(ValueError, match="lowrank"):
        load_checkpoint(lowrank, make_talgo())
