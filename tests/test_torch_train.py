"""The port's training launcher (repro_torch.launch.train) and its
checkpoint archive (repro_torch.checkpoint) against the JAX package's
(repro/launch/train.py, repro/checkpoint/ckpt.py), on the CPU.

Exact:

* the round keys: ``round_key(seed, step)`` is jax's ``PRNGKey(seed *
  100003 + step)`` at ``--seed`` 0 and 50,000 (where the value passes
  2^32 and jax keeps its low 32 bits);
* the batches of three rounds of the reduced gemma2-2b, from the
  reference's numpy stream;
* the archive: ``state.msgpack``'s bytes equal ``msgpack.packb(payload,
  use_bin_type=True)`` of the reference's payload and the manifests
  match; an archive of either package opens in the other's
  ``load_checkpoint``, f32, bf16 and int32 leaves bit-equal; the port's
  MessagePack subset (``checkpoint.mpack``) packs and reads every size
  class as ``msgpack`` does.

Within the decoder's bounds of ROADMAP queue C (tests/
test_torch_llm_round.py): three rounds of the launcher's loop with the
reference's initial state carried across, against the reference's loop
(``repro/launch/train.py:70-86``, its round jitted): the losses within
``LOSS_RTOL``, x's change within ``STATE_L2_RTOL`` in L2.

And the launcher's command line on the CPU (``--device cpu``): its
progress lines, its checkpoint loading in the reference, its refusals.
"""
import io
import json
import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.checkpoint import load_checkpoint as jload
from repro.checkpoint import save_checkpoint as jsave
from repro.core.qafel import QAFeLConfig as JConfig
from repro.core.staleness import staleness_weight as jweight
from repro.data.synthetic import synthetic_batch_for_config as jbatch
from repro.distributed import steps as JS
from repro_torch import configs as TC
from repro_torch.checkpoint import (latest_step, load_checkpoint,
                                    save_checkpoint)
from repro_torch.checkpoint import mpack
from repro_torch.checkpoint.ckpt import treedef_str
from repro_torch.common.tree import tree_flatten, tree_leaves
from repro_torch.convert import round_state_from_jax
from repro_torch.launch import train


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The module's tests on one torch thread, restored after: the suite
    runs six workers on the CPU's cores, where a pool of threads per
    worker spends its time waiting on the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


LOSS_RTOL = 1e-5       # round losses (the decoder's bound; measured 1e-7)
STATE_L2_RTOL = 5e-3   # x - x_0 after three rounds, L2 relative
ARGV = ["--arch", "gemma2-2b", "--reduced", "--steps", "3", "--seq", "32",
        "--global-batch", "8", "--device", "cpu"]


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.view(torch.int16) if a.dtype == torch.bfloat16 else
                a.view(torch.int32) if a.dtype == torch.float32 else
                a).numpy()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.int16)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(a, b) -> bool:
    a, b = _bits(a), _bits(b)
    return a.shape == b.shape and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# Keys, batches and rounds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 50_000])
def test_round_keys_are_jaxs(seed):
    for step in (0, 1, 2, 7, 12_345):
        want = np.asarray(jax.random.PRNGKey(seed * 100_003 + step))
        got = train.round_key(seed, step).numpy()
        assert np.array_equal(got, want.astype(np.int64)), (seed, step)
    if seed:
        assert seed * 100_003 >= 1 << 32  # the value wraps
    assert np.array_equal(np.asarray(jax.random.PRNGKey(4294967301)),
                          [0, 5])


def _reference_loop(jc, jq, state, *, steps, local, seq, seed):
    """``repro/launch/train.py:70-86`` on one device (its host mesh is
    one CPU device): the jitted round, the batches, the weights, the
    keys. Returns the state, the losses and the batches."""
    round_fn = jax.jit(JS.make_qafel_round(jc, jq, remat=False))
    rng = np.random.default_rng(seed)
    weights = jweight(jnp.zeros((jq.buffer_size,)))
    losses, batches = [], []
    for step in range(steps):
        b = jbatch(jc, rng, jq.buffer_size * jq.local_steps * local, seq)
        batch = {k: jnp.asarray(v).reshape(
            (jq.buffer_size, jq.local_steps, local) + v.shape[1:])
            for k, v in b.items()}
        key = jax.random.PRNGKey(seed * 100_003 + step)
        state, metrics = round_fn(state, batch, weights, key)
        losses.append(float(metrics["loss"]))
        batches.append(jax.device_get(batch))
    return state, losses, batches


@pytest.mark.parametrize("seed", [0, 50_000])
def test_launcher_follows_the_reference_loop(seed):
    """Three rounds of ``train.run`` from the reference's initial state
    (``init_round_state(cfg, PRNGKey(seed))``) against the reference's
    loop: the same batches, the losses and x within the bounds."""
    args = train.parse_args(ARGV + ["--seed", str(seed)])
    jc = JC.get_reduced("gemma2-2b")
    jq = JConfig(client_lr=args.client_lr, server_lr=args.server_lr,
                 server_momentum=0.3, buffer_size=args.buffer_k,
                 local_steps=args.local_steps,
                 client_quantizer=args.client_quantizer,
                 server_quantizer=args.server_quantizer)
    assert train.qafel_config(args) == train.QAFeLConfig(**vars(jq))
    j0 = JS.init_round_state(jc, jax.random.PRNGKey(seed))
    t0 = round_state_from_jax(jax.device_get(j0), device="cpu")
    x0 = np.concatenate([np.asarray(v, np.float32).ravel()
                         for v in jax.tree.leaves(j0.x)])
    local = args.global_batch // (args.buffer_k * args.local_steps)
    js, jl, jb = _reference_loop(jc, jq, j0, steps=args.steps, local=local,
                                 seq=args.seq, seed=seed)
    rng = np.random.default_rng(seed)
    tc, tq = TC.get_reduced("gemma2-2b"), train.qafel_config(args)
    for want in jb:
        got = train.round_batch(tc, tq, rng, local, args.seq, "cpu")
        assert set(got) == set(want)
        assert all(np.array_equal(got[k].numpy(), want[k]) for k in want)
    out = train.run(args, state=t0)
    assert out["state"] is t0 and t0.t == args.steps
    np.testing.assert_allclose(out["losses"].numpy(), jl, rtol=LOSS_RTOL)
    a = np.concatenate([np.asarray(v, np.float32).ravel()
                        for v in jax.tree.leaves(jax.device_get(js).x)]) - x0
    b = torch.cat([v.reshape(-1) for v in tree_leaves(t0.x)]).numpy() - x0
    rel = float(np.linalg.norm(b.astype(np.float64) - a) / np.linalg.norm(a))
    print(f"seed {seed}: losses {out['losses'].tolist()} vs {jl}; x after "
          f"{args.steps} rounds, L2 error {rel:.3e}")
    assert rel <= STATE_L2_RTOL


def test_launcher_command_line_on_cpu(tmp_path, capsys):
    """``main`` with ``--device cpu``: a progress line per round (three
    rounds), the checkpoint of x, which the reference loads bit for
    bit."""
    out = train.main(ARGV + ["--checkpoint-dir", str(tmp_path)])
    text = capsys.readouterr().out.splitlines()
    assert [ln.split()[:2] for ln in text[:3]] == [
        ["round", "0"], ["round", "1"], ["round", "2"]]
    assert text[3] == f"checkpoint: {out['checkpoint']}"
    assert latest_step(str(tmp_path)) == 3
    with open(os.path.join(out["checkpoint"], "manifest.json")) as f:
        assert json.load(f) == {"step": 3, "n_leaves": len(
            tree_leaves(out["state"].x)), "arch": "gemma2-2b"}
    like = JS.init_round_state(JC.get_reduced("gemma2-2b"),
                               jax.random.PRNGKey(1))
    got = jload(str(tmp_path), 3, {"x": like.x})
    for a, b in zip(jax.tree.leaves(got["x"]), tree_leaves(out["state"].x)):
        assert _same(b, np.asarray(a))
    assert out["metrics"]["upload_bytes"] == out["metrics"][
        "broadcast_bytes"] == (4 * 1_313_024 + 32 * 10_258) / 8


def test_launcher_refusals(monkeypatch):
    # every id of the pool runs (the MoE configs since item 14c.4); an
    # unknown one is refused naming the known ones
    with pytest.raises(KeyError, match="qwen3-moe-235b-a22b"):
        train.main(["--arch", "no-such-arch", "--steps", "1", "--device",
                    "cpu"])
    with pytest.raises(ValueError, match="global-batch"):
        train.main(ARGV + ["--global-batch", "3"])
    with pytest.raises(SystemExit):
        train.parse_args(["--steps", "1"])  # --arch is required
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "gemma2-2b", "--reduced", "--steps", "1"])


# ---------------------------------------------------------------------------
# The checkpoint archive
# ---------------------------------------------------------------------------


def _trees():
    """The same tree in both packages: f32, bf16 and int32 leaves,
    nested dicts with keys out of order."""
    rng = np.random.default_rng(7)
    f32 = rng.standard_normal((5, 300)).astype(np.float32)
    b16 = rng.standard_normal(70_001).astype(np.float32)
    i32 = np.arange(-3, 9, dtype=np.int32).reshape(3, 4)
    jt = {"x": {"w": jnp.asarray(f32), "a": {"e": jnp.asarray(b16).astype(
        jnp.bfloat16), "c": jnp.asarray(i32)}}, "s": jnp.zeros((0,))}
    tt = {"x": {"w": torch.from_numpy(f32), "a": {
        "e": torch.from_numpy(b16).to(torch.bfloat16),
        "c": torch.from_numpy(i32)}}, "s": torch.zeros(0)}
    return jt, tt


def test_archive_bytes_are_msgpacks(tmp_path):
    jt, tt = _trees()
    jsave(str(tmp_path / "j"), 12, jt, {"arch": "gemma2-2b"})
    save_checkpoint(str(tmp_path / "t"), 12, tt, {"arch": "gemma2-2b"})
    rel = os.path.join("step_00000012", "state.msgpack")
    want = (tmp_path / "j" / rel).read_bytes()
    got = (tmp_path / "t" / rel).read_bytes()
    assert got == want
    leaves, treedef = jax.tree.flatten(jt)
    payload = {"leaves": [{"dtype": str(np.asarray(x).dtype),
                           "shape": list(x.shape),
                           "data": np.asarray(x).tobytes()}
                          for x in leaves], "treedef": str(treedef)}
    assert got == msgpack.packb(payload, use_bin_type=True)
    assert treedef_str(tree_flatten(tt)[1]) == str(treedef)
    man = os.path.join("step_00000012", "manifest.json")
    assert (tmp_path / "t" / man).read_text() == (
        tmp_path / "j" / man).read_text()
    assert not list((tmp_path / "t").rglob("*.tmp"))


def test_archives_open_both_ways(tmp_path):
    jt, tt = _trees()
    jsave(str(tmp_path / "j"), 3, jt)
    save_checkpoint(str(tmp_path / "t"), 3, tt)
    got_t = load_checkpoint(str(tmp_path / "j"), 3, tt)
    got_j = jload(str(tmp_path / "t"), 3, jt)
    for a, b, c in zip(tree_leaves(got_t), jax.tree.leaves(got_j),
                       tree_leaves(tt)):
        assert a.dtype == c.dtype and _same(a, c)
        assert _same(c, np.asarray(b))
    # shapes and leaf counts are checked; a ``like`` on ``meta`` loads
    # onto the card, which this machine lacks
    meta = {"x": {"w": torch.empty(5, 300, device="meta"), "a": {
        "e": torch.empty(70_001, device="meta"),
        "c": torch.empty(3, 4, device="meta")}}, "s": torch.empty(0)}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            load_checkpoint(str(tmp_path / "j"), 3, meta)
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(str(tmp_path / "j"), 3, dict(tt, s=torch.zeros(2)))
    with pytest.raises(ValueError, match="leaf count"):
        load_checkpoint(str(tmp_path / "j"), 3, {"s": torch.zeros(0)})
    assert latest_step(str(tmp_path / "j")) == 3
    assert latest_step(str(tmp_path / "none")) is None


@pytest.mark.parametrize("n", [0, 15, 16, 31, 32, 255, 256, 65_535, 65_536])
def test_mpack_size_classes_are_msgpacks(n):
    obj = {"s" * max(n % 300, 1): ["t" * n, b"b" * n, n, n * 70_000,
                                   list(range(min(n, 20)))],
           "m": {str(i): i for i in range(min(n, 17))}}
    data = mpack.packb(obj)
    assert data == msgpack.packb(obj, use_bin_type=True)
    assert mpack.unpackb(data) == msgpack.unpackb(data, raw=False)
    assert mpack.unpack(io.BytesIO(data)) == obj


def test_mpack_refuses_what_it_does_not_carry():
    for obj in (-1, 1.5, None, True, {1: 2}):
        with pytest.raises(ValueError):
            mpack.packb(obj)
    for data in (msgpack.packb(-3), msgpack.packb(1.5), b"\xc0", b"\xc4\x05ab"):
        with pytest.raises(ValueError):
            mpack.unpackb(data)
