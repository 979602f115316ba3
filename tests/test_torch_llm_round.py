"""The port's QAFeL round on the dense decoder (repro_torch.distributed
.steps, core.qafel's bf16 local SGD, convert) against the JAX package's,
on the CPU, at ``get_reduced("gemma2-2b")``; the example
``repro_torch.examples.federated_llm`` on the CPU.

Bit for bit (``np.array_equal`` on the bit patterns):

* local SGD on a tree with bf16 and f32 leaves, against the reference's
  jitted ``local_sgd_scan``, on a loss whose gradients both packages
  compute exactly: XLA:CPU keeps both of the step's bf16 roundings
  (``bf16(y - bf16(g * bf16(lr)))``; read from its optimised program) and
  fuses the f32 step into one multiply-add;
* the server half of the round: the same K packed client messages and
  weights into the reference's own functions under ``jax.jit``, mirroring
  ``repro/distributed/steps.py:165-199``, and into the port's
  ``accumulate`` (the round's own decode and weighted add) and
  ``server_half``: equal x, x-hat, m and broadcast codes and norms, with
  f32 and with bf16 leaves;
* the bytes of one upload and of one broadcast, against the reference's
  metering (``payload_wire_bytes``).

Within a tolerance, the model math differing in its last bits (tests/
test_torch_transformer.py): two rounds of the reference's jitted round
(compiled once) and of the port's on the same batches, keys and unequal
staleness weights, compared one round at a time from equal inputs: round
1 from the reference's initial state, round 2 of the port from the
reference's round-1 state, copied into the port's own state tensors in
place (``load_state_``). After each round the losses within
``LOSS_RTOL``; x's change over the round and the momentum within
``STATE_L2_RTOL`` in L2; the share of x-hat's coordinates equal bit for
bit is printed (``-s``) and held above ``HIDDEN_EQUAL_FLOOR`` (a
coordinate differs where the clients' near-equal deltas quantize to other
codes). The chained comparison it replaces, each side's round 2 from its
own round-1 state, measured how two rounds amplify last-bit noise, not
the port: the reference against itself, from a state one ulp off on 1%
of the coordinates, kept 74.2% of qwen3-moe's x-hat after round 2, and
taking XLA's ``exp`` in the loss moved qwen3-moe's chained share from
88.4% to 74.5% and mamba2-1.3b's (f32) from 93.2% to 87.0%, under their
floors, while each round alone held 97.9% and 98.6%.
A bf16 reduced config's two local steps:
the losses within ``BF16_SGD_LOSS_ATOL``, the deltas on the coordinates
the reference moved against floors that the same run with y kept in f32
misses.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.core.protocol import payload_wire_bytes as jwire_bytes
from repro.core.qafel import QAFeLConfig as JConfig
from repro.core.qafel import local_sgd_scan as jlocal_sgd
from repro.core.qafel import server_apply_flat as jserver_apply
from repro.core.quantizers import flatten_tree as jflatten
from repro.core.quantizers import qsgd_encode_flat2d
from repro.distributed import steps as JS
from repro.kernels import ops as jops
from repro.models import transformer as JT
from repro_torch import configs as TC
from repro_torch.common import prng
from repro_torch.common.tree import tree_leaves
from repro_torch.convert import params_from_jax, round_state_from_jax
from repro_torch.core.qafel import QAFeLConfig, client_update_flat, local_sgd
from repro_torch.core.quantizers import (TreeLayout, flatten_tree,
                                         make_quantizer)
from repro_torch.distributed import steps as TS
from repro_torch.examples import federated_llm
from repro_torch.launch.train import round_batch
from repro_torch.kernels import ops as tops

LOSS_RTOL = 1e-5            # round losses (measured 2.9e-7)
HIDDEN_EQUAL_FLOOR = 0.95   # share of x-hat bit-equal after each round
STATE_L2_RTOL = 5e-3        # x's change over a round and m, L2 relative
# bf16 local SGD at the reduced gemma2-2b (measured; the control is the
# same run with y kept in f32)
BF16_SGD_LOSS_ATOL = 1e-3      # step losses near 6.2 (measured 3.8e-4)
BF16_DELTA_EQUAL_FLOOR = 0.9   # moved deltas equal (0.9446; control 0.0011)
BF16_DELTA_L1 = 2e-2           # their relative L1 error (9.9e-3; 0.176)
BF16_ONE_SIDED_SHARE = 1e-2    # coordinates moved by one side (3.7e-3)
QCFG = dict(client_lr=3e-2, server_lr=1.0, server_momentum=0.3,
            buffer_size=4, local_steps=2, client_quantizer="qsgd4",
            server_quantizer="qsgd4")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The module's tests on one torch thread, restored after: the suite
    runs six workers on the CPU's cores, where a pool of threads per
    worker spends its time waiting on the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bits(a) -> np.ndarray:
    a = a.detach().cpu() if isinstance(a, torch.Tensor) else a
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        a = a.numpy()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.int16)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(a, b) -> bool:
    a, b = _bits(a), _bits(b)
    return a.shape == b.shape and np.array_equal(a, b)


def _flat_bits(tree) -> np.ndarray:
    """A tree's leaves (either package) as one f32 vector."""
    leaves = (tree_leaves(tree) if isinstance(tree, dict) and any(
        isinstance(v, (dict, torch.Tensor)) for v in tree.values())
        else jax.tree.leaves(tree))
    return np.concatenate([
        (l.detach().to(torch.float32).numpy() if isinstance(l, torch.Tensor)
         else np.asarray(l, np.float32)).ravel() for l in leaves])


# ---------------------------------------------------------------------------
# bf16 local SGD
# ---------------------------------------------------------------------------


def _linear_loss_jax(p, batch, key):
    del key
    return (jnp.sum(p["w"].astype(jnp.float32) * batch["c"])
            + jnp.sum(p["v"] * batch["c"][:64]))


def _linear_loss_torch(p, batch, key):
    del key
    return (torch.sum(p["w"].to(torch.float32) * batch["c"])
            + torch.sum(p["v"] * batch["c"][:64]))


def test_bf16_local_sgd_rounds_as_the_reference():
    """Exact gradients (bf16-representable constants) isolate the step's
    rounding: every coordinate of both leaves equal after 3 steps."""
    rng = np.random.default_rng(0)
    c = rng.standard_normal((3, 300)).astype(np.float32)
    c = np.array(jnp.asarray(c, jnp.bfloat16).astype(jnp.float32))
    jp = {"w": jnp.asarray(rng.standard_normal(300), jnp.bfloat16),
          "v": jnp.asarray(rng.standard_normal(64), jnp.float32)}
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    want = jax.jit(lambda p, b, k: jlocal_sgd(_linear_loss_jax, 3e-2, p, b,
                                              k)[0])(jp, {"c": c}, keys)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    y0, layout = flatten_tree(tp)
    assert layout.dtypes == ("float32", "bfloat16")
    got = local_sgd(_linear_loss_torch, 3e-2, layout, y0,
                    {"c": torch.from_numpy(c)},
                    prng.split(prng.PRNGKey(0), 3))
    assert got["w"].dtype == torch.bfloat16
    assert _same(got["w"], want["w"]) and _same(got["v"], want["v"])
    # a separately rounded bf16 step (no product rounding) would differ
    assert not _same((tp["w"].float() - 3 * 3e-2 * torch.from_numpy(
        c.sum(0))).to(torch.bfloat16), want["w"])


def test_f32_local_sgd_keeps_its_fused_step():
    """An all-f32 tree takes the one fused multiply-add per step, as
    before: bit for bit with the reference's jitted scan."""
    rng = np.random.default_rng(1)
    c = rng.standard_normal((2, 300)).astype(np.float32)
    jp = {"w": jnp.asarray(rng.standard_normal(300), jnp.float32),
          "v": jnp.asarray(rng.standard_normal(64), jnp.float32)}
    keys = jax.random.split(jax.random.PRNGKey(1), 2)
    want = jax.jit(lambda p, b, k: jlocal_sgd(_linear_loss_jax, 0.37, p, b,
                                              k)[0])(jp, {"c": c}, keys)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    y0, layout = flatten_tree(tp)
    got = local_sgd(_linear_loss_torch, 0.37, layout, y0,
                    {"c": torch.from_numpy(c)},
                    prng.split(prng.PRNGKey(1), 2))
    assert _same(got["w"], want["w"]) and _same(got["v"], want["v"])


def test_bf16_reduced_config_local_sgd_near_reference():
    """gemma2-2b reduced with bf16 parameters and activations: two local
    steps from the same weights and tokens against the reference's jitted
    scan. The steps' losses within ``BF16_SGD_LOSS_ATOL``; the deltas
    ``y_P - y_0`` on the coordinates the reference moved: the same
    coordinates move, equal bit for bit on at least
    ``BF16_DELTA_EQUAL_FLOOR`` of them and within ``BF16_DELTA_L1`` in
    L1 (the gradients differ in bf16's last bits between the packages).
    The control, local SGD that keeps y in f32 (no rounding to the
    leaves' dtype), misses the floor."""
    jc = JC.get_reduced("gemma2-2b").replace(param_dtype="bfloat16",
                                              dtype="bfloat16")
    tc = TC.get_reduced("gemma2-2b").replace(param_dtype="bfloat16",
                                              dtype="bfloat16")
    jp = JT.init_params(jc, jax.random.PRNGKey(2))
    from repro_torch.data.synthetic import synthetic_lm_batch
    raw = synthetic_lm_batch(np.random.default_rng(2), 2 * 2, 16, jc.vocab)
    jb = {k: jnp.asarray(v.reshape((2, 2) + v.shape[1:]))
          for k, v in raw.items()}
    keys = jax.random.split(jax.random.PRNGKey(3), 2)
    jloss = lambda p, b, k: JT.loss_fn(jc, p, b, remat=False)[0]
    want, jl = jax.jit(lambda p, b, k: jlocal_sgd(jloss, 3e-2, p, b, k,
                                                  with_loss=True))(
        jp, jb, keys)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    y0, layout = flatten_tree(tp)
    from repro_torch.models import transformer as TT
    tloss = lambda p, b, k: TT.loss_fn(tc, p, b, remat=False)[0]
    tb = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    got, tl = local_sgd(tloss, 3e-2, layout, y0, tb,
                        prng.split(prng.PRNGKey(3), 2), with_loss=True)
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(got))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl, np.float32),
                               rtol=0, atol=BF16_SGD_LOSS_ATOL)
    w0 = _flat_bits(jp)

    def delta_stats(tree):
        """(share of the reference's moved coordinates equal, L1 error
        over them relative to the reference's, share of all coordinates
        moved by one side only, share moved by the reference)."""
        dw, dg = _flat_bits(want) - w0, _flat_bits(tree) - w0
        moved = dw != 0
        l1 = float(np.abs(dg[moved] - dw[moved]).sum()
                   / np.abs(dw[moved]).sum())
        return (float(np.mean(dg[moved] == dw[moved])), l1,
                float(np.mean(moved != (dg != 0))), float(np.mean(moved)))

    share, l1, one_sided, moved = delta_stats(got)
    # the control: y in f32 through the same bf16 forward
    y32 = local_sgd(lambda p, b, k: tloss(_to_bf16(p), b, k), 3e-2,
                    TreeLayout.of(_to_f32(tp)), y0.float(), tb,
                    prng.split(prng.PRNGKey(3), 2))
    c_share, c_l1, _, _ = delta_stats(y32)
    print(f"bf16 local SGD: {moved:.4f} of coordinates moved; on them "
          f"{share:.4f} equal, L1 {l1:.3e}, {one_sided:.4f} moved by one "
          f"side only; f32-y control {c_share:.4f} equal, L1 {c_l1:.3e}")
    assert share >= BF16_DELTA_EQUAL_FLOOR and l1 <= BF16_DELTA_L1
    assert one_sided <= BF16_ONE_SIDED_SHARE
    assert c_share < BF16_DELTA_EQUAL_FLOOR and c_l1 > BF16_DELTA_L1


def _to_f32(tree):
    from repro_torch.common.tree import tree_map
    return tree_map(lambda t: t.to(torch.float32), tree)


def _to_bf16(tree):
    from repro_torch.common.tree import tree_map
    return tree_map(lambda t: t.to(torch.bfloat16), tree)


# ---------------------------------------------------------------------------
# The server half, bit for bit
# ---------------------------------------------------------------------------


def _half_inputs(dtype, k=4, bits=4):
    """x, x-hat, m trees (reduced gemma shapes, ``dtype`` leaves) and K
    packed client messages with their weights."""
    jc = JC.get_reduced("gemma2-2b").replace(param_dtype=dtype, dtype=dtype)
    rng = np.random.default_rng(5)
    jp = JT.init_params(jc, jax.random.PRNGKey(5))
    noise = lambda a, s: (a.astype(jnp.float32) + jnp.asarray(
        s * rng.standard_normal(a.shape), jnp.float32)).astype(a.dtype)
    x = jax.tree.map(lambda a: noise(a, 0.01), jp)
    hidden = jax.tree.map(lambda a: noise(a, 0.002), x)
    m = jax.tree.map(lambda a: noise(jnp.zeros_like(a), 0.001), jp)
    d = sum(a.size for a in jax.tree.leaves(jp))
    deltas = (0.003 * rng.standard_normal((k, d))).astype(np.float32)
    seeds = torch.from_numpy(rng.integers(0, 2 ** 32, (k, 2)))
    packed, norms = tops.qsgd_quantize_batch(torch.from_numpy(deltas),
                                             seeds, bits)
    w = rng.uniform(0.4, 1.0, k).astype(np.float32)
    return x, hidden, m, packed, norms, w, d


def _reference_half(x, hidden, m, packed, norms, w, kser, *, d, bits, qcfg):
    """``repro/distributed/steps.py:165-199`` from the packed client
    messages on: the scan's decode and weighted add, delta_bar, the server
    update, the threefry broadcast encode and decode, x-hat + q, the
    unflatten to the leaves' dtypes."""
    hf, layout = jflatten(hidden)
    xf, _ = jflatten(x)
    mf, _ = jflatten(m)

    def body(buf, inp):
        p, n, wk = inp
        return buf + wk * jops.qsgd_dequantize(p, n, bits, d), None

    buf, _ = jax.lax.scan(body, jnp.zeros((d,), jnp.float32),
                          (packed, norms, w))
    delta_bar = buf * (1.0 / qcfg.buffer_size)
    x_new, m_new = jserver_apply(xf, mf, delta_bar, lr=qcfg.server_lr,
                                 beta=qcfg.server_momentum)
    diff = x_new - hf
    bp, bn = qsgd_encode_flat2d(diff[None], kser, bits, threefry=True)
    q = jops.qsgd_dequantize(bp[0], bn[0], bits, d)
    return (layout.unflatten(x_new), layout.unflatten(hf + q),
            layout.unflatten(m_new), bp[0], bn[0])


@pytest.mark.parametrize("dtype,chunk_rows", [
    ("float32", None), ("float32", 1000), ("bfloat16", None),
    ("bfloat16", 4099)])
def test_server_half_bit_for_bit(dtype, chunk_rows):
    """The port's ``accumulate`` and ``server_half`` on the round's flat
    state (``RoundState.from_trees``: one buffer each in the leaves' dtype,
    updated in place), the broadcast encoded ``chunk_rows`` rows at a time,
    against the reference's jitted server half run unchunked (its chunked
    threefry encode is no oracle on this jax, ROADMAP queue C)."""
    bits = 4
    x, hidden, m, packed, norms, w, d = _half_inputs(dtype, bits=bits)
    jq = JConfig(**QCFG)
    want = jax.jit(lambda *a: _reference_half(*a, d=d, bits=bits, qcfg=jq))(
        x, hidden, m, jnp.asarray(packed.numpy()), jnp.asarray(norms.numpy()),
        jnp.asarray(w), jax.random.PRNGKey(9))
    state = TS.RoundState.from_trees(
        *(params_from_jax(jax.tree.map(np.asarray, t), device="cpu")
          for t in (x, hidden, m)))
    assert state.flat[0].dtype == getattr(torch, dtype)
    buf = torch.zeros(d)
    for k in range(packed.shape[0]):
        TS.accumulate(buf, packed[k], norms[k], torch.from_numpy(w[k:k + 1]),
                      bits=bits, d=d)
    bp, bn = TS.server_half(*state.flat, buf, prng.PRNGKey(9),
                            qcfg=QAFeLConfig(**QCFG), d=d,
                            chunk_rows=chunk_rows)
    assert _same(bp, want[3]) and _same(bn, want[4])
    for got, ref_tree in ((state.x, want[0]), (state.hidden, want[1]),
                          (state.momentum, want[2])):
        for a, b in zip(tree_leaves(got), jax.tree.leaves(ref_tree)):
            assert str(a.dtype).endswith(dtype) and _same(a, b)


def test_wire_bytes_match_reference_metering():
    """One upload and one broadcast of the reduced model at qsgd4, from
    the round's own messages."""
    d = 1_313_024  # the reduced model's leaves (param_count() omits norms)
    rows = -(-d // 128)
    want = jwire_bytes({"format": "packed", "kind": "qsgd", "bits": 4,
                        "n": d})
    assert want == (4 * d + 32 * rows) / 8
    out = _rounds()
    assert out["port_metrics"][0]["upload_bytes"] == want
    assert out["port_metrics"][0]["broadcast_bytes"] == want


# ---------------------------------------------------------------------------
# Two whole rounds
# ---------------------------------------------------------------------------

_CACHE = {}


def load_state_(tstate, jstate) -> None:
    """The reference's round state (numpy trees) copied into the port's
    ``RoundState`` in place: its flat buffers, its side leaves and ``t``."""
    src = round_state_from_jax(jstate, device="cpu")
    with torch.no_grad():
        for f, g in zip(tstate.flat, src.flat):
            f.copy_(g)
        for name in ("x", "hidden", "momentum"):
            for a, b in zip(tree_leaves(getattr(tstate, name)),
                            tree_leaves(getattr(src, name))):
                a.copy_(b)
    tstate.t = src.t


def compare_rounds(jround, tround, jstate, tstate, batch_pair, weights,
                   rounds: int = 2, control_key=None) -> list:
    """``rounds`` rounds of the reference's jitted round and of the port's,
    one at a time from equal inputs: round r of both from the reference's
    state after round r - 1 (the port's loaded in place, ``load_state_``).
    ``batch_pair(step) -> (reference batch, port batch)``. Returns one
    record a round: the reference's x before it (``x0``), its state after
    it (``jstate``), the port's x, x-hat and m after it as f32 vectors
    (``port``), both losses, the port's metrics and whether the round
    returned the state it was given (``same_obj``); with ``control_key``,
    from round 2 on, the reference's round on that key (``control``)."""
    recs = []
    jstate = jax.device_get(jstate)
    for step in range(rounds):
        jb, tb = batch_pair(step)
        if step:
            load_state_(tstate, jstate)
        rec = {"x0": _flat_bits(jstate.x)}
        if control_key is not None and step:
            rec["control"] = jax.device_get(jround(
                jstate, jb, jnp.asarray(weights),
                jax.random.PRNGKey(control_key))[0])
        jstate, jmet = jround(jstate, jb, jnp.asarray(weights),
                              jax.random.PRNGKey(step))
        jstate = jax.device_get(jstate)
        new, tmet = tround(tstate, tb, torch.from_numpy(weights),
                           prng.PRNGKey(step))
        rec.update(jstate=jstate, jloss=float(jmet["loss"]),
                   tloss=float(tmet["loss"]), port_metrics=tmet,
                   same_obj=new is tstate, t=new.t,
                   port={n: _flat_bits(getattr(new, n))
                         for n in ("x", "hidden", "momentum")})
        tstate = new
        recs.append(rec)
    return recs


def round_figures(rec, other=None) -> dict:
    """One round's figures: the share of x-hat bit-equal to the
    reference's, and x's change over the round and the momentum as L2
    errors relative to the reference's; ``other`` (a state's trees) in the
    port's place, e.g. the control."""
    js = rec["jstate"]
    got = rec["port"] if other is None else {
        n: _flat_bits(getattr(other, n)) for n in ("x", "hidden",
                                                    "momentum")}
    jh = _flat_bits(js.hidden)
    out = {"hidden": float(np.mean(jh.view(np.int32)
                                   == got["hidden"].view(np.int32)))}
    for name, base in (("x", rec["x0"]), ("momentum", 0.0)):
        a = _flat_bits(getattr(js, name)) - base
        b = got[name] - base
        out[name] = float(np.linalg.norm(b.astype(np.float64) - a)
                          / np.linalg.norm(a))
    return out


def check_rounds(recs, tag: str, floor: float = HIDDEN_EQUAL_FLOOR,
                 bound: float = STATE_L2_RTOL) -> None:
    """Each round's x-hat share at least ``floor``, x's change and m
    within ``bound``; the figures printed (``-s``)."""
    for r, rec in enumerate(recs, 1):
        f = round_figures(rec)
        print(f"{tag} round {r}: x-hat bit-equal {f['hidden']:.6f}, x "
              f"{f['x']:.3e}, m {f['momentum']:.3e} (L2)")
        assert rec["t"] == int(rec["jstate"].t) == r
        assert f["hidden"] >= floor, (r, f)
        assert f["x"] <= bound and f["momentum"] <= bound, (r, f)


def _rounds():
    """Two rounds of the reference's jitted round (one compile) and of the
    port's, one at a time from equal inputs (``compare_rounds``); cached
    for the module."""
    if _CACHE:
        return _CACHE
    jc, tc = JC.get_reduced("gemma2-2b"), TC.get_reduced("gemma2-2b")
    jq, tq = JConfig(**QCFG), QAFeLConfig(**QCFG)
    jround = jax.jit(JS.make_qafel_round(jc, jq, remat=False))
    tround = TS.make_qafel_round(tc, tq)
    jstate = JS.init_round_state(jc, jax.random.PRNGKey(0))
    tstate = round_state_from_jax(jax.device_get(jstate), device="cpu")
    weights = np.array([0.9, 1.0, 0.7, 0.5], np.float32)
    rng_j, rng_t = np.random.default_rng(0), np.random.default_rng(0)
    from repro.data.synthetic import synthetic_batch_for_config as jbatch

    def batch_pair(step):
        raw = jbatch(jc, rng_j, 4 * 2 * 2, 64)
        jb = {k: jnp.asarray(v).reshape((4, 2, 2) + v.shape[1:])
              for k, v in raw.items()}
        tb = round_batch(tc, tq, rng_t, federated_llm.LOCAL_BATCH, 64,
                         "cpu")
        assert all(np.array_equal(tb[k].numpy(), np.asarray(jb[k]))
                   for k in jb)
        return jb, tb

    recs = compare_rounds(jround, tround, jstate, tstate, batch_pair,
                          weights)
    _CACHE.update(rounds=recs, tstate=tstate,
                  port_metrics=[r["port_metrics"] for r in recs])
    return _CACHE


def test_two_rounds_match_reference():
    out = _rounds()
    recs = out["rounds"]
    np.testing.assert_allclose([r["tloss"] for r in recs],
                               [r["jloss"] for r in recs], rtol=LOSS_RTOL)
    check_rounds(recs, "gemma2-2b")
    assert TreeLayout.of(out["tstate"].hidden) == TreeLayout.of(
        params_from_jax(recs[-1]["jstate"].hidden, device="cpu"))


def test_round_refuses_what_it_does_not_port():
    cfg, q = TC.get_reduced("gemma2-2b"), QAFeLConfig(**QCFG)
    with pytest.raises(NotImplementedError, match="14d"):
        TS.make_qafel_round(cfg, q, pod_quantized=True)
    with pytest.raises(ValueError, match="chunk_rows"):
        TS.make_qafel_round(cfg, q, chunk_rows=0)
    # remat, chunk_rows, the taps (tests/test_torch_round_taps.py), every
    # quantizer kind (tests/test_torch_round_quantizers.py) and the
    # serving steps (tests/test_torch_serve.py) are ported: no refusal
    TS.make_qafel_round(cfg, q, remat=True, chunk_rows=8, taps=True)
    for kind in ("identity", "top_k0.1", "rand_k0.1", "lowrank4g32"):
        TS.make_qafel_round(cfg, QAFeLConfig(client_quantizer=kind,
                                             server_quantizer=kind))
    TS.make_prefill_step(cfg)
    TS.make_decode_step(cfg)
    # on a model-parallel mesh the dense decoders run
    # (tests/test_torch_mesh.py); the other families, the other quantizers
    # (13b.2) and a "pod" axis (14d) stay refused
    from types import SimpleNamespace
    mesh = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(1, 1))
    for arch, what in (("deepseek-v3-671b", "MLA"),
                       ("qwen3-moe-235b-a22b", "MoE"),
                       ("mamba2-1.3b", "Mamba2"), ("zamba2-7b", "hybrid"),
                       ("internvl2-1b", "VLM"), ("musicgen-large", "audio")):
        with pytest.raises(NotImplementedError, match=f"{what}.*13b.2"):
            TS.make_qafel_round(TC.get_reduced(arch), q, mesh=mesh)
    with pytest.raises(NotImplementedError, match="MoE.*ep.*13b.2"):
        TS.make_qafel_round(TC.get_reduced("qwen3-moe-235b-a22b").replace(
            moe_impl="ep"), q, mesh=mesh)
    with pytest.raises(NotImplementedError, match="top_k0.1.*13b.2"):
        TS.make_qafel_round(cfg, QAFeLConfig(server_quantizer="top_k0.1"),
                            mesh=mesh)
    with pytest.raises(NotImplementedError, match="14d"):
        TS.make_qafel_round(cfg, q, mesh=SimpleNamespace(
            mesh_dim_names=("pod", "data", "model"), shape=(1, 1, 1)))
    # remat under the vmapped cohort step stays refused
    flat, layout = flatten_tree({"w": torch.zeros(8)})
    with pytest.raises(NotImplementedError, match="13b"):
        client_update_flat(lambda p, b, k: p["w"].sum(), q,
                           make_quantizer("qsgd4").spec, layout, flat,
                           {"t": torch.zeros(2, 2, 1)}, None, None, b=2,
                           remat=True)


def test_federated_llm_example_runs_on_cpu(capsys):
    out = federated_llm.main(["--device", "cpu", "--rounds", "2"])
    assert len(out) == 2 and all(np.isfinite(v) for r in out for v in r)
    assert out[1][1] > 0.0  # x and x-hat drift apart and are reported
    text = capsys.readouterr().out
    assert "round 1: loss=" in text and "params=1,313,024" in text


def test_federated_llm_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        federated_llm.main(["--rounds", "1"])


# ---------------------------------------------------------------------------
# The full-depth levers: chunk_rows, remat, the in-place state
# ---------------------------------------------------------------------------

def _tiny_cfg():
    """gemma2-2b's reduced config narrowed further (d = 5,792, 46 rows with
    a ragged last one) so a round at one row per chunk stays quick."""
    return TC.get_reduced("gemma2-2b").replace(
        d_model=16, vocab=64, n_heads=2, n_kv_heads=1, head_dim=8, d_ff=32,
        sliding_window=8)


_TINY = {}


def _tiny_rounds(chunk_rows, remat, dtype="float32"):
    """Two rounds of the tiny config from one seeded state, with every
    message the rounds made (``on_message``); cached."""
    key = (chunk_rows, remat, dtype)
    if key not in _TINY:
        cfg = _tiny_cfg().replace(param_dtype=dtype, dtype=dtype)
        qcfg = QAFeLConfig(**QCFG)
        state = TS.init_round_state(cfg, 3, "cpu")
        msgs = []
        rf = TS.make_qafel_round(
            cfg, qcfg, remat=remat, chunk_rows=chunk_rows,
            on_message=lambda kind, i, p, nm: msgs.append(
                (kind, i, p.clone(), nm.clone())))
        rng = np.random.default_rng(1)
        mets = []
        for step in range(2):
            batch = round_batch(cfg, qcfg, rng, federated_llm.LOCAL_BATCH,
                                16, "cpu")
            state, met = rf(state, batch, torch.tensor([0.9, 1, 0.7, 0.5]),
                            prng.PRNGKey(step))
            mets.append(met)
        _TINY[key] = (state, mets, msgs)
    return _TINY[key]


@pytest.mark.parametrize("chunk_rows,remat,dtype", [
    (1, False, "float32"), (3, True, "float32"), (5, False, "float32"),
    (None, True, "float32"), (3, True, "bfloat16"),
    (None, True, "bfloat16")])
def test_round_chunk_rows_and_remat_change_no_bit(chunk_rows, remat, dtype):
    """The round at ``chunk_rows`` 1, 3 and 5 and with ``remat`` equals
    the round at ``chunk_rows=None`` without remat: x, x-hat, m, the
    losses, the metered bytes and every upload's and broadcast's codes
    and norms, bit for bit, in f32 and bf16."""
    base, bmets, bmsgs = _tiny_rounds(None, False, dtype)
    st, mets, msgs = _tiny_rounds(chunk_rows, remat, dtype)
    assert [m[:2] for m in msgs] == [m[:2] for m in bmsgs] == 2 * (
        [("upload", k) for k in range(4)] + [("broadcast", 4)])
    for m, bm in zip(msgs, bmsgs):
        assert _same(m[2], bm[2]) and _same(m[3], bm[3])
    assert st.t == base.t == 2
    assert st.flat[0].dtype == getattr(torch, dtype)
    for a, b in zip(st.flat, base.flat):
        assert _same(a, b)
    for m, bm in zip(mets, bmets):
        assert _same(m["loss"], bm["loss"])
        assert m["upload_bytes"] == bm["upload_bytes"]
        assert m["broadcast_bytes"] == bm["broadcast_bytes"]


def test_round_updates_the_state_in_place():
    """The round returns its own state, t + 1, its trees still views of
    the flat buffers; a state cloned before the round is untouched."""
    cfg = _tiny_cfg()
    qcfg = QAFeLConfig(**QCFG)
    state = TS.init_round_state(cfg, 3, "cpu")
    before = state.clone()
    ptrs = [f.data_ptr() for f in state.flat]
    rf = TS.make_qafel_round(cfg, qcfg, chunk_rows=7)
    batch = round_batch(cfg, qcfg, np.random.default_rng(1),
                        federated_llm.LOCAL_BATCH, 16, "cpu")
    out, _ = rf(state, batch, torch.ones(4), prng.PRNGKey(0))
    assert out is state and state.t == 1 and before.t == 0
    assert [f.data_ptr() for f in state.flat] == ptrs
    for tree, flat in zip((state.x, state.hidden, state.momentum),
                          state.flat):
        lo, hi = flat.data_ptr(), flat.data_ptr() + 4 * flat.numel()
        assert all(lo <= t.data_ptr() < hi for t in tree_leaves(tree))
    assert not torch.equal(state.flat[0], before.flat[0])
    fresh = TS.init_round_state(cfg, 3, "cpu")
    for a, b in zip(before.flat, fresh.flat):
        assert _same(a, b)


def test_mixed_dtype_round_keeps_a_new_state():
    """A tree of two dtypes (here the final norm in bf16 in an f32 model)
    is kept in place too: its f32 leaves view one f32 buffer each, the
    bf16 final norm is a tensor of its own beside them, which its slots
    shadow; the round updates that state and returns it, and a clone
    taken before the round keeps the old state as it was."""
    cfg = _tiny_cfg()
    qcfg = QAFeLConfig(**QCFG)
    base = TS.init_round_state(cfg, 3, "cpu")
    mixed = TS.RoundState.from_trees(
        *(dict(tr, final_norm=tr["final_norm"].to(torch.bfloat16))
          for tr in (base.x, base.hidden, base.momentum)))
    assert mixed.flat is not None and mixed.flat[0].dtype == torch.float32
    kept = mixed.clone()
    rf = TS.make_qafel_round(cfg, qcfg, remat=False)
    batch = round_batch(cfg, qcfg, np.random.default_rng(1),
                        federated_llm.LOCAL_BATCH, 16, "cpu")
    new, met = rf(mixed, batch, torch.ones(4), prng.PRNGKey(0))
    assert new is mixed and new.t == 1 and kept.t == 0
    assert new.x["final_norm"].dtype == torch.bfloat16
    assert torch.isfinite(met["loss"])
    assert torch.equal(kept.x["embed"], base.x["embed"])
    assert not torch.equal(new.x["embed"], base.x["embed"])
    assert not torch.equal(new.x["final_norm"], kept.x["final_norm"])


@pytest.mark.parametrize("dtype,beta,lr", [
    ("float32", 0.3, 1.0), ("float32", None, 1.0), ("float32", 0.3, 0.7),
    ("bfloat16", 0.3, 1.0), ("bfloat16", 0.9, 1.3)])
def test_plain_server_update_is_the_old_op_sequence(dtype, beta, lr):
    """``kernels.server_update.server_update_`` on CPU tensors (its plain
    version, ``ref.server_update_``) against the round's earlier server
    half: ``buf * fl32(1/K)``, the float64-exact ``ref.fma_f32`` for the
    momentum and a server lr other than 1, ``m_new + x`` for lr 1, the
    diff, and the unflatten's rounding; bit for bit, chunk edges
    included."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.server_update import server_update_

    n, k = 5000, 4
    rng = np.random.default_rng(7)
    t = lambda s: torch.from_numpy(
        (s * rng.standard_normal(n)).astype(np.float32))
    dt = getattr(torch, dtype)
    buf, m, x = t(1e-2), t(1e-3).to(dt), t(1.0).to(dt)
    xhat = (x.float() + t(1e-3)).to(dt)
    f32 = lambda v: float(np.float32(v))
    m_new = buf * f32(1.0 / k)
    if beta:
        m_new = ref.fma_f32(m.float(), f32(beta), m_new)
    x_new = (m_new + x.float() if lr == 1.0
             else ref.fma_f32(m_new, f32(lr), x.float()))
    want = (x_new - xhat.float(), m_new.to(dt), x_new.to(dt))
    got_buf, got_m, got_x = buf.clone(), m.clone(), x.clone()
    out = ref.server_update_(got_buf, got_m, got_x, xhat,
                             inv_k=f32(1.0 / k),
                             beta=None if beta is None else f32(beta),
                             lr=f32(lr), chunk=777)
    assert out is got_buf
    for a, b in zip((got_buf, got_m, got_x), want):
        assert _same(a, b)
    got2 = (buf.clone(), m.clone(), x.clone())
    server_update_(*got2, xhat, k=k, beta=beta, lr=lr)
    for a, b in zip(got2, want):
        assert _same(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_round_state_from_jax_builds_the_flat_state(dtype):
    jc = JC.get_reduced("gemma2-2b").replace(param_dtype=dtype, dtype=dtype)
    js = JS.init_round_state(jc, jax.random.PRNGKey(4))
    ts = round_state_from_jax(jax.device_get(js), device="cpu")
    assert ts.t == 0 and ts.flat is not None
    assert all(f.dtype == getattr(torch, dtype) for f in ts.flat)
    for name, flat in zip(("x", "hidden", "momentum"), ts.flat):
        tl, jl = tree_leaves(getattr(ts, name)), jax.tree.leaves(
            getattr(js, name))
        assert len(tl) == len(jl)
        lo, hi = flat.data_ptr(), flat.data_ptr() + flat.element_size() * \
            flat.numel()
        for a, b in zip(tl, jl):
            assert _same(a, np.asarray(b)) and lo <= a.data_ptr() < hi
    assert TreeLayout.of(ts.x).dtypes == tuple(
        dtype for _ in jax.tree.leaves(js.x))


def test_local_sgd_remat_matches_without():
    """Local SGD on the reduced gemma2-2b with the blocks checkpointed
    (``remat=True``: ``torch.autograd.grad``) and without
    (``torch.func.grad``): the losses and the parameters after two steps
    (so the gradients) bit for bit."""
    from repro_torch.data.synthetic import synthetic_lm_batch
    from repro_torch.models import transformer as TT

    tc = TC.get_reduced("gemma2-2b")
    tp = TT.init_params(tc, 5, "cpu")
    y0, layout = flatten_tree(tp)
    raw = synthetic_lm_batch(np.random.default_rng(2), 4, 16, tc.vocab)
    tb = {k: torch.from_numpy(v.reshape((2, 2) + v.shape[1:]))
          for k, v in raw.items()}
    keys = prng.split(prng.PRNGKey(3), 2)
    out = {}
    for remat in (False, True):
        loss = lambda p, b, k, r=remat: TT.loss_fn(tc, p, b, remat=r)[0]
        out[remat] = local_sgd(loss, 3e-2, layout, y0, tb, keys,
                               with_loss=True, remat=remat)
    assert _same(out[True][1], out[False][1])
    for a, b in zip(tree_leaves(out[True][0]), tree_leaves(out[False][0])):
        assert _same(a, b)
