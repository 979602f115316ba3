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
test_torch_transformer.py): two whole rounds of the reference's jitted
round (compiled once) and the port's from the same state, batches, keys
and unequal staleness weights: the losses within ``LOSS_RTOL``; x's change
and the momentum within ``STATE_L2_RTOL`` in L2; the share of x-hat's
coordinates equal bit for bit is printed (``-s``) and held above
``HIDDEN_EQUAL_FLOOR`` (a coordinate differs where the clients' near-equal
deltas quantize to other codes). A bf16 reduced config's two local steps:
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
from repro_torch.core.qafel import QAFeLConfig, local_sgd
from repro_torch.core.quantizers import TreeLayout, flatten_tree
from repro_torch.distributed import steps as TS
from repro_torch.examples import federated_llm
from repro_torch.kernels import ops as tops

LOSS_RTOL = 1e-5            # round losses (measured 2.9e-7)
HIDDEN_EQUAL_FLOOR = 0.9    # share of x-hat bit-equal after 2 rounds
STATE_L2_RTOL = 5e-3        # x - x_0 and m after 2 rounds, L2 relative
                            # (measured 8.0e-4 and 9.0e-4)
# bf16 local SGD at the reduced gemma2-2b (measured; the control is the
# same run with y kept in f32)
BF16_SGD_LOSS_ATOL = 1e-3      # step losses near 6.2 (measured 3.8e-4)
BF16_DELTA_EQUAL_FLOOR = 0.9   # moved deltas equal (0.9446; control 0.0011)
BF16_DELTA_L1 = 2e-2           # their relative L1 error (9.9e-3; 0.176)
BF16_ONE_SIDED_SHARE = 1e-2    # coordinates moved by one side (3.7e-3)
QCFG = dict(client_lr=3e-2, server_lr=1.0, server_momentum=0.3,
            buffer_size=4, local_steps=2, client_quantizer="qsgd4",
            server_quantizer="qsgd4")


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
    y = local_sgd(_linear_loss_torch, 3e-2, layout, y0,
                  {"c": torch.from_numpy(c)}, prng.split(prng.PRNGKey(0), 3))
    got = layout.unflatten(y)
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
    got = layout.unflatten(local_sgd(
        _linear_loss_torch, 0.37, layout, y0, {"c": torch.from_numpy(c)},
        prng.split(prng.PRNGKey(1), 2)))
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
    y, tl = local_sgd(tloss, 3e-2, layout, y0, tb,
                      prng.split(prng.PRNGKey(3), 2), with_loss=True)
    got = layout.unflatten(y)
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
    c_share, c_l1, _, _ = delta_stats(
        TreeLayout.of(_to_f32(tp)).unflatten(y32))
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_server_half_bit_for_bit(dtype):
    bits = 4
    x, hidden, m, packed, norms, w, d = _half_inputs(dtype, bits=bits)
    jq = JConfig(**QCFG)
    want = jax.jit(lambda *a: _reference_half(*a, d=d, bits=bits, qcfg=jq))(
        x, hidden, m, jnp.asarray(packed.numpy()), jnp.asarray(norms.numpy()),
        jnp.asarray(w), jax.random.PRNGKey(9))
    tx, th, tm = (params_from_jax(jax.tree.map(np.asarray, t), device="cpu")
                  for t in (x, hidden, m))
    hf, layout = flatten_tree(th)
    buf = torch.zeros(d)
    for k in range(packed.shape[0]):
        buf = TS.accumulate(buf, packed[k], norms[k],
                            torch.from_numpy(w[k:k + 1]), bits=bits, d=d)
    x_new, h_new, m_new, (bp, bn) = TS.server_half(
        flatten_tree(tx)[0], hf, flatten_tree(tm)[0], buf,
        prng.PRNGKey(9), qcfg=QAFeLConfig(**QCFG), sbits=bits, d=d)
    assert _same(bp, want[3]) and _same(bn, want[4])
    for got, ref_tree in ((x_new, want[0]), (h_new, want[1]),
                          (m_new, want[2])):
        gt = layout.unflatten(got)
        for a, b in zip(tree_leaves(gt), jax.tree.leaves(ref_tree)):
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


def _rounds():
    """Two rounds of the reference's jitted round (one compile) and of the
    port's from the same state, batches and keys; cached for the module."""
    if _CACHE:
        return _CACHE
    jc, tc = JC.get_reduced("gemma2-2b"), TC.get_reduced("gemma2-2b")
    jq, tq = JConfig(**QCFG), QAFeLConfig(**QCFG)
    jround = jax.jit(JS.make_qafel_round(jc, jq, remat=False))
    tround = TS.make_qafel_round(tc, tq)
    jstate = JS.init_round_state(jc, jax.random.PRNGKey(0))
    tstate = round_state_from_jax(jax.device_get(jstate), device="cpu")
    jx0 = _flat_bits(jax.device_get(jstate.x))
    weights = np.array([0.9, 1.0, 0.7, 0.5], np.float32)
    rng_j, rng_t = np.random.default_rng(0), np.random.default_rng(0)
    from repro.data.synthetic import synthetic_batch_for_config as jbatch
    jm, tm = [], []
    for step in range(2):
        raw = jbatch(jc, rng_j, 4 * 2 * 2, 64)
        jb = {k: jnp.asarray(v).reshape((4, 2, 2) + v.shape[1:])
              for k, v in raw.items()}
        jstate, jmet = jround(jstate, jb, jnp.asarray(weights),
                              jax.random.PRNGKey(step))
        jm.append(float(jmet["loss"]))
        tb = federated_llm.round_batch(tc, tq, rng_t, 64, "cpu")
        assert all(np.array_equal(tb[k].numpy(), np.asarray(jb[k]))
                   for k in jb)
        tstate, tmet = tround(tstate, tb, torch.from_numpy(weights),
                              prng.PRNGKey(step))
        tm.append(tmet)
    _CACHE.update(jstate=jax.device_get(jstate), tstate=tstate, jx0=jx0,
                  jloss=jm, port_metrics=tm)
    return _CACHE


def test_two_rounds_match_reference():
    out = _rounds()
    tl = [float(m["loss"]) for m in out["port_metrics"]]
    np.testing.assert_allclose(tl, out["jloss"], rtol=LOSS_RTOL)
    js, ts = out["jstate"], out["tstate"]
    assert ts.t == int(js.t) == 2
    jh, th = _flat_bits(js.hidden), _flat_bits(ts.hidden)
    share = float(np.mean(jh.view(np.int32) == th.view(np.int32)))
    print(f"x-hat bit-equal after 2 rounds: {share:.6f} of "
          f"{jh.size:,} coordinates")
    assert share >= HIDDEN_EQUAL_FLOOR
    # x's change over the rounds and the momentum, each in L2 relative to
    # the reference's
    for name, base in (("x", out["jx0"]), ("momentum", 0.0)):
        a = _flat_bits(getattr(js, name)) - base
        b = _flat_bits(getattr(ts, name)) - base
        rel = float(np.linalg.norm(b.astype(np.float64) - a)
                    / np.linalg.norm(a))
        print(f"{name} after 2 rounds: L2 error {rel:.3e} of the "
              "reference's")
        assert rel <= STATE_L2_RTOL, (name, rel)
    assert TreeLayout.of(ts.hidden) == TreeLayout.of(
        params_from_jax(js.hidden, device="cpu"))


def test_round_refuses_what_it_does_not_port():
    cfg, q = TC.get_reduced("gemma2-2b"), QAFeLConfig(**QCFG)
    for kw, item in ((dict(pod_quantized=True), "14d"),
                     (dict(chunk_rows=8), "13"), (dict(taps=True), "13"),
                     (dict(remat=True), "13")):
        with pytest.raises(NotImplementedError, match=item):
            TS.make_qafel_round(cfg, q, **kw)
    with pytest.raises(NotImplementedError, match="14d"):
        TS.make_qafel_round(cfg, QAFeLConfig(client_quantizer="top_k0.1"))
    with pytest.raises(NotImplementedError, match="14b"):
        TS.make_prefill_step(cfg)


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
