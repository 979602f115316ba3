"""The QAFeL round's halves on mamba2-1.3b and zamba2-7b against the
JAX package's, on the CPU, at their reduced configs: in f32 (one dtype)
and as the mixed tree of the published configs (``REDUCED.replace(
param_dtype="bfloat16", dtype="bfloat16")``: every leaf bf16 but the f32
``A_log``, ``D`` and ``dt_bias``), whose state ``distributed.steps``
keeps in place in bf16 buffers with those leaves beside them.

Bit for bit, for equal client messages: the server half (``accumulate``
and ``server_half`` on the model's own tree, momentum 0.3) against the
reference's jitted server half (tests/test_torch_llm_round.py's
``_reference_half``), x, x-hat, m and the broadcast, each f32 leaf
never rounded through bf16; with the taps on, the tap vector too
(tests/test_torch_round_taps.py's reference half), two rounds. The
client step on the mixed x-hat (``core.quantizers.SplitFlat``) against
the same step on an f32 copy of it. Whole rounds are in
tests/test_torch_mamba2_round.py. The launchers on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.core.qafel import QAFeLConfig as JConfig
from repro.models import transformer as JT
from repro_torch import configs as TC
from repro_torch.common import prng
from repro_torch.common.tree import tree_leaves
from repro_torch.convert import params_from_jax
from repro_torch.core.qafel import QAFeLConfig, client_update_flat
from repro_torch.core.quantizers import SplitFlat, TreeLayout
from repro_torch.distributed import steps as TS
from repro_torch.examples import federated_llm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref
from repro_torch.kernels import taps as ttaps
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train
from repro_torch.models import transformer as TT
from test_torch_archs import one_thread  # noqa: F401
from test_torch_llm_round import QCFG, _reference_half, _same
from test_torch_round_taps import _reference_half as _taps_half

ARCHS = ("mamba2-1.3b", "zamba2-7b")
DTYPES = ("float32", "bfloat16")
SEQ, LOCAL = 32, federated_llm.LOCAL_BATCH
WEIGHTS = np.array([0.9, 1.0, 0.7, 0.5], np.float32)


def _configs(arch: str, dtype: str):
    """The reduced config in both packages, in ``dtype`` (bf16: the mixed
    tree of the published configs)."""
    return (JC.get_reduced(arch).replace(param_dtype=dtype, dtype=dtype),
            TC.get_reduced(arch).replace(param_dtype=dtype, dtype=dtype))


def _half_state(arch: str, dtype: str, seed: int = 5):
    """Noisy x, x-hat and m trees of the model (the reference's), leaves
    in their own dtypes."""
    jc = _configs(arch, dtype)[0]
    rng = np.random.default_rng(seed)
    jp = jax.jit(lambda k: JT.init_params(jc, k))(jax.random.PRNGKey(seed))
    noise = lambda a, s: (a.astype(jnp.float32) + jnp.asarray(
        s * rng.standard_normal(a.shape), jnp.float32)).astype(a.dtype)
    x = jax.tree.map(lambda a: noise(a, 0.01), jp)
    hidden = jax.tree.map(lambda a: noise(a, 0.002), x)
    m = jax.tree.map(lambda a: noise(jnp.zeros_like(a), 0.001), jp)
    d = sum(a.size for a in jax.tree.leaves(jp))
    return x, hidden, m, d, rng


def _port_state(x, hidden, m):
    return TS.RoundState.from_trees(
        *(params_from_jax(jax.tree.map(np.asarray, t), device="cpu")
          for t in (x, hidden, m)))


def _messages(rng, d: int, k: int = 4, bits: int = 4):
    deltas = (0.003 * rng.standard_normal((k, d))).astype(np.float32)
    seeds = torch.from_numpy(rng.integers(0, 2 ** 32, (k, 2)))
    return tops.qsgd_quantize_batch(torch.from_numpy(deltas), seeds, bits)


def _sum(packed, norms, d: int, bits: int = 4):
    buf = torch.zeros(d)
    w = torch.from_numpy(WEIGHTS)
    for k in range(len(WEIGHTS)):
        TS.accumulate(buf, packed[k], norms[k], w[k:k + 1], bits=bits, d=d)
    return buf


def _mixed(state) -> list:
    """The state's side leaves (none for one dtype)."""
    return TS._sides(state, TreeLayout.of(state.x))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_server_half_bit_for_bit(arch, dtype):
    """The server half on the model's own tree from the same four packed
    messages, against the reference's jitted server half; the mixed
    tree's three f32 leaves a mamba position (``_sides``) stay f32, its
    bf16 buffers shadow them."""
    bits = 4
    x, hidden, m, d, rng = _half_state(arch, dtype)
    packed, norms = _messages(rng, d)
    jq = JConfig(**QCFG)
    want = jax.jit(lambda *a: _reference_half(*a, d=d, bits=bits, qcfg=jq))(
        x, hidden, m, jnp.asarray(packed.numpy()),
        jnp.asarray(norms.numpy()), jnp.asarray(WEIGHTS),
        jax.random.PRNGKey(9))
    state = _port_state(x, hidden, m)
    sides = _mixed(state)
    cfg = _configs(arch, dtype)[1]
    mamba = sum(k == "mamba" for k in cfg.layer_pattern)
    assert len(sides) == (3 * mamba if dtype == "bfloat16" else 0)
    bp, bn = TS.server_half(*state.flat, _sum(packed, norms, d),
                            prng.PRNGKey(9), qcfg=QAFeLConfig(**QCFG), d=d,
                            sides=sides)
    assert _same(bp, want[3]) and _same(bn, want[4])
    for got, ref_t in ((state.x, want[0]), (state.hidden, want[1]),
                       (state.momentum, want[2])):
        for a, b in zip(tree_leaves(got), jax.tree.leaves(ref_t)):
            assert _same(a, b)
    for sd in sides:
        assert sd.x.dtype == torch.float32
        assert torch.equal(state.flat[0][sd.off:sd.end],
                           sd.x.to(torch.bfloat16))


def test_mixed_half_differs_from_a_bf16_round_trip():
    """A control: the mixed state's f32 leaves after the server half are
    not their bf16 roundings (a state that kept them in its bf16 buffers
    would fail the bit-for-bit test above)."""
    x, hidden, m, d, rng = _half_state("mamba2-1.3b", "bfloat16")
    packed, norms = _messages(rng, d)
    state = _port_state(x, hidden, m)
    sides = _mixed(state)
    TS.server_half(*state.flat, _sum(packed, norms, d), prng.PRNGKey(9),
                   qcfg=QAFeLConfig(**QCFG), d=d, sides=sides)
    moved = [sd.hidden for sd in sides]
    rounded = [t.to(torch.bfloat16).to(torch.float32) for t in moved]
    assert sum(int((a != b).sum()) for a, b in zip(moved, rounded)) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_taps_on_the_mixed_state_bit_for_bit(arch):
    """Two rounds' server halves with the taps on, on the mixed tree:
    the tap vector (``server_half(taps=)`` then ``round_taps``), the
    state and the broadcast equal the reference's jitted half with its
    taps; the side leaves' windows are recomputed whole."""
    bits = 4
    x, hidden, m, d, rng = _half_state(arch, "bfloat16")
    jq, tqc = JConfig(**QCFG), QAFeLConfig(**QCFG)
    half = jax.jit(lambda *a: _taps_half(*a, d=d, bits=bits, qcfg=jq))
    state = _port_state(x, hidden, m)
    sides = _mixed(state)
    w = torch.from_numpy(WEIGHTS)
    for step in range(2):
        packed, norms = _messages(rng, d)
        want = half(x, hidden, m, jnp.asarray(packed.numpy()),
                    jnp.asarray(norms.numpy()), jnp.asarray(WEIGHTS),
                    jax.random.PRNGKey(9 + step), jnp.int32(step))
        partials = torch.empty((5, ref.tap_windows(d)))
        bp, bn = TS.server_half(*state.flat, _sum(packed, norms, d),
                                prng.PRNGKey(9 + step), qcfg=tqc, d=d,
                                taps=partials, sides=sides)
        assert _same(ttaps.round_taps(partials, w), want[5])
        assert _same(bp, want[3]) and _same(bn, want[4])
        for got_t, ref_t in zip((state.x, state.hidden, state.momentum),
                                want[:3]):
            assert all(_same(a, b) for a, b in zip(
                tree_leaves(got_t), jax.tree.leaves(ref_t)))
        x, hidden, m = want[:3]


def test_client_step_reads_the_side_leaves_in_their_dtype():
    """The round's client step on the mixed tree's x-hat as the state
    hands it (``SplitFlat``: the bf16 buffer, the f32 leaves beside it)
    equals, bit for bit, the same step from an f32 copy of x-hat (every
    leaf exact in f32): the same wire codes, norms and losses."""
    x, hidden, m, d, _ = _half_state("zamba2-7b", "bfloat16")
    state = _port_state(x, hidden, m)
    tc = _configs("zamba2-7b", "bfloat16")[1]
    tq = QAFeLConfig(**QCFG)
    layout = TreeLayout.of(state.x)
    sides = _mixed(state)
    split = SplitFlat(state.flat[1], {sd.off: sd.hidden for sd in sides})
    f32 = torch.cat([t.reshape(-1).float()
                     for t in tree_leaves(state.hidden)])
    batch = train.round_batch(tc, tq, np.random.default_rng(1), LOCAL, SEQ,
                              "cpu")
    loss = lambda p, b, k: TT.loss_fn(tc, p, b, remat=False)[0]
    k_train, k_enc = prng.split(prng.PRNGKey(4))
    outs = [client_update_flat(
        loss, tq, tq.cq().spec, layout, flat,
        {n: v[0] for n, v in batch.items()}, k_train, k_enc,
        with_loss=True) for flat in (split, f32)]
    (a, la), (b, lb) = outs
    assert torch.equal(a["packed"], b["packed"])
    assert _same(a["norms"], b["norms"]) and _same(la, lb)


def test_split_flat_reads_each_leaf_in_its_dtype():
    """``SplitFlat``: a slice inside a side leaf reads the leaf (f32), a
    slice of the base the base; a slice across a side leaf is refused."""
    base = torch.arange(10, dtype=torch.bfloat16)
    side = torch.tensor([0.1, 0.2, 0.3], dtype=torch.float32)
    flat = SplitFlat(base, {4: side})
    assert flat[4:7] is not None and torch.equal(flat[4:7], side)
    assert flat[5:6].dtype == torch.float32
    assert torch.equal(flat[0:4], base[:4]) and flat.numel() == 10
    assert torch.equal(flat[7:10], base[7:])
    with pytest.raises(ValueError, match="cross"):
        flat[3:5]


def test_launchers_on_cpu(capsys):
    """``launch.train`` one round of mamba2-1.3b's reduced config (a
    finite loss, one upload's qsgd4 bytes of its d), ``launch.serve``
    zamba2-7b's (a KV cache per use of the shared block)."""
    out = train.main(["--arch", "mamba2-1.3b", "--reduced", "--steps", "1",
                      "--seq", str(SEQ), "--global-batch", "4", "--device",
                      "cpu"])
    assert torch.isfinite(out["losses"]).all() and out["state"].t == 1
    d = sum(t.numel() for t in tree_leaves(out["state"].x))
    assert out["metrics"]["upload_bytes"] == (4 * d + 32 * -(-d // 128)) / 8
    out = launch_serve.main(["--arch", "zamba2-7b", "--reduced", "--device",
                             "cpu", "--prompt-len", "16", "--decode-steps",
                             "3"])
    cache = out["cache"]["layers"]
    cfg = TC.get_reduced("zamba2-7b")
    assert cache["pos2_attn_shared"]["k"].shape[:2] == (cfg.n_super_blocks,
                                                        4)
    assert out["tokens"].shape == (4, 4)
    capsys.readouterr()
