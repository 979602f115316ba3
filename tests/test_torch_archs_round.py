"""The QAFeL round and the training launcher on internvl2-1b (a prefix of
patch embeddings in every batch) and musicgen-large (codebook tokens),
against the JAX package's, on the CPU, at their reduced configs (f32).

The round is generic over the batch's leaves: ``launch.train.round_batch``
gives (K, P, local, 16, 256) patch embeddings and (K, P, local, seq, 4)
codebook tokens, which ``distributed.steps.make_qafel_round`` hands to
each client unchanged.

Bit for bit: the batches against the reference's numpy stream; the
server half (``accumulate`` and ``server_half`` from the same K packed
messages and weights, on each model's own tree) against the reference's
jitted server half (tests/test_torch_llm_round.py's ``_reference_half``).
Within the bounds of tests/test_torch_llm_round.py: two rounds of the
reference's jitted round and of the port's on the same batches, keys and
unequal staleness weights, compared one round at a time from equal
inputs (``compare_rounds``: round 2 of the port from the reference's
round-1 state), each round's losses, x's change and the momentum in L2,
and the share of x-hat bit-equal at 95%. These are proxies for the model
math's last-bit differences (the gradients agree with the reference's as
gemma2-2b's do, tests/test_torch_archs.py): each flip of a client's
stochastic rounding moves a coordinate by a whole step, and how many
flip depends on the batch and on the CPU's thread count (the module runs
on one torch thread). Chained over two rounds, each side from its own
round-1 state, the share measured how the rounds amplify that noise
(musicgen 90.09%, 90.1-90.7% over 1-8 threads); one round at a time it
is 98.3-98.6% (tests/test_torch_llm_round.py says why the chain went).
The launcher's command
line on the CPU for both, and its refusal of internvl2-1b's default
``--seq 128``, which its 256 patch embeddings do not leave room for.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.core.qafel import QAFeLConfig as JConfig
from repro.data.synthetic import synthetic_batch_for_config as jbatch
from repro.distributed import steps as JS
from repro.models import transformer as JT
from repro_torch import configs as TC
from repro_torch.common import prng
from repro_torch.common.tree import tree_leaves
from repro_torch.convert import params_from_jax, round_state_from_jax
from repro_torch.core.qafel import QAFeLConfig
from repro_torch.distributed import steps as TS
from repro_torch.kernels import ops as tops
from repro_torch.examples import federated_llm
from repro_torch.launch import train
from test_torch_archs import one_thread  # noqa: F401
from test_torch_llm_round import (LOSS_RTOL, QCFG, _reference_half, _same,
                                  check_rounds, compare_rounds)

ARCHS = ("internvl2-1b", "musicgen-large")
SEQ, LOCAL = 32, federated_llm.LOCAL_BATCH  # a prefix of 16 in the VLM's 32


def _rounds(arch: str) -> dict:
    """Two rounds of the reference's jitted round and of the port's from
    the reference's initial state, on the same batches and keys, one round
    at a time from equal inputs (``compare_rounds``)."""
    jc, tc = JC.get_reduced(arch), TC.get_reduced(arch)
    jq, tq = JConfig(**QCFG), QAFeLConfig(**QCFG)
    jround = jax.jit(JS.make_qafel_round(jc, jq, remat=False))
    tround = TS.make_qafel_round(tc, tq)
    jstate = JS.init_round_state(jc, jax.random.PRNGKey(0))
    tstate = round_state_from_jax(jax.device_get(jstate), device="cpu")
    weights = np.array([0.9, 1.0, 0.7, 0.5], np.float32)
    rng_j, rng_t = np.random.default_rng(0), np.random.default_rng(0)
    k, p = QCFG["buffer_size"], QCFG["local_steps"]
    shapes = {}

    def batch_pair(step):
        raw = jbatch(jc, rng_j, k * p * LOCAL, SEQ)
        jb = {n: jnp.asarray(v).reshape((k, p, LOCAL) + v.shape[1:])
              for n, v in raw.items()}
        tb = train.round_batch(tc, tq, rng_t, LOCAL, SEQ, "cpu")
        assert set(tb) == set(jb)
        assert all(np.array_equal(tb[n].numpy(), np.asarray(jb[n]))
                   for n in jb)
        shapes.update({n: tuple(v.shape) for n, v in tb.items()})
        return jb, tb

    recs = compare_rounds(jround, tround, jstate, tstate, batch_pair,
                          weights)
    return dict(rounds=recs, shapes=shapes,
                jloss=[r["jloss"] for r in recs],
                tloss=[r["tloss"] for r in recs])


@pytest.mark.parametrize("arch", ARCHS)
def test_two_rounds_match_reference(arch):
    out = _rounds(arch)
    cfg = TC.get_reduced(arch)
    lead = (QCFG["buffer_size"], QCFG["local_steps"], LOCAL)
    if cfg.modality == "vlm":
        n = cfg.n_prefix_embeddings
        assert out["shapes"]["patch_embeddings"] == lead + (n, cfg.d_model)
        assert out["shapes"]["tokens"] == lead + (SEQ - n,)
    else:
        assert out["shapes"]["tokens"] == out["shapes"]["labels"] == \
            lead + (SEQ, cfg.audio_codebooks)
    np.testing.assert_allclose(out["tloss"], out["jloss"], rtol=LOSS_RTOL)
    check_rounds(out["rounds"], arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_server_half_bit_for_bit(arch):
    """The server half on the model's own tree (musicgen's (CB, V, D)
    embed and heads, internvl2's tied embedding) from the same four packed
    messages, against the reference's jitted server half."""
    bits, k = 4, QCFG["buffer_size"]
    jc = JC.get_reduced(arch)
    rng = np.random.default_rng(5)
    jp = JT.init_params(jc, jax.random.PRNGKey(5))
    noise = lambda a, s: a + jnp.asarray(s * rng.standard_normal(a.shape),
                                         a.dtype)
    x = jax.tree.map(lambda a: noise(a, 0.01), jp)
    hidden = jax.tree.map(lambda a: noise(a, 0.002), x)
    m = jax.tree.map(lambda a: noise(jnp.zeros_like(a), 0.001), jp)
    d = sum(a.size for a in jax.tree.leaves(jp))
    deltas = (0.003 * rng.standard_normal((k, d))).astype(np.float32)
    packed, norms = tops.qsgd_quantize_batch(
        torch.from_numpy(deltas),
        torch.from_numpy(rng.integers(0, 2 ** 32, (k, 2))), bits)
    w = rng.uniform(0.4, 1.0, k).astype(np.float32)
    want = jax.jit(lambda *a: _reference_half(*a, d=d, bits=bits,
                                              qcfg=JConfig(**QCFG)))(
        x, hidden, m, jnp.asarray(packed.numpy()),
        jnp.asarray(norms.numpy()), jnp.asarray(w), jax.random.PRNGKey(9))
    state = TS.RoundState.from_trees(
        *(params_from_jax(jax.tree.map(np.asarray, t), device="cpu")
          for t in (x, hidden, m)))
    buf = torch.zeros(d)
    for i in range(k):
        TS.accumulate(buf, packed[i], norms[i], torch.from_numpy(w[i:i + 1]),
                      bits=bits, d=d)
    bp, bn = TS.server_half(*state.flat, buf, prng.PRNGKey(9),
                            qcfg=QAFeLConfig(**QCFG), d=d)
    assert _same(bp, want[3]) and _same(bn, want[4])
    for got, ref in ((state.x, want[0]), (state.hidden, want[1]),
                     (state.momentum, want[2])):
        for a, b in zip(tree_leaves(got), jax.tree.leaves(ref)):
            assert _same(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_on_cpu(arch, capsys):
    """``launch.train.main`` with ``--device cpu``: one round of one
    sequence a client, a finite loss, one upload's bytes by the qsgd4
    formula of the model's d."""
    out = train.main(["--arch", arch, "--reduced", "--steps", "1", "--seq",
                      str(SEQ), "--global-batch", "4", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[:2] for ln in lines] == [["round", "0"]]
    assert torch.isfinite(out["losses"]).all() and out["state"].t == 1
    d = sum(t.numel() for t in tree_leaves(out["state"].x))
    assert out["metrics"]["upload_bytes"] == (4 * d + 32 * -(-d // 128)) / 8


def test_launcher_refuses_a_seq_within_the_vlm_prefix():
    """internvl2-1b at the launcher's default ``--seq 128`` (256 patch
    embeddings) and its reduced config at ``--seq 16`` (16): refused
    naming the prefix, before any state is made."""
    with pytest.raises(ValueError, match="prefix"):
        train.main(["--arch", "internvl2-1b", "--steps", "1", "--device",
                    "cpu"])
    with pytest.raises(ValueError, match="prefix"):
        train.main(["--arch", "internvl2-1b", "--reduced", "--seq", "16",
                    "--device", "cpu"])
