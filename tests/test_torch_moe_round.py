"""The QAFeL round and its parameter layout on the MoE decoders (qwen3-moe-235b-a22b; deepseek-v3-671b with MLA, a dense
prefix and the MTP term in its loss), against the JAX package's, on the
CPU, at the reduced configs (f32).

Exact: the parameter tree of both published configs on ``meta`` against
the reference's ``abstract_params`` (leaf order, shapes, dtypes: the
64-layer deepseek tree, 3 prefix layers on top of 61 routed ones, and
its 706,131,752,960 parameters, which ``param_count``'s 671,025,397,760
does not count), the reduced configs' flat layouts (JAX's sorted keys:
``embed``, ``final_norm``, ``head``, ``layers``, ``mtp_block``,
``mtp_norm``, ``prefix_layers``); the server half on each model's own
tree from the same K packed messages against the reference's jitted
server half. Within the bounds of tests/test_torch_llm_round.py: two
rounds of the reference's jitted round and of the port's on the same
batches, keys and unequal staleness weights, one round at a time from
equal inputs (losses, x's change and the momentum in L2, the share of
x-hat bit-equal: ``MOE_HIDDEN_EQUAL_FLOOR``); and the
reference's ``test_qafel_round_reduces_loss`` for deepseek (qsgd8, K =
2, two rounds: the losses finite, x and x-hat moved). The training
launcher's test is in tests/test_torch_mla.py, beside the serving one.
"""
import jax
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.distributed import steps as JS
from repro.models import transformer as JT
from repro_torch import configs as TC
from repro_torch.common import prng
from repro_torch.common.tree import tree_leaves
from repro_torch.core.qafel import QAFeLConfig
from repro_torch.core.quantizers import TreeLayout
from repro_torch.core.staleness import staleness_weight
from repro_torch.distributed import steps as TS
from repro_torch.launch import train
from repro_torch.models import transformer as TT
from test_torch_archs import one_thread  # noqa: F401
from test_torch_archs_round import _rounds
from test_torch_archs_round import test_server_half_bit_for_bit as _half
from test_torch_llm_round import LOSS_RTOL, _flat_bits, check_rounds
from test_torch_moe import ARCHS

TREE_PARAMS = {"qwen3-moe-235b-a22b": 235_093_634_560,
               "deepseek-v3-671b": 706_131_752_960}
PARAM_COUNT = {"qwen3-moe-235b-a22b": 235_092_836_352,
               "deepseek-v3-671b": 671_025_397_760}
# the share of x-hat bit-equal after each round, compared one round at a
# time from equal inputs (tests/test_torch_llm_round.py's
# ``compare_rounds``), held at the 95% of the dense decoders. It counts the
# 128-coordinate wire rows whose four client deltas agree to the last bit,
# and moves with where the gradients' last-bit noise (within 1.1-1.8e-6 of
# each leaf's largest value) flips a dithered code. The chained
# comparison it replaces, each side's round 2 from its own round-1 state,
# amplified that noise past any floor: over batch seeds 0-8 qwen3-moe's
# chained share ran 53.9-93.2%, the reference against itself from a state
# one ulp off on 1% of the coordinates 74.2%, and taking XLA's ``exp`` in
# the loss moved it from 88.4% to 74.5% (its floor was 85%). One round at
# a time, with that ``exp`` and the reference's silu in the experts:
# qwen3-moe 97.94% / 97.98% and deepseek 97.62% / 97.84% (rounds 1 / 2;
# qwen3-moe's x and m 4.4e-4 and 6.9e-4 in L2). Measured on one thread
# from the reference's jitted init (this test).
MOE_HIDDEN_EQUAL_FLOOR = 0.95
TOP_KEYS = {"qwen3-moe-235b-a22b": ["embed", "final_norm", "head",
                                    "layers"],
            "deepseek-v3-671b": ["embed", "final_norm", "head", "layers",
                                 "mtp_block", "mtp_norm", "prefix_layers"]}


@pytest.fixture(autouse=True)
def jitted_reference_init(monkeypatch):
    """The reference's ``init_params`` and ``init_round_state`` jitted
    for the helpers shared with tests/test_torch_archs_round.py: eagerly,
    deepseek's reduced init compiles op by op for ~15 s here. The jitted
    draws are the reference's too, but not bit for bit its eager ones
    (XLA fuses the truncated normal), which moves the x-hat share
    (``MOE_HIDDEN_EQUAL_FLOOR``)."""
    monkeypatch.setattr(JT, "init_params",
                        jax.jit(JT.init_params, static_argnums=0))
    monkeypatch.setattr(JS, "init_round_state",
                        jax.jit(JS.init_round_state, static_argnums=0))


@pytest.mark.parametrize("arch", ARCHS)
def test_layout_matches_reference(arch):
    """The published config on ``meta`` (nothing allocated) against the
    reference's ``abstract_params``, ``abstract_round_state``'s x, and the
    reduced config's flat layout against the reference's."""
    cfg = TC.get_config(arch)
    meta = TT.abstract_params(cfg)
    want = JT.abstract_params(JC.get_config(arch))
    assert jax.tree.structure(want) == jax.tree.structure(
        jax.tree.map(lambda t: 0, meta))
    for t, w in zip(tree_leaves(meta), jax.tree.leaves(want)):
        assert tuple(t.shape) == w.shape and t.device.type == "meta"
        assert str(t.dtype).split(".")[-1] == str(w.dtype)
    assert sorted(meta) == TOP_KEYS[arch]
    assert sum(t.numel() for t in tree_leaves(meta)) == TREE_PARAMS[arch]
    assert cfg.param_count() == JC.get_config(arch).param_count() \
        == PARAM_COUNT[arch]
    if cfg.n_dense_layers:
        assert meta["prefix_layers"]["mlp"]["w_gate"].shape == (3, 7168,
                                                                18432)
        assert meta["layers"]["pos0_attn"]["moe"]["w_gate"].shape == (
            61, 256, 7168, 2048)
    state = TS.abstract_round_state(cfg)
    assert all(t.device.type == "meta" for t in tree_leaves(state.hidden))
    red = TT.abstract_params(TC.get_reduced(arch))
    want = jax.tree.leaves(JT.abstract_params(JC.get_reduced(arch)))
    tl = TreeLayout.of(red)
    assert list(tl.shapes) == [w.shape for w in want]
    assert list(tl.sizes) == [int(np.prod(w.shape)) for w in want]


@pytest.mark.parametrize("arch", ARCHS)
def test_two_rounds_match_reference(arch):
    """Two whole rounds (qsgd4 both ways, K = 4, P = 2, local batch 2,
    sequence 32) against the reference's jitted round, one round at a time
    from equal inputs: the routers' aux and deepseek's MTP term in each
    client's loss."""
    out = _rounds(arch)
    np.testing.assert_allclose(out["tloss"], out["jloss"], rtol=LOSS_RTOL)
    check_rounds(out["rounds"], arch, floor=MOE_HIDDEN_EQUAL_FLOOR)


@pytest.mark.parametrize("arch", ARCHS)
def test_server_half_bit_for_bit(arch):
    """The server half on the MoE trees (expert banks, routers; deepseek's
    MLA, prefix and MTP leaves) from the same four packed messages,
    against the reference's jitted server half."""
    _half(arch)


def test_deepseek_round_moves_x_and_hidden():
    """The reference's ``test_qafel_round_reduces_loss`` for deepseek's
    reduced config (qsgd8 both ways, K = 2, P = 2, one sequence of 32 a
    client), whose check for deepseek is that the round is finite and
    moves x and x-hat: two rounds here (the reference runs four for the
    other archs' descent check)."""
    cfg = TC.get_reduced("deepseek-v3-671b")
    qcfg = QAFeLConfig(client_lr=2e-2, server_lr=1.0, buffer_size=2,
                       local_steps=2, client_quantizer="qsgd8",
                       server_quantizer="qsgd8")
    round_fn = TS.make_qafel_round(cfg, qcfg, remat=False)
    state = TS.init_round_state(cfg, 0, "cpu")
    x0 = _flat_bits(state.x)
    rng = np.random.default_rng(0)
    weights = staleness_weight(torch.zeros(qcfg.buffer_size))
    losses = []
    for step in range(2):
        batch = train.round_batch(cfg, qcfg, rng, 1, 32, "cpu")
        state, met = round_fn(state, batch, weights, prng.PRNGKey(step))
        losses.append(float(met["loss"]))
    assert all(np.isfinite(losses))
    assert np.abs(_flat_bits(state.x) - x0).sum() > 0
    assert np.abs(_flat_bits(state.hidden) - x0).sum() > 0
