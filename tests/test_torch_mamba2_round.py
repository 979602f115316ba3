"""Two whole QAFeL rounds on mamba2-1.3b and zamba2-7b against the JAX
package's, on the CPU, at their reduced configs, in f32 and as the mixed
bf16/f32 tree of the published configs (tests/test_torch_hybrid.py holds
the halves bit for bit).

The reference's jitted round and the port's run on the same batches,
keys and unequal staleness weights, one round at a time from equal
inputs (tests/test_torch_llm_round.py's ``compare_rounds``: round 2 of
the port from the reference's round-1 state, copied into the port's own
state tensors in place). Bounds after each round: f32 those of
tests/test_torch_llm_round.py (losses, x's change over the round and the
momentum in L2, the share of x-hat bit-equal at 95%). In bf16 the model
math differs between the packages in its last bits as gemma2-2b's does
(``BF16_SGD_LOSS_ATOL``), each flip of a client's stochastic rounding
moves a coordinate by a whole step, and x's change is of the order of
its bf16 ulp, so x and m hold to ``BF16_STATE_L2_RTOL``. The control, the
reference's second round from the same state on another key, lies beyond
either bound. Chained over two rounds, each side from its own round-1
state, mamba2-1.3b's f32 share measured 93.2%, and 87.0% once the loss
took XLA's ``exp`` (its floor was 90%): the chain amplified the last-bit
noise (tests/test_torch_llm_round.py). The mixed state is updated in
place: the caller's object, its buffers and side tensors the same
storage, their values moved, a clone from before untouched.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.qafel import QAFeLConfig as JConfig
from repro.data.synthetic import synthetic_batch_for_config as jbatch
from repro.distributed import steps as JS
from repro_torch.common.tree import tree_leaves
from repro_torch.convert import round_state_from_jax
from repro_torch.core.qafel import QAFeLConfig
from repro_torch.distributed import steps as TS
from repro_torch.launch import train
from test_torch_archs import one_thread  # noqa: F401
from test_torch_hybrid import (ARCHS, DTYPES, LOCAL, SEQ, WEIGHTS,
                               _configs, _mixed)
from test_torch_llm_round import (BF16_SGD_LOSS_ATOL, HIDDEN_EQUAL_FLOOR,
                                  LOSS_RTOL, QCFG, STATE_L2_RTOL,
                                  _flat_bits, check_rounds, compare_rounds,
                                  round_figures)

BF16_STATE_L2_RTOL = 0.3  # x's change over a bf16 round and m, L2 relative


def _ptrs(state) -> list:
    return [f.data_ptr() for f in state.flat] + [
        t.data_ptr() for sd in _mixed(state) for t in (sd.x, sd.hidden, sd.m)]


def _rounds(arch: str, dtype: str) -> dict:
    """Two rounds of the reference's jitted round and of the port's from
    the reference's initial state, on the same batches and keys, one
    round at a time from equal inputs (``compare_rounds``); the control,
    the reference's second round on another key."""
    jc, tc = _configs(arch, dtype)
    jq, tq = JConfig(**QCFG), QAFeLConfig(**QCFG)
    jround = jax.jit(JS.make_qafel_round(jc, jq, remat=False))
    tround = TS.make_qafel_round(tc, tq)
    jstate = JS.init_round_state(jc, jax.random.PRNGKey(0))
    tstate = round_state_from_jax(jax.device_get(jstate), device="cpu")
    jx0 = _flat_bits(jax.device_get(jstate.x))
    before, ptrs = tstate.clone(), _ptrs(tstate)
    rng_j, rng_t = np.random.default_rng(0), np.random.default_rng(0)
    k, p = QCFG["buffer_size"], QCFG["local_steps"]

    def batch_pair(step):
        raw = jbatch(jc, rng_j, k * p * LOCAL, SEQ)
        jb = {n: jnp.asarray(v).reshape((k, p, LOCAL) + v.shape[1:])
              for n, v in raw.items()}
        return jb, train.round_batch(tc, tq, rng_t, LOCAL, SEQ, "cpu")

    recs = compare_rounds(jround, tround, jstate, tstate, batch_pair,
                          WEIGHTS, control_key=7)
    return dict(rounds=recs, tstate=tstate, jx0=jx0, before=before,
                jloss=[r["jloss"] for r in recs],
                tloss=[r["tloss"] for r in recs],
                in_place=all(r["same_obj"] for r in recs)
                and ptrs == _ptrs(tstate))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_two_rounds_match_reference(arch, dtype):
    """Two rounds, one at a time from equal inputs: the losses, x-hat's
    share bit-equal, x's change and the momentum in L2 within the stated
    bounds after each (the control beyond them); the state updated in
    place."""
    out = _rounds(arch, dtype)
    bf16 = dtype == "bfloat16"
    if bf16:
        np.testing.assert_allclose(out["tloss"], out["jloss"], rtol=0,
                                   atol=BF16_SGD_LOSS_ATOL)
    else:
        np.testing.assert_allclose(out["tloss"], out["jloss"],
                                   rtol=LOSS_RTOL)
    bound = BF16_STATE_L2_RTOL if bf16 else STATE_L2_RTOL
    ts = out["tstate"]
    assert out["in_place"]
    check_rounds(out["rounds"], f"{arch} {dtype}", HIDDEN_EQUAL_FLOOR, bound)
    last = out["rounds"][-1]
    ctl = round_figures(last, last["control"])
    print(f"{arch} {dtype}: control x {ctl['x']:.3e}, m "
          f"{ctl['momentum']:.3e} (L2)")
    assert ctl["x"] > bound and ctl["momentum"] > bound, ctl
    before = out["before"]
    assert before.t == 0 and np.array_equal(_flat_bits(before.x),
                                            out["jx0"])
    assert [t.dtype for t in tree_leaves(before.x)] == [
        t.dtype for t in tree_leaves(ts.x)]
    assert len(_mixed(ts)) == (len(_mixed(before)) if bf16 else 0)
    sides = _mixed(ts)
    assert all(sd.x.dtype == torch.float32 for sd in sides)
    assert not sides or any(bool((sd.m != 0).any()) for sd in sides)
