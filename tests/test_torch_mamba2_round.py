"""Two whole QAFeL rounds on mamba2-1.3b and zamba2-7b against the JAX
package's, on the CPU, at their reduced configs, in f32 and as the mixed
bf16/f32 tree of the published configs (tests/test_torch_hybrid.py holds
the halves bit for bit).

The reference's jitted round and the port's run from the same state,
batches, keys and unequal staleness weights. Bounds: f32 those of
tests/test_torch_llm_round.py (losses, x's change and the momentum in L2,
the share of x-hat bit-equal). In bf16 the model math differs between
the packages in its last bits as gemma2-2b's does
(``BF16_SGD_LOSS_ATOL``), each flip of a client's stochastic rounding
moves a coordinate by a whole step, and x's change is of the order of
its bf16 ulp, so x and m hold to ``BF16_STATE_L2_RTOL`` (measured 0.107
to 0.140 on one thread; f32 2.4e-4 to 4.0e-3). The control, the
reference's second round on another key, lies 0.44 to 0.71 away in
both dtypes, beyond either bound. As tests/test_torch_archs_round.py
says of the pool, these are proxies for the model math's last bits and
move with the batch and the state: from the jitted reference init's
state (its ``dt_bias`` rounded otherwise) mamba2-1.3b's f32 x-hat is
88.2% bit-equal, under the floor. The mixed state is updated in place:
the caller's object, its buffers and side tensors the same storage,
their values moved, a clone from before untouched.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.qafel import QAFeLConfig as JConfig
from repro.data.synthetic import synthetic_batch_for_config as jbatch
from repro.distributed import steps as JS
from repro_torch.common import prng
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
                                  _flat_bits)

BF16_STATE_L2_RTOL = 0.3  # x - x_0 and m after 2 bf16 rounds, L2 relative


def _ptrs(state) -> list:
    return [f.data_ptr() for f in state.flat] + [
        t.data_ptr() for sd in _mixed(state) for t in (sd.x, sd.hidden, sd.m)]


def _rounds(arch: str, dtype: str) -> dict:
    """Two rounds of the reference's jitted round and of the port's from
    the reference's initial state, on the same batches and keys; the
    control, the reference's second round on another key."""
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
    jloss, tloss, same_obj, control = [], [], True, None
    for step in range(2):
        raw = jbatch(jc, rng_j, k * p * LOCAL, SEQ)
        jb = {n: jnp.asarray(v).reshape((k, p, LOCAL) + v.shape[1:])
              for n, v in raw.items()}
        if step == 1:
            control = jax.device_get(jround(jstate, jb, jnp.asarray(WEIGHTS),
                                            jax.random.PRNGKey(7))[0])
        jstate, jmet = jround(jstate, jb, jnp.asarray(WEIGHTS),
                              jax.random.PRNGKey(step))
        tb = train.round_batch(tc, tq, rng_t, LOCAL, SEQ, "cpu")
        new, tmet = tround(tstate, tb, torch.from_numpy(WEIGHTS),
                           prng.PRNGKey(step))
        same_obj = same_obj and new is tstate
        tstate = new
        jloss.append(float(jmet["loss"]))
        tloss.append(float(tmet["loss"]))
    return dict(jstate=jax.device_get(jstate), tstate=tstate, jx0=jx0,
                jloss=jloss, tloss=tloss, control=control, before=before,
                in_place=same_obj and ptrs == _ptrs(tstate))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_two_rounds_match_reference(arch, dtype):
    """Two whole rounds: the losses, x-hat's share bit-equal, x's change
    and the momentum in L2 within the stated bounds (the control beyond
    them); the state updated in place."""
    out = _rounds(arch, dtype)
    bf16 = dtype == "bfloat16"
    if bf16:
        np.testing.assert_allclose(out["tloss"], out["jloss"], rtol=0,
                                   atol=BF16_SGD_LOSS_ATOL)
    else:
        np.testing.assert_allclose(out["tloss"], out["jloss"],
                                   rtol=LOSS_RTOL)
    bound = BF16_STATE_L2_RTOL if bf16 else STATE_L2_RTOL
    js, ts = out["jstate"], out["tstate"]
    assert ts.t == int(js.t) == 2 and out["in_place"]
    jh, th = _flat_bits(js.hidden), _flat_bits(ts.hidden)
    share = float(np.mean(jh.view(np.int32) == th.view(np.int32)))
    print(f"{arch} {dtype}: x-hat bit-equal after 2 rounds: {share:.6f}")
    assert share >= HIDDEN_EQUAL_FLOOR
    for name, base in (("x", out["jx0"]), ("momentum", 0.0)):
        a = _flat_bits(getattr(js, name)) - base
        for tree, what in ((ts, "port"), (out["control"], "control")):
            b = _flat_bits(getattr(tree, name)) - base
            rel = float(np.linalg.norm(b.astype(np.float64) - a)
                        / np.linalg.norm(a))
            print(f"{arch} {dtype}: {name} after 2 rounds, {what} L2 "
                  f"error {rel:.3e}")
            assert (rel <= bound) == (what == "port"), (name, what, rel)
    before = out["before"]
    assert before.t == 0 and np.array_equal(_flat_bits(before.x),
                                            out["jx0"])
    assert [t.dtype for t in tree_leaves(before.x)] == [
        t.dtype for t in tree_leaves(ts.x)]
    assert len(_mixed(ts)) == (len(_mixed(before)) if bf16 else 0)
    sides = _mixed(ts)
    assert all(sd.x.dtype == torch.float32 for sd in sides)
    assert not sides or any(bool((sd.m != 0).any()) for sd in sides)
