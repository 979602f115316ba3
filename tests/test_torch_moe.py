"""The MoE layer and the MoE decoders in the port (repro_torch.models.moe,
models.transformer) against the JAX package's, on the CPU, at the reduced
configs of qwen3-moe-235b-a22b (softmax router, qk-norm) and
deepseek-v3-671b (sigmoid router, a shared expert, ``routed_scaling``
2.5, MLA, a dense prefix layer, the MTP head), f32, with the reference's
parameters carried across by ``convert.params_from_jax``.

Exact: the routing ids wherever the k-th and the (k+1)-th score differ by
more than ``TIE_MARGIN`` (and at exact ties, where both take the lower
index); the kept sets of the capacity dispatch, at the reduced configs'
factor 2.0 (no drops) and at 1.0 and 0.5 (copies dropped); the combine in
bf16, bit for bit against the reference's scatter-add run jitted and
eagerly (each add rounded to bf16 in ascending expert within a token, as
XLA:CPU's optimised HLO spells it: ``bf16(f32(a) + f32(b))`` over the
updates in sorted order); the expert groups against one group.

Within ``ROUTE_ATOL``: gates, probs and the aux loss. Within the bounds of
tests/test_torch_archs.py: ``moe_forward``'s output and gradients, and the
whole model's hidden states, loss (the routers' aux and the MTP term in
it) and every leaf's gradient against the jitted reference.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import moe as JM
from repro.models import transformer as JT
from repro_torch import configs as TC
from repro_torch.common.tree import tree_leaves
from repro_torch.convert import params_from_jax
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from test_torch_archs import (FWD_RTOL, GRAD_RTOL, LOSS_ATOL, close,
                              one_thread)  # noqa: F401

ARCHS = ("qwen3-moe-235b-a22b", "deepseek-v3-671b")
ROUTE_ATOL = 1e-6
TIE_MARGIN = 1e-6
# leaves the reference initialises to zeros or ones: moved off their init
PERTURBED = ("q_norm", "k_norm", "ln1", "ln2", "final_norm", "q_a_norm",
             "kv_a_norm", "mtp_norm")
B, SEQ = 2, 32


@functools.lru_cache(maxsize=None)
def moe_model(arch: str, seed: int = 0) -> dict:
    """The reduced config in both packages (f32), the reference's
    parameters with every norm scale moved off its init, and a (B, SEQ)
    batch of both; made once per (arch, seed) in a process, as no test
    changes them."""
    from repro_torch.data.synthetic import synthetic_batch_for_config

    jc, tc = JC.get_reduced(arch), TC.get_reduced(arch)
    rng = np.random.default_rng(seed + 1)

    def perturb(path, a):
        if path[-1].key not in PERTURBED:
            return a
        return a + jnp.asarray(0.1 * rng.standard_normal(a.shape), a.dtype)

    jp = jax.tree_util.tree_map_with_path(perturb, jax.jit(
        JT.init_params, static_argnums=0)(jc, jax.random.PRNGKey(seed)))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    b = synthetic_batch_for_config(tc, np.random.default_rng(seed), B, SEQ)
    return dict(jc=jc, tc=tc, jp=jp, tp=tp,
                jb={k: jnp.asarray(v) for k, v in b.items()},
                tb={k: torch.from_numpy(v) for k, v in b.items()})


def _layer(arch: str, seed: int = 0):
    """One MoE layer's parameters in both packages and a (B, SEQ, D) input
    whose first 4 tokens are zero (every score equal: ties)."""
    jc, tc = JC.get_reduced(arch), TC.get_reduced(arch)
    jp = JM.init_moe(jax.random.PRNGKey(seed), jc)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    x = np.random.default_rng(seed).standard_normal(
        (B, SEQ, jc.d_model)).astype(np.float32)
    x[0, :4] = 0.0
    return jc, tc, jp, tp, x


def _reference_keep(ids: np.ndarray, e: int, cap: int) -> np.ndarray:
    """(T, k) bool: the reference's kept copies (``moe.py:72-83``: a
    stable sort of the token-major copies by expert, the first ``cap`` of
    each expert kept), from its ids."""
    flat = ids.reshape(-1)
    order = np.argsort(flat, kind="stable")
    sorted_e = flat[order]
    pos = np.arange(flat.size) - np.searchsorted(sorted_e, sorted_e, "left")
    keep = np.empty(flat.size, bool)
    keep[order] = pos < cap
    return keep.reshape(ids.shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_reference(arch):
    """``_route`` (softmax for qwen3-moe, sigmoid for deepseek): ids equal
    where the top-k is decided by more than ``TIE_MARGIN`` and at the
    exact ties of the zero tokens (the lower indices first, as
    ``jax.lax.top_k``); gates and probs within ``ROUTE_ATOL``."""
    jc, tc, jp, tp, x = _layer(arch)
    x2d = x.reshape(-1, jc.d_model)
    jg, ji, jpr = (np.asarray(a) for a in JM._route(
        jc, jp["router"], jnp.asarray(x2d)))
    tg, ti, tpr = TM._route(tc, tp["router"], torch.from_numpy(x2d))
    k = jc.experts_per_token
    # probs order the experts as the scores do (sigmoid: scores over
    # their positive row sum)
    srt = -np.sort(-jpr, axis=-1)
    decided = srt[:, k - 1] - srt[:, k] > TIE_MARGIN
    assert decided.mean() > 0.9
    assert np.array_equal(ti.numpy()[decided], ji[decided])
    assert np.array_equal(ji[:4], np.tile(np.arange(k), (4, 1)))
    assert np.array_equal(ti.numpy()[:4], ji[:4])
    assert np.abs(tg.numpy() - jg).max() <= ROUTE_ATOL
    assert np.abs(tpr.numpy() - jpr).max() <= ROUTE_ATOL


def test_top_k_is_jax_top_k_with_ties():
    """Rows of repeated values: the stable descending sort cut at k takes
    equal values in ascending index, as ``jax.lax.top_k``."""
    rng = np.random.default_rng(3)
    s = rng.integers(0, 4, (64, 16)).astype(np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(s), 5)
    tv, ti = TM.top_k(torch.from_numpy(s), 5)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf", [2.0, 1.0, 0.5])
def test_moe_forward_matches_reference(arch, cf):
    """``moe_forward`` at the reduced configs' factor 2.0 (nothing
    dropped) and at 1.0 and 0.5 (copies dropped): the kept sets equal the
    reference's, the output and the aux within ``FWD_RTOL`` and the
    gradients of every parameter and of x within ``GRAD_RTOL``."""
    jc, tc, jp, tp, x = _layer(arch, seed=1)
    t = B * SEQ
    cap = TM.capacity(tc, t, cf)
    _, ji, _ = JM._route(jc, jp["router"], jnp.asarray(x.reshape(t, -1)))
    want_keep = _reference_keep(np.asarray(ji), jc.n_experts, cap)
    _, ti, _ = TM._route(tc, tp["router"], torch.from_numpy(x.reshape(t, -1)))
    ids_s, perm = torch.sort(ti, dim=-1)
    keep = torch.gather(TM.dispatch(ids_s, tc.n_experts, cap)["keep"], -1,
                        torch.argsort(perm, dim=-1))
    assert np.array_equal(keep.numpy(), want_keep)
    assert (want_keep.mean() == 1.0) == (cf == 2.0), want_keep.mean()
    out, aux = TM.moe_forward(tc, tp, torch.from_numpy(x),
                              capacity_factor=cf)
    jo, ja = JM.moe_forward(jc, jp, jnp.asarray(x), capacity_factor=cf)
    close(out, jo, FWD_RTOL)
    assert abs(float(aux) - float(ja)) <= ROUTE_ATOL

    g = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
    def jloss(p, xx):
        o, a = JM.moe_forward(jc, p, xx, capacity_factor=cf)
        return jnp.sum(o * g) + a

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tloss = lambda p, xx: (lambda o: torch.sum(o[0] * torch.from_numpy(g))
                           + o[1])(TM.moe_forward(tc, p, xx,
                                                  capacity_factor=cf))
    tgp, tgx = torch.func.grad(tloss, argnums=(0, 1))(tp, torch.from_numpy(x))
    close(tgx, jgx, GRAD_RTOL)
    for a, b in zip(tree_leaves(tgp), jax.tree.leaves(jgp)):
        close(a, b, GRAD_RTOL)


def _reference_combine(ids, gates, ye, cap: int):
    """``repro/models/moe.py:75-96`` from the ids, gates and expert
    outputs on: the dispatch's slots, the kept rows and the scatter-add
    into a bf16 zero."""
    t, k = ids.shape
    e = ye.shape[0] // cap
    flat_e, flat_g = ids.reshape(-1), gates.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    sorted_tok = jnp.repeat(jnp.arange(t), k)[order]
    pos = jnp.arange(t * k) - jnp.searchsorted(sorted_e, sorted_e, "left")
    keep = pos < cap
    slot = jnp.where(keep, sorted_e * cap + pos, e * cap)
    y = jnp.where(keep[:, None], ye[jnp.minimum(slot, e * cap - 1)], 0.0)
    return jnp.zeros((t, ye.shape[1]), ye.dtype).at[sorted_tok].add(
        (y.astype(jnp.float32) * flat_g[order][:, None]).astype(ye.dtype))


def test_combine_bf16_order_bit_for_bit():
    """The combine in bf16 with copies dropped (96 tokens, top-4 of 8
    experts, 40 slots each): each token's gated copies added in ascending
    expert, each add rounded, bit for bit against the reference's lines
    jitted and eager; a sum in f32 rounded once, and the copies in their
    descending-score order, miss."""
    rng = np.random.default_rng(0)
    t, k, e, d, cap = 96, 4, 8, 64, 40
    ids = np.stack([rng.permutation(e)[:k] for _ in range(t)])
    gates = rng.random((t, k)).astype(np.float32)
    gates /= gates.sum(1, keepdims=True)
    ye = jnp.asarray(rng.standard_normal((e * cap, d)),
                     jnp.float32).astype(jnp.bfloat16)
    args = (jnp.asarray(ids), jnp.asarray(gates), ye)
    jitted = jax.jit(_reference_combine, static_argnums=3)(*args, cap)
    with jax.disable_jit():
        eager = _reference_combine(*args, cap)
    ids_s, perm = torch.sort(torch.from_numpy(ids), dim=-1)
    disp = TM.dispatch(ids_s, e, cap)
    assert 0 < int(disp["keep"].sum()) < t * k
    yt = params_from_jax(np.asarray(ye), device="cpu")
    y = torch.where(disp["keep"][..., None],
                    yt[torch.clamp(disp["slot"], max=e * cap - 1)], 0.0)
    g_s = torch.gather(torch.from_numpy(gates), -1, perm)
    got = TM.combine(y, g_s).float().numpy()
    f32 = lambda a: np.asarray(a.astype(jnp.float32))
    assert np.array_equal(got, f32(jitted))
    assert np.array_equal(got, f32(eager))
    once = (y.float() * g_s[..., None]).sum(1).to(torch.bfloat16).float()
    inv = torch.argsort(perm, dim=-1)[..., None].expand(-1, -1, d)
    by_score = TM.combine(torch.gather(y, 1, inv),
                          torch.from_numpy(gates)).float()
    for control in (once, by_score):
        assert np.mean(control.numpy() == f32(jitted)) < 0.9


@pytest.mark.parametrize("arch", ARCHS)
def test_expert_groups_change_no_value(arch, monkeypatch):
    """The experts run in groups under a small ``EXPERT_GROUP_BYTES``
    (one, two or three experts a group): output, aux and gradients equal
    the one-group run bit for bit."""
    _, tc, _, tp, x = _layer(arch, seed=2)
    xt = torch.from_numpy(x).requires_grad_(True)

    def run():
        out, aux = TM.moe_forward(tc, tp, xt, capacity_factor=1.0)
        (gx,) = torch.autograd.grad(out.sum() + aux, xt)
        return out.detach(), aux.detach(), gx

    whole = run()
    cap = TM.capacity(tc, B * SEQ, 1.0)
    for experts in (1, 2, 3):
        monkeypatch.setattr(TM, "EXPERT_GROUP_BYTES",
                            experts * cap * tc.d_model * 4)
        for a, b in zip(run(), whole):
            assert torch.equal(a, b), experts


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_gradients_match_jitted_reference(arch):
    """The whole reduced model from the perturbed weights (deepseek: its
    dense prefix layer, MLA, the MTP term): the hidden states, the aux
    summed over the MoE layers, the loss and every leaf's gradient against
    the jitted reference (the eager reference's gradient takes half a
    minute here; ``moe_forward`` is held to the eager one above)."""
    m = moe_model(arch)
    jc, tc, jp, tp, jb, tb = (m[k] for k in ("jc", "tc", "jp", "tp", "jb",
                                             "tb"))
    got, aux = TT.forward(tc, tp, tb, remat=False)
    jitted, jaux = jax.jit(lambda p, b: JT.forward(jc, p, b, remat=False))(
        jp, jb)
    close(got, jitted, FWD_RTOL)
    assert abs(float(aux) - float(jaux)) <= 2 * ROUTE_ATOL

    tloss = lambda p: TT.loss_fn(tc, p, tb, remat=False)[0]
    jloss = lambda p: JT.loss_fn(jc, p, jb, remat=False)[0]
    jl, jg = jax.jit(jax.value_and_grad(jloss))(jp)
    tl = float(tloss(tp))
    assert abs(tl - float(jl)) <= LOSS_ATOL
    # remat gives the same loss
    assert float(TT.loss_fn(tc, tp, tb, remat=True)[0]) == tl
    tg = tree_leaves(torch.func.grad(tloss)(tp))
    names = [p[-1].key for p, _ in jax.tree_util.tree_leaves_with_path(jg)]
    ref = jax.tree.leaves(jg)
    assert len(ref) == len(tg)
    for a, b in zip(tg, ref):
        close(a, b, GRAD_RTOL)
    # every router, expert bank and (deepseek) MLA, prefix and MTP leaf
    # reaches the loss
    for name in ("router", "w_gate", "w_down") + (
            ("wq_a", "wkv_a", "wk_b", "q_a_norm", "mtp_norm")
            if tc.use_mla else ("q_norm",)):
        grads = [g for n, g in zip(names, tg) if n == name]
        assert grads and all(float(g.abs().max()) > 0 for g in grads), name


@pytest.mark.parametrize("arch", ARCHS)
def test_ep_impl_raises_naming_13b(arch):
    """``moe_impl="ep"`` (expert parallelism) raises naming ROADMAP item
    13b, through the model and through the module."""
    cfg = TC.get_reduced(arch).replace(moe_impl="ep")
    params = TT.init_params(cfg, 0, device="cpu")
    tokens = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match=r"13b"):
        TT.forward(cfg, params, {"tokens": tokens})
    with pytest.raises(NotImplementedError, match=r"13b"):
        TM.set_ep_mesh(None)
