"""Mamba2 and the hybrid in the port (models.mamba2, the mamba and
attn_shared positions of models.transformer) against the JAX package's,
on the CPU: mamba2-1.3b (48 mamba layers) and zamba2-7b (mamba, mamba and
one attention block shared by every super-block), at their reduced
configs (f32) with the reference's parameters carried across by
``convert.params_from_jax``.

The reference initialises ``D``, every norm scale and the conv bias to
ones or zeros, where a missing skip, scale or bias changes nothing;
``model`` moves each of those leaves off its init with seeded numpy
values first.

Exact: the published configs' ``param_count`` and parameter layouts
(leaf order, shapes and the mixed dtypes: ``A_log``, ``D`` and
``dt_bias`` f32 in a bf16 model; ``meta`` tensors against
``jax.eval_shape``), the reduced flat layouts.

Within a bound of the largest magnitude of the reference's values (the
two packages' products, reductions, ``cumsum`` and ``exp`` take other
orders; XLA:CPU's cumsum is blocked, ROADMAP queue C): the SSD scan
against the reference's and against the naive recurrence of
tests/test_attention_ssd.py (chunks 4, 8 and 32, a padded tail), the
causal conv, the block's forward with its cache and its decode step by
step; the whole stack's forward, loss and gradients against the eager
and the jitted reference (tests/test_torch_archs.py's bounds); prefill
and decode against the reference's jitted ones, and decode against the
forward (the reference's tests/test_decode_consistency.py bound).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.core.quantizers import flatten_tree as jflatten
from repro.models import mamba2 as JM
from repro.models import transformer as JT
from repro_torch import configs as TC
from repro_torch.common.tree import tree_leaves
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.core.quantizers import TreeLayout
from repro_torch.data.synthetic import synthetic_batch_for_config
from repro_torch.models import mamba2 as TM
from repro_torch.models import transformer as TT
from test_attention_ssd import naive_ssd
from test_torch_archs import (FWD_RTOL, GRAD_RTOL, LOSS_ATOL,  # noqa: F401
                              close, one_thread)

ARCHS = ("mamba2-1.3b", "zamba2-7b")
# the reference's ModelConfig.param_count of the published configs
PARAM_COUNT = {"mamba2-1.3b": 1_342_593_024, "zamba2-7b": 4_643_542_848}
# leaves the reference initialises to zeros or ones: moved off their init
PERTURBED = ("ln1", "ln2", "norm", "final_norm", "conv_b", "D")
SSD_RTOL = 1e-5       # the scan against the reference's (measured < 1e-6)
NAIVE_TOL = 2e-3      # against the naive recurrence: the reference's bound
SERVE_RTOL = 1e-5     # prefill and decode, as tests/test_torch_serve.py's
DECODE_VS_FORWARD = 2e-3  # the reference's own bound
B, SEQ, DECODE_STEPS = 2, 40, 4  # 40 = one chunk of 32 and a padded tail


def model(arch: str, seed: int = 0) -> dict:
    """The reduced config in both packages, the reference's parameters
    with every norm scale, ``D`` and the conv bias moved off their init,
    and a (B, SEQ) batch of both from the reference's numpy stream."""
    jc, tc = JC.get_reduced(arch), TC.get_reduced(arch)
    rng = np.random.default_rng(seed + 1)

    def perturb(path, a):
        if path[-1].key not in PERTURBED:
            return a
        return a + jnp.asarray(0.1 * rng.standard_normal(a.shape), a.dtype)

    jp = jax.tree_util.tree_map_with_path(
        perturb, jax.jit(lambda k: JT.init_params(jc, k))(
            jax.random.PRNGKey(seed)))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    b = synthetic_batch_for_config(tc, np.random.default_rng(seed), B, SEQ)
    return dict(jc=jc, tc=tc, jp=jp, tp=tp,
                jb={k: jnp.asarray(v) for k, v in b.items()},
                tb={k: torch.from_numpy(v) for k, v in b.items()})


def _pair(a):
    """A numpy array as (jax array, torch tensor)."""
    return jnp.asarray(a), torch.from_numpy(np.array(a))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_and_layout_match_reference(arch):
    """The published config's parameter count and tree (``meta`` tensors
    against the reference's ``abstract_params``: leaf order, shapes, the
    mixed dtypes), the reduced config's flat layout; the hybrid's one
    ``shared_block`` outside the stack and no stacked ``attn_shared``."""
    cfg = TC.get_config(arch)
    assert cfg.param_count() == JC.get_config(arch).param_count() \
        == PARAM_COUNT[arch]
    meta = TT.abstract_params(cfg)
    want = JT.abstract_params(JC.get_config(arch))
    assert jax.tree.structure(want) == jax.tree.structure(
        jax.tree.map(lambda t: 0, meta))
    f32 = 0
    for t, w in zip(tree_leaves(meta), jax.tree.leaves(want)):
        assert tuple(t.shape) == w.shape and t.device.type == "meta"
        assert str(t.dtype).split(".")[-1] == str(w.dtype)
        f32 += t.numel() if t.dtype == torch.float32 else 0
    heads, mamba_layers = cfg.ssm_nheads, cfg.n_layers * sum(
        k == "mamba" for k in cfg.layer_pattern) // cfg.pattern_len
    assert f32 == 3 * heads * mamba_layers  # A_log, D, dt_bias
    assert ("shared_block" in meta) == (arch == "zamba2-7b")
    assert not any("attn_shared" in k for k in meta["layers"])
    _, jl = jflatten(JT.init_params(JC.get_reduced(arch),
                                    jax.random.PRNGKey(0)))
    tl = TreeLayout.of(TT.init_params(TC.get_reduced(arch), 0,
                                      device="cpu"))
    assert tl.shapes == jl.shapes and tl.sizes == jl.sizes
    assert tl.dtypes == tuple(str(np.dtype(d)) for d in jl.dtypes)


def test_init_draws_the_reference_laws():
    """``init_mamba``'s f32 leaves in a bf16 config: ``A_log`` = log(1..H)
    exactly, ``D`` ones, softplus(``dt_bias``) inside [1e-3, 1e-1]; the
    stacked leaves differ between super-blocks."""
    cfg = TC.get_reduced("mamba2-1.3b").replace(param_dtype="bfloat16",
                                                dtype="bfloat16")
    p = TT.init_params(cfg, 3, device="cpu")["layers"]["pos0_mamba"]["mamba"]
    h = cfg.ssm_nheads
    assert p["in_proj"].dtype == p["conv_w"].dtype == torch.bfloat16
    assert p["A_log"].dtype == p["D"].dtype == p["dt_bias"].dtype \
        == torch.float32
    want = np.log(np.arange(1, h + 1, dtype=np.float64))
    np.testing.assert_allclose(p["A_log"][1].numpy(), want, rtol=1.2e-7)
    assert bool((p["D"] == 1).all())
    dt = np.log1p(np.exp(p["dt_bias"].numpy().astype(np.float64)))
    assert dt.min() >= 1e-3 * (1 - 1e-5) and dt.max() <= 1e-1 * (1 + 1e-5)
    assert not torch.equal(p["dt_bias"][0], p["dt_bias"][1])


def test_softplus_is_jax_softplus():
    """``logaddexp(x, 0)``, equal to ``jax.nn.softplus`` within an ulp
    over the range dt takes (torch's own formula differs below 20)."""
    x = np.linspace(-30, 30, 4001, dtype=np.float32)
    got = TM._softplus(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=2.4e-7, atol=0)


def _ssd_inputs(b, s, h, p, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(0.3 * rng.standard_normal(h)).astype(np.float32)
    bm = rng.standard_normal((b, s, 1, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, 1, n)).astype(np.float32)
    return x, dt, a, bm, cm


@pytest.mark.parametrize("chunk,s", [(4, 32), (8, 32), (32, 32), (16, 21)])
def test_ssd_chunked_matches_reference_and_naive(chunk, s):
    """The scan at chunks 4, 8 and 32, and with a padded tail (21 steps
    in chunks of 16): y and the final state against the reference's
    ``ssd_chunked`` within ``SSD_RTOL`` and the naive recurrence within
    its own bound; its gradient is finite (the masked exponent)."""
    cfg = TC.get_reduced("mamba2-1.3b").replace(ssm_chunk=chunk)
    args = _ssd_inputs(2, s, 4, 8, 16)
    jargs, targs = zip(*(_pair(a) for a in args))
    y, final = TM.ssd_chunked(cfg, *targs)
    jy, jfinal = JM.ssd_chunked(JC.get_reduced("mamba2-1.3b").replace(
        ssm_chunk=chunk), *jargs)
    assert y.shape == (2, s, 4, 8) and final.shape == (2, 4, 8, 16)
    close(y, jy, SSD_RTOL)
    close(final, jfinal, SSD_RTOL)
    ny, nfinal = naive_ssd(*args)
    np.testing.assert_allclose(y.numpy(), ny, rtol=NAIVE_TOL, atol=NAIVE_TOL)
    np.testing.assert_allclose(final.numpy(), nfinal, rtol=NAIVE_TOL,
                               atol=NAIVE_TOL)
    xs = targs[0].clone().requires_grad_()
    dts = targs[1].clone().requires_grad_()
    yg, fg = TM.ssd_chunked(cfg, xs, dts, *targs[2:])
    gx, gdt = torch.autograd.grad(yg.sum() + fg.sum(), (xs, dts))
    assert bool(torch.isfinite(gx).all() and torch.isfinite(gdt).all())


def test_block_train_cache_and_decode_match_reference():
    """One mamba block (the reduced mamba2-1.3b's first, perturbed): the
    causal conv, ``mamba_train`` with its cache (a prompt shorter than
    the conv's tail too, left-padded), then ``mamba_decode`` step by step
    from the reference's cache, each against the reference's."""
    m = model("mamba2-1.3b")
    jc, tc = m["jc"], m["tc"]
    jp = jax.tree.map(lambda a: a[0], m["jp"]["layers"]["pos0_mamba"]
                      ["mamba"])
    tp = {k: v[0] for k, v in m["tp"]["layers"]["pos0_mamba"]["mamba"]
          .items()}
    rng = np.random.default_rng(7)
    xin = rng.standard_normal((B, 12, tc.d_model)).astype(np.float32)
    jx, tx = _pair(xin)
    xbc = rng.standard_normal((B, 12, tp["conv_w"].shape[1])).astype(
        np.float32)
    close(TM._causal_conv(torch.from_numpy(xbc), tp["conv_w"],
                          tp["conv_b"]),
          jax.jit(JM._causal_conv)(jnp.asarray(xbc), jp["conv_w"],
                                   jp["conv_b"]),
          SSD_RTOL)
    jtrain = jax.jit(lambda p, x: JM.mamba_train(jc, p, x, return_cache=True))
    jdecode = jax.jit(lambda p, x, c: JM.mamba_decode(jc, p, x, c))
    for s in (9, 2):  # 2 < W - 1 = 3: the conv cache left-padded
        out, cache = TM.mamba_train(tc, tp, tx[:, :s], return_cache=True)
        jout, jcache = jtrain(jp, jx[:, :s])
        close(out, jout, FWD_RTOL)
        close(cache["ssm"], jcache["ssm"], SSD_RTOL)
        close(cache["conv"], jcache["conv"], FWD_RTOL)
    tcache = cache_from_jax(jax.device_get(jcache), device="cpu")
    for t in range(2, 6):
        out, same = TM.mamba_decode(tc, tp, tx[:, t:t + 1], tcache)
        jout, jcache = jdecode(jp, jx[:, t:t + 1], jcache)
        assert same is tcache
        close(out, jout, FWD_RTOL)
        close(tcache["ssm"], jcache["ssm"], SSD_RTOL)
        close(tcache["conv"], jcache["conv"], FWD_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_gradients_match_eager_and_jitted(arch):
    """The whole stack from the perturbed weights (a padded SSD tail at
    40 = 32 + 8 positions): the hidden states against the reference
    eager and jitted; the loss and every leaf's gradient (the shared
    block's the sum over its uses), taken with remat as the round takes
    them, against the reference's jitted ones."""
    m = model(arch)
    jc, tc, jp, tp, jb, tb = (m[k] for k in ("jc", "tc", "jp", "tp", "jb",
                                             "tb"))
    got, _ = TT.forward(tc, tp, tb, remat=False)
    eager, _ = JT.forward(jc, jp, jb, remat=False)
    jitted, _ = jax.jit(lambda p, b: JT.forward(jc, p, b, remat=False))(jp,
                                                                      jb)
    assert got.shape == (B, SEQ, tc.d_model)
    close(got, eager, FWD_RTOL)
    close(got, jitted, FWD_RTOL)

    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: JT.loss_fn(jc, p, jb, remat=False)[0]))(jp)
    leaves = [t.detach().requires_grad_() for t in tree_leaves(tp)]
    tree = jax.tree.unflatten(jax.tree.structure(jg), leaves)
    tl = TT.loss_fn(tc, tree, tb, remat=True)[0]
    assert abs(float(tl) - float(jl)) <= LOSS_ATOL
    tg = torch.autograd.grad(tl, leaves)
    assert len(tg) == len(jax.tree.leaves(jg))
    for a, b in zip(tg, jax.tree.leaves(jg)):
        close(a, b, GRAD_RTOL)


@pytest.mark.parametrize("arch,wo", [(a, None) for a in ARCHS]
                         + [("zamba2-7b", 16)])
def test_prefill_and_decode_match_reference(arch, wo):
    """The port's prefill against the reference's jitted one: the
    last-position logits and every cache leaf (mamba: the f32 SSM state
    and the conv tail; the shared block's keys, values and ``slot_pos``
    per use); then ``DECODE_STEPS`` steps of the port from the
    reference's own cache against its jitted decode, both fed the
    reference's greedy token, the tokens equal."""
    m = model(arch)
    jc, tc, jp, tp = m["jc"], m["tc"], m["jp"], m["tp"]
    max_len = SEQ + DECODE_STEPS
    jl, jcache = jax.jit(lambda p, i: JT.prefill(
        jc, p, i, max_len=max_len, window_override=wo))(
            jp, {"tokens": m["jb"]["tokens"]})
    tl, tcache = TT.prefill(tc, tp, {"tokens": m["tb"]["tokens"]},
                            max_len=max_len, window_override=wo)
    close(tl, jl, SERVE_RTOL)
    jcache = jax.device_get(jcache)
    assert jax.tree.structure(jcache) == jax.tree.structure(
        jax.tree.map(lambda t: 0, tcache))
    for a, b in zip(tree_leaves(tcache), jax.tree.leaves(jcache)):
        assert str(a.dtype).split(".")[-1] == str(b.dtype)
        if b.dtype == np.int32:
            assert np.array_equal(a.numpy(), b)
        else:
            close(a, b, SERVE_RTOL)
    jdec = jax.jit(lambda p, c, i, pos: JT.decode_step(
        jc, p, c, i, pos, window_override=wo))
    pc, jcc = cache_from_jax(jcache, device="cpu"), jcache
    tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
    for t in range(DECODE_STEPS):
        got, pc = TT.decode_step(tc, tp, pc, {"tokens": torch.from_numpy(
            tok[:, None])}, SEQ + t, window_override=wo)
        want, jcc = jdec(jp, jcc, {"tokens": jnp.asarray(tok[:, None])},
                         SEQ + t)
        close(got, want, SERVE_RTOL)
        nxt = np.asarray(jnp.argmax(want[:, -1], -1)).astype(np.int32)
        assert np.array_equal(torch.argmax(got[:, -1], -1).numpy(), nxt)
        tok = nxt


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """The reference's decode-consistency case on the port's own weights:
    prefill 32 tokens, decode 3, against the full forward's last
    logits."""
    cfg = TC.get_reduced(arch)
    params = TT.init_params(cfg, 0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, 35)).astype(np.int32))
    h, _ = TT.forward(cfg, params, {"tokens": toks}, remat=False)
    ref = TT.logits_fn(cfg, params, h[:, -1:])
    logits, cache = TT.prefill(cfg, params, {"tokens": toks[:, :32]},
                               max_len=40)
    for t in range(32, 35):
        logits, cache = TT.decode_step(cfg, params, cache,
                                       {"tokens": toks[:, t:t + 1]}, t)
    assert float((logits - ref).abs().max()) < DECODE_VS_FORWARD


def test_cache_is_constant_in_the_prompt_length():
    """A mamba cache holds B * (H * P * N * 4 + (W - 1) * C * act bytes)
    a layer whatever the prompt: ``init_cache`` at lengths 8 and 4,096,
    the abstract (``meta``) cache of the published mamba2-1.3b."""
    cfg = TC.get_config("mamba2-1.3b")
    conv = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    want = cfg.n_layers * 4 * (cfg.ssm_nheads * cfg.ssm_headdim
                               * cfg.ssm_state * 4 + 3 * conv * 2)
    for max_len in (8, 4096):
        cache = TT.abstract_cache(cfg, 4, max_len)
        got = sum(t.numel() * t.element_size() for t in tree_leaves(cache))
        assert got == want
    red = TC.get_reduced("mamba2-1.3b")
    small = TT.init_cache(red, 2, 8, device="cpu")["layers"]["pos0_mamba"]
    assert small["ssm"].dtype == torch.float32
    assert tuple(small["conv"].shape) == (red.n_super_blocks, 2, 3,
                                          red.d_inner + 2 * red.ssm_state)
