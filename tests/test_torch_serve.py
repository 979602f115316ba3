"""Serving on the dense decoder (repro_torch.models.attention's KV caches
and ``attention_decode``, repro_torch.models.transformer's ``init_cache``,
``prefill`` and ``decode_step``, distributed.steps' prefill and decode
steps, ``convert.cache_from_jax``, ``repro_torch.launch.serve`` and
``repro_torch.examples.serve_model``) against the JAX package's, on the
CPU, at ``get_reduced("gemma2-2b")`` (2 layers, window 128) with the
reference's parameters carried across by ``convert.params_from_jax``.

Exact: ``slot_pos`` of every cache (the ring law, the wrap inside
prefill), the caches' shapes and dtypes (``init_cache``,
``abstract_cache``; the full config's cache bytes by count), greedy
tokens.

Within a tolerance, relative to the largest magnitude of the reference's
values (f32 model math, the two packages' products and reductions take
other orders; measured below 3e-6): the prefill's logits and caches, and
every decode step's logits from the reference's own prefill cache
(``SERVE_RTOL``). Decode against the full-sequence forward, the
reference's own test (``tests/test_decode_consistency.py``) on the port:
below ``DECODE_VS_FORWARD`` (its 2e-3). In bf16, ``attention_decode``
against the reference run op by op (``jax.disable_jit``), with an f32
control that misses the bound; the 2-layer stack's decode from the
reference's cache within the bounds stated beside them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import attention as JA
from repro.models import transformer as JT
from repro_torch import configs as TC
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.data.synthetic import synthetic_lm_batch
from repro_torch.distributed import steps as TS
from repro_torch.examples import serve_model
from repro_torch.launch import serve as launch_serve
from repro_torch.models import attention as TA
from repro_torch.models import transformer as TT


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The module's tests on one torch thread, restored after: the suite
    runs six workers on the CPU's cores, where a pool of threads per
    worker spends its time waiting on the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SERVE_RTOL = 1e-5         # prefill / decode logits and caches (<= 2.7e-6)
DECODE_VS_FORWARD = 2e-3  # the reference's own bound
FLIP_MARGIN = 1e-4        # a top-2 margin under this may flip a token
B, DECODE_STEPS = 2, 8
# bf16, against the reference run op by op: attention_decode's outputs
# equal bit for bit (measured 1.0 without and with a window; the f32
# control 0.49 and 0.39)
BF16_DECODE_EQUAL = 0.999
# the 2-layer stack's decode step from the reference's cache: logits equal
# on 0.963 of the values, L1 8.7e-5 relative
BF16_STACK_EQUAL = 0.9
BF16_STACK_L1 = 5e-4


def _np32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(a, np.float32)


def _rel(got, want) -> float:
    got, want = _np32(got).astype(np.float64), _np32(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / (np.abs(want).max() or 1.0))


def _model(dtype="float32"):
    jc = JC.get_reduced("gemma2-2b").replace(param_dtype=dtype, dtype=dtype)
    tc = TC.get_reduced("gemma2-2b").replace(param_dtype=dtype, dtype=dtype)
    jp = JT.init_params(jc, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jc, tc, jp, tp


@pytest.fixture(scope="module")
def model():
    return _model()


def _tokens(seed: int, s: int, vocab: int) -> np.ndarray:
    return synthetic_lm_batch(np.random.default_rng(seed), B, s, vocab)[
        "tokens"]


# (prompt length, window_override): a prompt of 140 > the local layers'
# 128-slot ring wraps it inside prefill
CASES = [(32, None), (32, 16), (140, None)]


@pytest.mark.parametrize("s,wo", CASES)
def test_prefill_and_decode_match_reference(model, s, wo):
    """The port's prefill against the reference's jitted one (logits,
    every cache leaf, ``slot_pos`` exactly), then 8 decode steps of the
    port from the reference's own prefill cache (``cache_from_jax``)
    against the reference's jitted decode, both fed the reference's greedy
    token: per-step logits within ``SERVE_RTOL`` and the greedy tokens
    equal wherever the top-2 margin is at least ``FLIP_MARGIN``."""
    jc, tc, jp, tp = model
    toks = _tokens(s, s + DECODE_STEPS, jc.vocab)
    max_len = s + DECODE_STEPS
    jl, jcache = jax.jit(lambda p, i: JT.prefill(
        jc, p, i, max_len=max_len, window_override=wo))(
            jp, {"tokens": jnp.asarray(toks[:, :s])})
    tl, tcache = TT.prefill(tc, tp, {"tokens": torch.from_numpy(toks[:, :s])},
                            max_len=max_len, window_override=wo)
    assert tl.shape == (B, 1, jc.vocab)
    assert _rel(tl, jl) <= SERVE_RTOL
    jcache = jax.device_get(jcache)
    assert set(tcache["layers"]) == set(jcache["layers"])
    for key, jlc in jcache["layers"].items():
        tlc = tcache["layers"][key]
        for name in ("k", "v"):
            assert _rel(tlc[name], jlc[name]) <= SERVE_RTOL, (key, name)
        assert np.array_equal(tlc["slot_pos"].numpy(), jlc["slot_pos"])
    if s > jc.sliding_window:  # the local ring wrapped: the last w positions
        sp = tcache["layers"]["pos0_local"]["slot_pos"][0]
        w = sp.shape[0]
        want = np.arange(s - w, s)
        assert np.array_equal(np.sort(sp.numpy()), want)
        assert all(int(sp[p % w]) == p for p in want)

    jdec = jax.jit(lambda p, c, i, pos: JT.decode_step(
        jc, p, c, i, pos, window_override=wo))
    pc = cache_from_jax(jcache, device="cpu")
    jcc = jcache
    tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
    flips = 0
    for t in range(DECODE_STEPS):
        jl2, jcc = jdec(jp, jcc, {"tokens": jnp.asarray(tok[:, None])},
                        jnp.int32(s + t))
        tl2, pc = TT.decode_step(tc, tp, pc,
                                 {"tokens": torch.from_numpy(tok[:, None])},
                                 s + t, window_override=wo)
        assert _rel(tl2, jl2) <= SERVE_RTOL, t
        ja, ta = np.asarray(jl2[:, -1]), tl2[:, -1].numpy()
        top2 = np.sort(ja, axis=-1)[:, -2:]
        same = ja.argmax(-1) == ta.argmax(-1)
        flips += int((~same).sum())
        assert np.all(same | (top2[:, 1] - top2[:, 0] < FLIP_MARGIN)), t
        tok = ja.argmax(-1).astype(np.int32)  # both go on from the reference
    print(f"prompt {s}, window_override {wo}: {flips} greedy flips")
    jcc = jax.device_get(jcc)
    for key, jlc in jcc["layers"].items():
        assert np.array_equal(pc["layers"][key]["slot_pos"].numpy(),
                              jlc["slot_pos"])


def _roll(cfg, params, toks, s, extra, wo):
    """Prefill s tokens, decode ``extra`` more, and the full forward's
    logits at the last position (tests/test_decode_consistency.py)."""
    h, _ = TT.forward(cfg, params, {"tokens": toks[:, :s + extra]},
                      remat=False, window_override=wo)
    want = TT.logits_fn(cfg, params, h[:, -1:])
    logits, cache = TT.prefill(cfg, params, {"tokens": toks[:, :s]},
                               max_len=s + 8, window_override=wo)
    for t in range(s, s + extra):
        logits, cache = TT.decode_step(cfg, params, cache,
                                       {"tokens": toks[:, t:t + 1]}, t,
                                       window_override=wo)
    return float((logits - want).abs().max())


@pytest.mark.parametrize("s,extra,wo", [(32, 3, None), (32, 3, 16),
                                        (140, 4, None)])
def test_decode_matches_forward(s, extra, wo):
    """The reference's decode-consistency cases the port has (gemma2-2b,
    with and without ``window_override=16``) on the port's own weights,
    and a prompt that wraps the local ring inside prefill."""
    cfg = TC.get_reduced("gemma2-2b")
    params = TT.init_params(cfg, 0, device="cpu")
    toks = torch.from_numpy(_tokens(1, s + extra, cfg.vocab))
    assert _roll(cfg, params, toks, s, extra, wo) < DECODE_VS_FORWARD


@pytest.mark.parametrize("window", [None, 16])
def test_attention_decode_bf16_op_by_op(window):
    """bf16 ``attention_decode`` against the reference run op by op, from
    the same cache (a ring of 16 slots with a window): outputs, the cache
    written and ``slot_pos``; the f32 control (the port's f32 attention on
    the same values, rounded at the end) misses the bound."""
    jc, tc, jp, tp = _model("bfloat16")
    ja = jax.tree.map(lambda a: a[0], jp["layers"]["pos0_local"]["attn"])
    ta = {k: v[0] for k, v in tp["layers"]["pos0_local"]["attn"].items()}
    rng = np.random.default_rng(3)
    s, pos = 40, 30
    w = JA.init_attn_cache(jc, B, s, window)["k"].shape[1]
    spos = np.array([pos - 1 - ((pos - 1 - i) % w) if window else
                     (i if i < pos else -1) for i in range(w)], np.int32)
    shape = (B, w, jc.n_kv_heads, jc.hd)
    jcache = {"k": jnp.asarray(rng.standard_normal(shape), jnp.bfloat16),
              "v": jnp.asarray(rng.standard_normal(shape), jnp.bfloat16),
              "slot_pos": jnp.asarray(spos)}
    x = jnp.asarray(rng.standard_normal((B, 1, jc.d_model)), jnp.bfloat16)
    with jax.disable_jit():
        jo, jnew = JA.attention_decode(jc, ja, x, jcache, jnp.int32(pos),
                                       window=window)
    xt = params_from_jax(np.asarray(x), device="cpu")
    tcache = cache_from_jax(jax.device_get(jcache), device="cpu")
    to, tnew = TA.attention_decode(tc, ta, xt, tcache, pos, window=window)
    assert tnew is tcache and to.dtype == torch.bfloat16
    share = float(np.mean(_np32(to) == _np32(jo)))
    for name in ("k", "v"):
        assert np.array_equal(_np32(tnew[name]), _np32(jnew[name]))
    assert np.array_equal(tnew["slot_pos"].numpy(), np.asarray(
        jnew["slot_pos"]))
    c32 = {k: v.float() if v.dtype == torch.bfloat16 else v
           for k, v in cache_from_jax(jax.device_get(jcache),
                                      device="cpu").items()}
    co, _ = TA.attention_decode(TC.get_reduced("gemma2-2b"),
                                {k: v.float() for k, v in ta.items()},
                                xt.float(), c32, pos, window=window)
    control = float(np.mean(_np32(co.to(torch.bfloat16)) == _np32(jo)))
    print(f"bf16 attention_decode (window {window}): {share:.4f} equal; "
          f"control {control:.4f}")
    assert share >= BF16_DECODE_EQUAL > control


def test_bf16_stack_decode_from_reference_cache():
    """The 2-layer bf16 stack: one decode step of the port from the
    reference's op-by-op prefill cache against the reference's op-by-op
    decode step."""
    jc, tc, jp, tp = _model("bfloat16")
    s = 24
    toks = _tokens(1, s + 1, jc.vocab)
    with jax.disable_jit():
        _, jcache = JT.prefill(jc, jp, {"tokens": jnp.asarray(toks[:, :s])},
                               max_len=s + 4)
        jl, _ = JT.decode_step(jc, jp, jcache,
                               {"tokens": jnp.asarray(toks[:, s:s + 1])},
                               jnp.int32(s))
    pc = cache_from_jax(jax.device_get(jcache), device="cpu")
    assert pc["layers"]["pos0_local"]["k"].dtype == torch.bfloat16
    assert pc["layers"]["pos0_local"]["slot_pos"].dtype == torch.int32
    tl, _ = TT.decode_step(tc, tp, pc, {"tokens": torch.from_numpy(
        toks[:, s:s + 1])}, s)
    got, want = _np32(tl), _np32(jl)
    share = float(np.mean(got == want))
    l1 = float(np.abs(got - want).sum() / np.abs(want).sum())
    print(f"bf16 stack decode: {share:.4f} equal, L1 {l1:.3e}")
    assert share >= BF16_STACK_EQUAL and l1 <= BF16_STACK_L1


@pytest.mark.parametrize("wo", [None, 16])
def test_init_cache_matches_reference(wo):
    """``init_cache`` (zeros, ``slot_pos`` -1, stacked over the
    super-blocks) and ``abstract_cache`` (``meta`` tensors) against the
    reference's ``init_cache`` and ``abstract_cache``."""
    jc, tc = JC.get_reduced("gemma2-2b"), TC.get_reduced("gemma2-2b")
    want = jax.device_get(JT.init_cache(jc, B, 200, wo))
    abstract = JT.abstract_cache(jc, B, 200, wo)
    got = TT.init_cache(tc, B, 200, wo, device="cpu")
    meta = TT.abstract_cache(tc, B, 200, wo)
    assert jax.tree.structure(want) == jax.tree.structure(
        tree_map(lambda t: 0, got))
    for g, m, w, a in zip(tree_leaves(got), tree_leaves(meta),
                          jax.tree.leaves(want), jax.tree.leaves(abstract)):
        assert tuple(g.shape) == w.shape == tuple(m.shape) == a.shape
        assert str(g.dtype).split(".")[-1] == str(w.dtype) == str(
            m.dtype).split(".")[-1]
        assert m.device.type == "meta"
        assert np.array_equal(_np32(g), np.asarray(w, np.float32))


def test_full_config_cache_bytes_by_count():
    """gemma2-2b at its published 26 layers, counted on ``meta`` tensors:
    k and v are 26 * 2 * B * w * 4 heads * 256 * 2 B; the serving phases'
    two shapes (B = 4 at 64 + 32 positions; B = 1 at 4,160 + 64, where the
    13 local layers keep 4,096 slots and the 13 global 4,224)."""
    cfg = TC.get_config("gemma2-2b")

    def kv_bytes(cache):
        return sum(t.numel() * t.element_size() for lc in
                   cache["layers"].values() for n, t in lc.items()
                   if n in ("k", "v"))

    assert kv_bytes(TT.abstract_cache(cfg, 4, 96)) == 40_894_464
    long = TT.abstract_cache(cfg, 1, 4224)
    assert kv_bytes(long) == 443_023_360
    assert long["layers"]["pos0_local"]["k"].shape == (13, 1, 4096, 4, 256)
    assert long["layers"]["pos1_global"]["k"].shape == (13, 1, 4224, 4, 256)
    assert sum(t.numel() * t.element_size() for t in tree_leaves(long)) \
        == 443_023_360 + 4 * 13 * (4096 + 4224)  # and slot_pos, int32


def test_ring_slot_law():
    assert [TA.ring_slot(p, 4, 4) for p in range(9)] == [0, 1, 2, 3, 0, 1,
                                                          2, 3, 0]
    assert [TA.ring_slot(p, 4, None) for p in range(6)] == [0, 1, 2, 3, 3,
                                                             3]


def test_prefill_into_cache_matches_reference():
    jc, tc = JC.get_reduced("gemma2-2b"), TC.get_reduced("gemma2-2b")
    rng = np.random.default_rng(2)
    k = rng.standard_normal((B, 5, jc.n_kv_heads, jc.hd)).astype(np.float32)
    v = rng.standard_normal(k.shape).astype(np.float32)
    want = jax.device_get(JA.prefill_into_cache(
        JA.init_attn_cache(jc, B, 12), jnp.asarray(k), jnp.asarray(v), 3))
    cache = TA.init_attn_cache(tc, B, 12, device="cpu")
    got = TA.prefill_into_cache(cache, torch.from_numpy(k),
                                torch.from_numpy(v), 3)
    assert got is cache
    for name in ("k", "v", "slot_pos"):
        assert np.array_equal(_np32(got[name]),
                              np.asarray(want[name], np.float32))


def test_prefill_and_decode_steps_are_the_model_functions(model):
    jc, tc, jp, tp = model
    toks = torch.from_numpy(_tokens(4, 33, jc.vocab))
    step = TS.make_prefill_step(tc, max_len=40, window_override=16)
    dec = TS.make_decode_step(tc, window_override=16)
    a, ca = step(tp, {"tokens": toks[:, :32]})
    b, cb = TT.prefill(tc, tp, {"tokens": toks[:, :32]}, max_len=40,
                       window_override=16)
    assert torch.equal(a, b)
    a, _ = dec(tp, ca, {"tokens": toks[:, 32:]}, 32)
    b, _ = TT.decode_step(tc, tp, cb, {"tokens": toks[:, 32:]}, 32,
                          window_override=16)
    assert torch.equal(a, b)


def test_serve_launcher_runs_on_cpu(capsys):
    out = launch_serve.main(["--arch", "gemma2-2b", "--reduced", "--device",
                             "cpu", "--batch", "2", "--prompt-len", "16",
                             "--decode-steps", "5"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3
    assert lines[0].startswith("prefill[2x16] logits=(2, 1, 512)")
    assert lines[1].startswith("decode 5 steps:") and "tok/s" in lines[1]
    assert lines[2].startswith("sample tokens: [")
    assert out["tokens"].shape == (2, 6) and out["tokens"].dtype == \
        torch.int32
    # the greedy tokens are each step's argmax
    assert torch.equal(out["tokens"][:, -1],
                       out["last_logits"][:, -1].argmax(-1).to(torch.int32))


def test_serve_model_example_runs_on_cpu(capsys):
    """The example at its default architecture, the reference's
    (mamba2-1.3b), and gemma2-2b with a windowed cache."""
    out = serve_model.main(["--device", "cpu", "--decode-steps", "4"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3 and out["tokens"].shape == (2, 5)
    assert lines[0].startswith("mamba2-1.3b-reduced: prefill 2x48 -> "
                               "logits (2, 1, 512)")
    out = serve_model.main(["--arch", "gemma2-2b", "--device", "cpu",
                            "--decode-steps", "4", "--window", "16"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3
    assert lines[0].startswith("gemma2-2b-reduced: prefill 2x48 -> logits "
                               "(2, 1, 512)")
    assert lines[1].startswith("decoded 4 steps in")
    assert lines[2].startswith("sample stream: [")
    assert out["tokens"].shape == (2, 5)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "qwen3-moe-235b-a22b",
                                  "deepseek-v3-671b"])
def test_serving_other_architectures_raises_naming_the_item(arch):
    """Once refused, now ported: mamba2-1.3b (item 14c.3) and the MoE
    configs (item 14c.4; deepseek's MLA latents and prefix cache) serve
    their reduced configs through both entry points; the expert-parallel
    MoE (``moe_impl="ep"``) raises naming item 13b."""
    out = launch_serve.main(["--arch", arch, "--reduced", "--device",
                             "cpu", "--decode-steps", "2"])
    assert out["tokens"].shape == (4, 3)
    names = set(out["cache"]["layers"]["pos0_" + (
        "mamba" if arch.startswith("mamba") else "attn")])
    assert names == ({"ssm", "conv"} if arch.startswith("mamba") else
                     {"ckv", "k_rope", "slot_pos"} if arch.startswith("deep")
                     else {"k", "v", "slot_pos"})
    assert ("prefix" in out["cache"]) == arch.startswith("deep")
    out = serve_model.main(["--arch", arch, "--device", "cpu",
                            "--decode-steps", "2"])
    assert out["tokens"].shape == (2, 3)
    if arch.startswith("mamba"):
        return
    cfg = TC.get_reduced(arch).replace(moe_impl="ep")
    params = TT.init_params(cfg, 0, device="cpu")
    with pytest.raises(NotImplementedError, match=r"13b"):
        TT.prefill(cfg, params, {"tokens": torch.zeros((1, 4),
                                                       dtype=torch.int32)})


def test_serving_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_serve.main(["--arch", "gemma2-2b", "--reduced"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_model.main([])
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.init_cache(TC.get_reduced("gemma2-2b"), 1, 8)
