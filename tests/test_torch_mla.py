"""Multi-head latent attention and serving the MoE decoders in the port
(repro_torch.models.mla, models.transformer's ``prefill`` and
``decode_step`` with MLA's latent cache, deepseek's dense prefix layer
and ``"prefix"`` cache, the MoE layers at their decode capacity;
``launch.serve``, ``examples.serve_model`` and, beside them,
``launch.train``) against the JAX package's,
on the CPU, at the reduced configs (f32) with the reference's perturbed
parameters (tests/test_torch_moe.py).

Exact: every cache's ``slot_pos``. Within ``SERVE_RTOL`` of the largest
magnitude of the reference's values: ``mla_train``'s output and
gradients, the latents written by ``mla_prefill_cache``, each absorbed
``mla_decode`` step from the reference's cache (``window_override`` None
and 16, a ring of 16 slots wrapped), the whole model's prefill logits and
caches (the prefix's included) and each decode step of the port from the
reference's own prefill cache (``cache_from_jax``). Decode against the
full-sequence forward on the port's own weights, at the reduced configs'
no-drop decode capacity: below the reference's ``DECODE_VS_FORWARD``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import mla as JMLA
from repro.models import transformer as JT
from repro_torch import configs as TC
from repro_torch.common.tree import tree_leaves
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.examples import serve_model
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train
from repro_torch.models import mla as TMLA
from repro_torch.models import transformer as TT
from test_torch_archs import GRAD_RTOL, close, one_thread  # noqa: F401
from test_torch_moe import ARCHS, B, SEQ, moe_model

SERVE_RTOL = 1e-5         # the bound of tests/test_torch_serve.py
DECODE_VS_FORWARD = 2e-3  # the reference's own bound
DECODE_STEPS = 4
ARCH = "deepseek-v3-671b"


def _mla(seed: int = 0):
    """One MLA layer's parameters in both packages (the norm scales moved
    off their ones), an input (B, SEQ, D) and its positions."""
    jc, tc = JC.get_reduced(ARCH), TC.get_reduced(ARCH)
    rng = np.random.default_rng(seed)
    jp = JMLA.init_mla(jax.random.PRNGKey(seed), jc)
    jp = {k: v + jnp.asarray(0.1 * rng.standard_normal(v.shape), v.dtype)
          if k.endswith("norm") else v for k, v in jp.items()}
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    x = rng.standard_normal((B, SEQ, jc.d_model)).astype(np.float32)
    return jc, tc, jp, tp, x


@pytest.mark.parametrize("window", [None, 16])
def test_mla_train_matches_reference(window):
    """``mla_train`` (the latents expanded, blockwise attention over q of
    nope + rope and v of its own width, in blocks of 8) and its gradients
    against the reference's jitted ones; its latents with
    ``return_latents``."""
    jc, tc, jp, tp, x = _mla()
    pos = np.arange(SEQ, dtype=np.int32)
    jfn = lambda p, xx: JMLA.mla_train(jc, p, xx, jnp.asarray(pos),
                                       window=window, q_block=8, kv_block=8)
    tfn = lambda p, xx: TMLA.mla_train(tc, p, xx, torch.from_numpy(pos),
                                       window=window, q_block=8, kv_block=8)
    got, (ckv, kr) = TMLA.mla_train(tc, tp, torch.from_numpy(x),
                                    torch.from_numpy(pos), window=window,
                                    q_block=8, kv_block=8,
                                    return_latents=True)
    want, (jckv, jkr) = jax.jit(lambda p, xx: JMLA.mla_train(
        jc, p, xx, jnp.asarray(pos), window=window, q_block=8, kv_block=8,
        return_latents=True))(jp, jnp.asarray(x))
    for a, b in ((got, want), (ckv, jckv), (kr, jkr)):
        close(a, b, SERVE_RTOL)
    g = np.random.default_rng(1).standard_normal(x.shape).astype(np.float32)
    jg = jax.jit(jax.grad(lambda p, xx: jnp.sum(jfn(p, xx) * g),
                          argnums=(0, 1)))(jp, jnp.asarray(x))
    tg = torch.func.grad(lambda p, xx: torch.sum(tfn(p, xx)
                                                 * torch.from_numpy(g)),
                         argnums=(0, 1))(tp, torch.from_numpy(x))
    for a, b in zip(tree_leaves(tg[0]) + [tg[1]],
                    jax.tree.leaves(jg[0]) + [jg[1]]):
        close(a, b, GRAD_RTOL)


@pytest.mark.parametrize("window", [None, 16])
def test_mla_cache_and_absorbed_decode_match_reference(window):
    """``mla_prefill_cache`` into a cache of 24 slots (a ring of 16 with a
    window), then 12 absorbed ``mla_decode`` steps (past the ring's end)
    of the port from the reference's cache against the reference's jitted
    steps: outputs, latents and ``slot_pos``."""
    jc, tc, jp, tp, x = _mla(seed=2)
    n = 8
    pos = np.arange(n, dtype=np.int32)
    jcache = JMLA.mla_prefill_cache(
        jc, jp, jnp.asarray(x[:, :n]), jnp.asarray(pos),
        JMLA.init_mla_cache(jc, B, 24, window))
    tcache = TMLA.mla_prefill_cache(
        tc, tp, torch.from_numpy(x[:, :n]), torch.from_numpy(pos),
        TMLA.init_mla_cache(tc, B, 24, window))
    for name in ("ckv", "k_rope"):
        close(tcache[name], jcache[name], SERVE_RTOL)
    assert np.array_equal(tcache["slot_pos"].numpy(), jcache["slot_pos"])
    assert tcache["ckv"].shape == (B, 16 if window else 24, tc.kv_lora_rank)
    jdec = jax.jit(lambda p, c, xx, p0: JMLA.mla_decode(jc, p, xx[:, None], c,
                                                        p0, window=window))
    tc_cache = cache_from_jax(jax.device_get(jcache), device="cpu")
    for t in range(n, n + 12):
        jo, jcache = jdec(jp, jcache, jnp.asarray(x[:, t]), jnp.int32(t))
        to, tc_cache = TMLA.mla_decode(tc, tp, torch.from_numpy(x[:, t:t + 1]),
                                       tc_cache, t, window=window)
        close(to, jo, SERVE_RTOL)
        for name in ("ckv", "k_rope"):
            close(tc_cache[name], jcache[name], SERVE_RTOL)
        assert np.array_equal(tc_cache["slot_pos"].numpy(),
                              jcache["slot_pos"])


def _cache_entries(cache) -> dict:
    """{(entry, position): layer cache} over ``"layers"`` and
    ``"prefix"``."""
    out = {("layers", k): v for k, v in cache["layers"].items()}
    if "prefix" in cache:
        out[("prefix", "")] = cache["prefix"]
    return out


@pytest.mark.parametrize("arch,wo", [(a, None) for a in ARCHS]
                         + [(ARCH, 16)])
def test_prefill_and_decode_match_reference(arch, wo):
    """The port's prefill against the reference's jitted one (the prefix's
    cache included): last-position logits, every cache leaf, ``slot_pos``
    exactly; then ``DECODE_STEPS`` steps of the port from the reference's
    own cache against its jitted decode, both fed the reference's greedy
    token."""
    m = moe_model(arch)
    jc, tc, jp, tp = m["jc"], m["tc"], m["jp"], m["tp"]
    inputs, jin = {"tokens": m["tb"]["tokens"]}, {"tokens": m["jb"]["tokens"]}
    max_len = SEQ + DECODE_STEPS
    jl, jcache = jax.jit(lambda p, i: JT.prefill(
        jc, p, i, max_len=max_len, window_override=wo))(jp, jin)
    tl, tcache = TT.prefill(tc, tp, inputs, max_len=max_len,
                            window_override=wo)
    close(tl, jl, SERVE_RTOL)
    jcache = jax.device_get(jcache)
    assert set(tcache) == set(jcache) == ({"layers", "prefix"}
                                          if tc.n_dense_layers else
                                          {"layers"})
    names = ("ckv", "k_rope") if tc.use_mla else ("k", "v")
    jent = _cache_entries(jcache)
    for key, tlc in _cache_entries(tcache).items():
        assert set(tlc) == set(jent[key]) == set(names) | {"slot_pos"}
        for name in names:
            close(tlc[name], jent[key][name], SERVE_RTOL)
        assert np.array_equal(tlc["slot_pos"].numpy(),
                              jent[key]["slot_pos"])
    jdec = jax.jit(lambda p, c, i, pos: JT.decode_step(
        jc, p, c, i, pos, window_override=wo))
    pc, jcc = cache_from_jax(jcache, device="cpu"), jcache
    tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
    for t in range(DECODE_STEPS):
        jl2, jcc = jdec(jp, jcc, {"tokens": jnp.asarray(tok[:, None])},
                        jnp.int32(SEQ + t))
        tl2, pc = TT.decode_step(tc, tp, pc,
                                 {"tokens": torch.from_numpy(tok[:, None])},
                                 SEQ + t, window_override=wo)
        close(tl2, jl2, SERVE_RTOL)
        tok = np.asarray(jl2[:, -1]).argmax(-1).astype(np.int32)
    jent = _cache_entries(jax.device_get(jcc))
    for key, tlc in _cache_entries(pc).items():
        assert np.array_equal(tlc["slot_pos"].numpy(), jent[key]["slot_pos"])


@pytest.mark.parametrize("arch,wo", [(a, None) for a in ARCHS]
                         + [(ARCH, 16)])
def test_decode_matches_forward(arch, wo):
    """tests/test_decode_consistency.py on the port's own weights: prefill
    32 tokens, decode 3 more, against the full forward's logits at the
    last position (the reduced configs decode without drops)."""
    cfg = TC.get_reduced(arch)
    params = TT.init_params(cfg, 0, device="cpu")
    s, extra = 32, 3
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (B, s + extra)).astype(np.int32))
    h, _ = TT.forward(cfg, params, {"tokens": toks}, remat=False,
                      window_override=wo)
    want = TT.logits_fn(cfg, params, h[:, -1:])
    logits, cache = TT.prefill(cfg, params, {"tokens": toks[:, :s]},
                               max_len=s + 8, window_override=wo)
    for t in range(s, s + extra):
        logits, cache = TT.decode_step(cfg, params, cache,
                                       {"tokens": toks[:, t:t + 1]}, t,
                                       window_override=wo)
    err = float((logits - want).abs().max())
    assert err < DECODE_VS_FORWARD, err


def test_cache_bytes_of_the_published_config():
    """deepseek-v3-671b's latent cache on ``meta``: (kv_lora 512 + rope
    64) x 2 B = 1,152 B a token and layer in bf16, over its 61 routed
    layers and its 3 prefix layers (an expanded cache would hold 128 x
    (192 + 128) x 2 = 81,920 B)."""
    cfg = TC.get_config(ARCH)
    cache = TT.abstract_cache(cfg, 2, 100)
    per = sum(t.numel() * t.element_size() for e in _cache_entries(
        cache).values() for n, t in e.items() if n != "slot_pos")
    assert per == (61 + 3) * 2 * 100 * 1152
    assert cache["prefix"]["ckv"].shape == (3, 2, 100, 512)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_and_example(arch, capsys):
    """``launch.serve.main`` and ``examples.serve_model.main`` on the CPU:
    the reference's three lines, tokens of the right shape."""
    out = launch_serve.main(["--arch", arch, "--reduced", "--batch", "2",
                             "--prompt-len", "16", "--decode-steps", "3",
                             "--device", "cpu"])
    assert out["tokens"].shape == (2, 4)
    ex = serve_model.main(["--arch", arch, "--batch", "1", "--prompt-len",
                           "16", "--decode-steps", "2", "--window", "8",
                           "--device", "cpu"])
    assert ex["tokens"].shape == (1, 3)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("prefill[2x16]") and len(lines) == 6


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_on_cpu(arch, capsys):
    """``launch.train.main`` with ``--device cpu``: one round of one
    sequence a client, a finite loss, one upload's bytes by the qsgd4
    formula of the model's d."""
    out = train.main(["--arch", arch, "--reduced", "--steps", "1", "--seq",
                      "32", "--global-batch", "4", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[:2] for ln in lines] == [["round", "0"]]
    assert torch.isfinite(out["losses"]).all() and out["state"].t == 1
    d = sum(t.numel() for t in tree_leaves(out["state"].x))
    assert out["metrics"]["upload_bytes"] == (4 * d + 32 * -(-d // 128)) / 8
