"""The rest of the attention-only pool in the port (repro_torch.configs,
models.transformer, models.attention): codeqwen1.5-7b (qkv bias),
qwen3-14b (qk-norm, GQA), granite-34b (one KV head), internvl2-1b (a
prefix of patch embeddings, qkv bias, tied embeddings) and
musicgen-large (four summed codebooks, a head per codebook, the loss the
codebooks' mean), against the JAX package's on the CPU, at their reduced
configs (2 layers, d_model 256, f32) with the reference's parameters
carried across by ``convert.params_from_jax``.

The reference initialises the qkv biases to zeros and every norm scale to
ones, where a missing bias add or qk-norm changes nothing; ``model``
moves each of those leaves off its init with seeded numpy values first.

Exact: the registry (every id of ``list_archs(include_cnn=True)``: the
same config or None (mamba2-1.3b, zamba2-7b and the MoE configs among
them; the MoE configs also run a reduced step, and their expert-parallel
``moe_impl="ep"`` is refused naming ROADMAP item 13b), the published
configs' ``param_count`` and parameter layouts (leaf order, shapes,
dtypes; ``meta`` tensors against ``jax.eval_shape``); in bf16,
musicgen's codebook sum against the reference op by op and jitted.

Within the bounds of tests/test_torch_transformer.py (the two packages'
products and reductions take other orders): forward, loss and gradients
against the eager and the jitted reference.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.core.quantizers import flatten_tree as jflatten
from repro.models import transformer as JT
from repro_torch import configs as TC
from repro_torch.common.tree import tree_leaves
from repro_torch.convert import params_from_jax
from repro_torch.core.quantizers import TreeLayout
from repro_torch.data.synthetic import synthetic_batch_for_config
from repro_torch.models import transformer as TT

ARCHS = ("codeqwen1.5-7b", "qwen3-14b", "granite-34b", "internvl2-1b",
         "musicgen-large")
# the reference's ModelConfig.param_count of the published configs
PARAM_COUNT = {"codeqwen1.5-7b": 8_189_378_560,
               "qwen3-14b": 14_767_882_240,
               "granite-34b": 47_248_834_560,
               "internvl2-1b": 493_709_440,
               "musicgen-large": 3_242_196_992}
# once refused naming 14c.4; their expert-parallel path is item 13b
UNPORTED = {"qwen3-moe-235b-a22b": "13b", "deepseek-v3-671b": "13b"}
# the bounds of tests/test_torch_transformer.py, relative to the largest
# magnitude of the reference's values (the loss absolute)
FWD_RTOL = 1e-5
GRAD_RTOL = 2e-5
LOSS_ATOL = 5e-6
# leaves the reference initialises to zeros or ones: moved off their init
PERTURBED = ("bq", "bk", "bv", "q_norm", "k_norm", "ln1", "ln2",
             "final_norm")
B, SEQ = 2, 32  # internvl2-1b's reduced prefix is 16 of the 32


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The module's tests on one torch thread, restored after: the suite
    runs six workers on the CPU's cores, where a pool of threads per
    worker spends its time waiting on the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def close(got, want, rtol) -> float:
    """Assert max |got - want| <= rtol * max |want|; returns the ratio."""
    got = got.detach().to(torch.float32).numpy() if isinstance(
        got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.max(np.abs(want))) or 1.0
    err = float(np.max(np.abs(got.astype(np.float64) - want)))
    assert err <= rtol * scale, (err, scale)
    return err / scale


def model(arch: str, dtype: str = "float32", seed: int = 0) -> dict:
    """The reduced config in both packages (``dtype`` parameters and
    activations), the reference's parameters with every bias and norm
    scale moved off its init, and a (B, SEQ) batch of both (a VLM's
    patch embeddings included) from the reference's numpy stream."""
    jc = JC.get_reduced(arch).replace(param_dtype=dtype, dtype=dtype)
    tc = TC.get_reduced(arch).replace(param_dtype=dtype, dtype=dtype)
    rng = np.random.default_rng(seed + 1)

    def perturb(path, a):
        if path[-1].key not in PERTURBED:
            return a
        return (a.astype(jnp.float32) + jnp.asarray(
            0.1 * rng.standard_normal(a.shape), jnp.float32)).astype(a.dtype)

    jp = jax.tree_util.tree_map_with_path(
        perturb, JT.init_params(jc, jax.random.PRNGKey(seed)))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    b = synthetic_batch_for_config(tc, np.random.default_rng(seed), B, SEQ)
    return dict(jc=jc, tc=tc, jp=jp, tp=tp,
                jb={k: jnp.asarray(v) for k, v in b.items()},
                tb={k: torch.from_numpy(v) for k, v in b.items()})


@pytest.mark.parametrize("arch", JC.list_archs(include_cnn=True))
def test_registry_matches_reference(arch):
    """Each id: the same config and reduced config (None for the CNN);
    the MoE configs' reduced step runs and their ``moe_impl="ep"`` raises
    naming the ROADMAP item that ports it."""
    if arch in UNPORTED:
        cfg = TC.get_reduced(arch)
        params = TT.init_params(cfg, 0, device="cpu")
        tokens = torch.zeros((1, 8), dtype=torch.int32)
        batch = {"tokens": tokens, "labels": tokens}
        assert torch.isfinite(TT.loss_fn(cfg, params, batch)[0])
        with pytest.raises(NotImplementedError,
                           match=UNPORTED[arch].replace(".", r"\.")):
            TT.loss_fn(cfg.replace(moe_impl="ep"), params, batch)
    for get in ("get_config", "get_reduced"):
        j, t = getattr(JC, get)(arch), getattr(TC, get)(arch)
        if j is None:
            assert t is None and arch == "celeba-cnn"
            continue
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert j.param_count() == t.param_count()
    assert TC.list_archs(include_cnn=True) == JC.list_archs(include_cnn=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_and_layout_match_reference(arch):
    """The published config's parameter count and tree (``meta`` tensors
    against the reference's ``abstract_params``: leaf order, shapes,
    dtypes), the reduced config's flat layout against the reference's;
    audio's (CB, V, D) embed and (CB, D, V) heads."""
    cfg = TC.get_config(arch)
    assert cfg.param_count() == JC.get_config(arch).param_count() \
        == PARAM_COUNT[arch]
    meta = TT.abstract_params(cfg)
    want = JT.abstract_params(JC.get_config(arch))
    assert jax.tree.structure(want) == jax.tree.structure(
        jax.tree.map(lambda t: 0, meta))
    for t, w in zip(tree_leaves(meta), jax.tree.leaves(want)):
        assert tuple(t.shape) == w.shape and t.device.type == "meta"
        assert str(t.dtype).split(".")[-1] == str(w.dtype)
    if cfg.modality == "audio":
        cb, v, d = cfg.audio_codebooks, cfg.vocab, cfg.d_model
        assert meta["embed"].shape == (cb, v, d)
        assert meta["audio_heads"].shape == (cb, d, v)
        assert "head" not in meta
    assert ("head" in meta) == (not cfg.tie_embeddings
                                and cfg.modality != "audio")
    red = TC.get_reduced(arch)
    _, jl = jflatten(JT.init_params(JC.get_reduced(arch),
                                    jax.random.PRNGKey(0)))
    tl = TreeLayout.of(TT.init_params(red, 0, device="cpu"))
    assert tl.shapes == jl.shapes and tl.sizes == jl.sizes


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_gradients_match_eager_and_jitted(arch):
    """The whole stack from the perturbed weights: the hidden states (the
    VLM's prefix positions included), the loss (the VLM's over its text
    span, audio's the codebooks' mean) and every leaf's gradient, against
    the reference eager and jitted; a VLM forward without patch
    embeddings too (text only, as its decode sees it)."""
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
    if tc.modality == "vlm":
        text = {"tokens": tb["tokens"]}
        close(TT.forward(tc, tp, text, remat=False)[0],
              JT.forward(jc, jp, {"tokens": jb["tokens"]}, remat=False)[0],
              FWD_RTOL)

    tloss = lambda p: TT.loss_fn(tc, p, tb, remat=False)[0]
    jloss = lambda p: JT.loss_fn(jc, p, jb, remat=False)[0]
    jl, jg = jax.value_and_grad(jloss)(jp)
    kl, kg = jax.jit(jax.value_and_grad(jloss))(jp)
    tl = float(tloss(tp))
    assert abs(tl - float(jl)) <= LOSS_ATOL and abs(tl - float(kl)) <= \
        LOSS_ATOL
    tg = tree_leaves(torch.func.grad(tloss)(tp))
    for ref in (jg, kg):
        ref = jax.tree.leaves(ref)
        assert len(ref) == len(tg)
        for a, b in zip(tg, ref):
            close(a, b, GRAD_RTOL)
    # the moved biases and norm scales reach the loss
    names = [p[-1].key for p, _ in jax.tree_util.tree_leaves_with_path(jg)]
    for name in ("bq", "bk", "bv", "q_norm", "k_norm"):
        grads = [g for n, g in zip(names, tg) if n == name]
        assert bool(grads) == (name in ("bq", "bk", "bv") and tc.attn_bias
                               or name in ("q_norm", "k_norm")
                               and tc.qk_norm), name
        assert all(float(g.abs().max()) > 0 for g in grads), name


def test_musicgen_codebook_sum_bf16_op_by_op():
    """musicgen's summed codebook embeddings in bf16: Python's ``sum``,
    ((0 + e0) + e1) + e2) + e3, each add rounded to bf16, equal bit for
    bit to the reference run op by op and to its jitted version (XLA:CPU
    keeps each bf16 rounding of the sum); a sum taken in f32 and rounded
    once misses."""
    m = model("musicgen-large", "bfloat16")
    emb = m["jp"]["embed"]
    toks = m["jb"]["tokens"]
    assert toks.shape == (B, SEQ, 4) and emb.dtype == jnp.bfloat16
    fn = lambda e, t: JT._embed_inputs(m["jc"], {"embed": e}, {"tokens": t})
    with jax.disable_jit():
        eager = fn(emb, toks)
    jitted = jax.jit(fn)(emb, toks)
    got = TT._embed_inputs(m["tc"], {"embed": m["tp"]["embed"]},
                           {"tokens": m["tb"]["tokens"]})
    assert got.dtype == torch.bfloat16
    f32 = lambda a: np.asarray(a.float() if isinstance(a, torch.Tensor)
                               else jnp.asarray(a, jnp.float32))
    assert np.array_equal(f32(got), f32(eager))
    assert np.array_equal(f32(got), f32(jitted))
    once = sum(m["tp"]["embed"][c].float()[m["tb"]["tokens"][:, :, c].long()]
               for c in range(4)).to(torch.bfloat16)
    share = float(np.mean(f32(once) == f32(eager)))
    print(f"codebook sum: f32-once control {share:.4f} equal")
    assert share < 0.9
