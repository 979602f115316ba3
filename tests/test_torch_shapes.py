"""The port's assigned shapes (``repro_torch.launch.shapes``) against the
reference's ``repro.launch.shapes``, and decode at ``long_500k``'s
positions against the reference's.

``input_specs`` is held for every arch and shape: its keys, each leaf's
path, shape and dtype against the reference's ``ShapeDtypeStruct``s (the
round's key data a (2,) int64 tensor of the two uint32 words, the round's
``t`` a Python int where the reference has a () int32), the window
override, and every tensor on ``meta``. Then one decode step at pos
524,287 and one at 524,288, where a global layer's ring of 8,192 slots
wraps (524,288 = 64 * 8,192), on the reduced gemma2-2b (window 8,192 on
every attention layer, as ``long_500k`` sets) and the reduced mamba2-1.3b
(no window), from a cache filled from a numpy seed: the port's logits and
cache against the reference's jitted ``decode_step`` within the serving
tests' 1e-5. And a served program whole: the reduced gemma2-2b's one
super-block prefills 4,096 tokens and decodes two more, against the
jitted reference's ``make_prefill_step`` then ``make_decode_step``, whose
programs both rotate by the folded RoPE frequencies (read from XLA:CPU's
optimised HLO), as the port's prefill and decode now do.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.core.qafel import QAFeLConfig as JQAFeLConfig
from repro.distributed import steps as JS
from repro.launch import shapes as JSH
from repro.models import transformer as JT
from repro_torch import configs as TC
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.core.qafel import QAFeLConfig
from repro_torch.distributed import steps as TS
from repro_torch.launch import shapes as TSH
from repro_torch.models import transformer as TT

SERVE_RTOL = 1e-5  # tests/test_torch_serve.py's bound for decode logits
LONG_POSITIONS = (524_287, 524_288)  # the last slot of the ring, then slot 0


def _jax_leaves(tree):
    """(path of dict keys, leaf) of a reference tree, in JAX order."""
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out.append((tuple(getattr(k, "key", getattr(k, "name", None))
                          for k in path), leaf))
    return out


def _torch_leaves(tree, path=()):
    """(path, leaf) of a port tree (nested dicts, sorted keys: JAX's
    order)."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _torch_leaves(tree[k], path + (k,))]
    return [(path, tree)]


def _dtype(d) -> str:
    return str(d).split(".")[-1]


def _same_tree(got, want, dtypes=None):
    g, w = _torch_leaves(got), _jax_leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, t), (_, s) in zip(g, w):
        assert isinstance(t, torch.Tensor) and t.device.type == "meta", path
        assert tuple(t.shape) == tuple(s.shape), path
        assert _dtype(t.dtype) == (dtypes or {}).get(_dtype(s.dtype),
                                                     _dtype(s.dtype)), path


def _check(got: dict, want: dict):
    assert set(got) == set(want)
    for key in ("kind", "window_override", "max_len"):
        assert got.get(key) == want.get(key), key
    if want["kind"] == "train":
        js, ts = want["state"], got["state"]
        for name in ("x", "hidden", "momentum"):
            _same_tree(getattr(ts, name), getattr(js, name))
        assert ts.t == 0 and js.t.shape == () and _dtype(js.t.dtype) == \
            "int32"
        _same_tree(got["batch"], want["batch"])
        _same_tree({"w": got["weights"]}, {"w": want["weights"]})
        _same_tree({"k": got["key_data"]}, {"k": want["key_data"]},
                   dtypes={"uint32": "int64"})
        return
    _same_tree(got["params"], want["params"])
    _same_tree(got["inputs"], want["inputs"])
    if want["kind"] == "decode":
        _same_tree(got["cache"], want["cache"])
        _same_tree({"pos": got["pos"]}, {"pos": want["pos"]})


def test_shape_table_is_the_reference():
    assert TSH.LONG_WINDOW == JSH.LONG_WINDOW == 8192
    assert (TSH.TRAIN_K, TSH.TRAIN_P) == (JSH.TRAIN_K, JSH.TRAIN_P)
    assert {n: (s.name, s.kind, s.seq, s.global_batch)
            for n, s in TSH.SHAPES.items()} == {
        n: (s.name, s.kind, s.seq, s.global_batch)
        for n, s in JSH.SHAPES.items()}


@pytest.mark.parametrize("shape", sorted(JSH.SHAPES))
@pytest.mark.parametrize("arch", JC.list_archs())
def test_input_specs_match_reference(arch, shape):
    """Keys, leaf paths, shapes, dtypes and the window override of
    ``input_specs`` against the reference's, nothing allocated; the window
    policy (``window_override_for``, ``uses_window``) the reference's."""
    tc, jc = TC.get_config(arch), JC.get_config(arch)
    got = TSH.input_specs(tc, shape)
    want = JSH.input_specs(jc, shape)
    _check(got, want)
    tshape, jshape = TSH.SHAPES[shape], JSH.SHAPES[shape]
    assert TSH.window_override_for(tc, tshape) == \
        JSH.window_override_for(jc, jshape)
    assert TSH.uses_window(tc, tshape) == JSH.uses_window(jc, jshape)


@pytest.mark.parametrize("arch", ("gemma2-2b", "mamba2-1.3b",
                                  "internvl2-1b", "musicgen-large"))
def test_train_specs_with_qafel_config(arch):
    """``train_4k`` with a ``QAFeLConfig``'s K and P (K = 4, P = 2: local
    batch 32) against the reference's with its own config."""
    got = TSH.input_specs(TC.get_config(arch), "train_4k",
                          QAFeLConfig(buffer_size=4, local_steps=2))
    want = JSH.input_specs(JC.get_config(arch), "train_4k",
                           JQAFeLConfig(buffer_size=4, local_steps=2))
    _check(got, want)
    assert tuple(got["batch"]["labels"].shape)[:3] == (4, 2, 32)
    with pytest.raises(ValueError):
        TSH.input_specs(TC.get_config(arch), "train_4k",
                        QAFeLConfig(buffer_size=512, local_steps=1))


def _filled_cache(jc, batch: int, max_len: int, wo, pos: int, seed: int):
    """The reference's cache for ``pos`` tokens already decoded: every
    k, v, SSM state and conv tail drawn from ``seed``, every ring's
    ``slot_pos`` on the ring law (slot i holds the last position p < pos
    with p = i mod w)."""
    rng = np.random.default_rng(seed)
    zeros = jax.device_get(JT.init_cache(jc, batch, max_len, wo))

    def fill(path, leaf):
        name = getattr(path[-1], "key", None)
        if name == "slot_pos":
            w = leaf.shape[-1]
            i = np.arange(w)
            sp = (pos - 1 - ((pos - 1 - i) % w)).astype(np.int32)
            return jnp.asarray(np.broadcast_to(sp, leaf.shape))
        return jnp.asarray((0.5 * rng.standard_normal(leaf.shape))
                           .astype(leaf.dtype))
    return jax.tree_util.tree_map_with_path(fill, zeros)


@pytest.mark.parametrize("arch", ("gemma2-2b", "mamba2-1.3b"))
def test_long_500k_decode_crosses_the_ring_wrap(arch):
    """Decode at pos 524,287 and 524,288 (the global rings' wrap) on the
    reduced config with ``long_500k``'s window override, from one filled
    cache: the port's logits against the reference's jitted
    ``decode_step`` within ``SERVE_RTOL``, ``slot_pos`` exactly, each ring
    of ``min(8192, seq)`` slots and the written slots the ring law's."""
    jc, tc = JC.get_reduced(arch), TC.get_reduced(arch)
    shape = JSH.SHAPES["long_500k"]
    wo = JSH.window_override_for(jc, shape)
    assert wo == TSH.window_override_for(tc, TSH.SHAPES["long_500k"])
    batch = 2
    jp = JT.init_params(jc, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    jcache = _filled_cache(jc, batch, shape.seq, wo, LONG_POSITIONS[0], 3)
    tcache = cache_from_jax(jax.device_get(jcache), device="cpu")
    for key, lc in tcache["layers"].items():
        if "global" in key:
            assert lc["slot_pos"].shape[-1] == wo
    jdec = jax.jit(lambda p, c, i, pos: JT.decode_step(
        jc, p, c, i, pos, window_override=wo))
    toks = np.random.default_rng(5).integers(
        0, jc.vocab, (len(LONG_POSITIONS), batch, 1)).astype(np.int32)
    for tok, pos in zip(toks, LONG_POSITIONS):
        jl, jcache = jdec(jp, jcache, {"tokens": jnp.asarray(tok)},
                          jnp.int32(pos))
        tl, tcache = TT.decode_step(tc, tp, tcache,
                                    {"tokens": torch.from_numpy(tok)}, pos,
                                    window_override=wo)
        want = np.asarray(jl, np.float32)
        err = np.abs(tl.numpy().astype(np.float64) - want).max()
        assert np.isfinite(tl.numpy()).all()
        assert err <= SERVE_RTOL * np.abs(want).max(), (pos, err)
        jcache = jax.device_get(jcache)
        for key, jlc in jcache["layers"].items():
            tlc = tcache["layers"][key]
            if "slot_pos" in jlc:
                assert np.array_equal(tlc["slot_pos"].numpy(),
                                      jlc["slot_pos"])
                w = jlc["slot_pos"].shape[-1]
                assert int(tlc["slot_pos"][0, pos % w]) == pos


PROMPT = 4096  # the prefill's length, then two decode steps
QK_SCALE = 3.0  # wq and wk scaled so the attention is sharper than at init


def test_prefill_then_decode_takes_one_rope_law():
    """The reduced gemma2-2b (head_dim 64, whose folded and unfolded RoPE
    frequencies differ on 10 of 32; one local and one global layer) with
    its query and key projections scaled by ``QK_SCALE``: a prefill of
    ``PROMPT`` tokens and two decode steps, the port's logits against the
    jitted reference's ``make_prefill_step`` and ``make_decode_step``
    within ``SERVE_RTOL`` of the largest. Measured at this seed: the
    prefill's logits 5.3e-6 off, the decode steps' 3.0e-6 and 4.4e-6;
    with the prefill on the unfolded law and the decode on the folded one
    (the port before), 3.3e-5, 3.9e-5 and 1.3e-4."""
    jc, tc = JC.get_reduced("gemma2-2b"), TC.get_reduced("gemma2-2b")
    assert jc.head_dim == 64 and jc.n_layers == 2
    jp = jax.tree_util.tree_map_with_path(
        lambda path, a: a * QK_SCALE if getattr(path[-1], "key", "") in (
            "wq", "wk") else a, JT.init_params(jc, jax.random.PRNGKey(0)))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(1).integers(
        0, jc.vocab, (1, PROMPT + 2)).astype(np.int32)
    jl, jcache = jax.jit(JS.make_prefill_step(jc, max_len=PROMPT + 2))(
        jp, {"tokens": jnp.asarray(toks[:, :PROMPT])})
    tl, tcache = TS.make_prefill_step(tc, max_len=PROMPT + 2)(
        tp, {"tokens": torch.from_numpy(toks[:, :PROMPT])})
    jdec, tdec = jax.jit(JS.make_decode_step(jc)), TS.make_decode_step(tc)
    for pos in (None, PROMPT, PROMPT + 1):
        if pos is not None:
            tok = toks[:, pos:pos + 1]
            jl, jcache = jdec(jp, jcache, {"tokens": jnp.asarray(tok)},
                              jnp.int32(pos))
            tl, tcache = tdec(tp, tcache, {"tokens": torch.from_numpy(tok)},
                              pos)
        want = np.asarray(jl, np.float32)
        err = np.abs(tl.numpy().astype(np.float64) - want).max()
        print(f"position {pos}: logits within {err:.3e} of "
              f"{np.abs(want).max():.3f}")
        assert err <= SERVE_RTOL * np.abs(want).max(), (pos, err)


def _every_block_pair(q, k, v, pos, window, scale, cap, blk):
    """``blockwise_attention``'s online softmax written out over every
    query and KV block pair, none skipped: the loop it must equal."""
    from repro_torch.models.attention import NEG_INF
    from repro_torch.models.layers import softcap
    b, s, h, hd = q.shape
    kvh, n = k.shape[2], s // blk
    g = h // kvh
    qb = q.reshape(b, n, blk, kvh, g, hd)
    kf = [k[:, j * blk:(j + 1) * blk].to(torch.float32) for j in range(n)]
    vf = [v[:, j * blk:(j + 1) * blk].to(torch.float32) for j in range(n)]
    p_ = pos.reshape(n, blk)
    outs = []
    for i in range(n):
        qpos = p_[i][None, :, None, None, None]
        m = torch.full((b, blk, kvh, g), NEG_INF)
        l, acc = torch.zeros((b, blk, kvh, g)), torch.zeros((b, blk, kvh,
                                                            g, hd))
        for j in range(n):
            lg = softcap(torch.einsum("bqkgd,bskd->bqkgs",
                                      qb[:, i].to(torch.float32), kf[j])
                         * scale, cap)
            kpos = p_[j][None, None, None, None, :]
            mask = kpos <= qpos
            if window is not None:
                mask = mask & (kpos > qpos - window)
            lg = torch.where(mask, lg, torch.full_like(lg, NEG_INF))
            m_new = torch.maximum(m, lg.amax(dim=-1))
            pr = torch.exp(lg - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + pr.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bqkgs,bskd->bqkgd",
                                                        pr, vf[j])
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    return torch.stack(outs, dim=1).reshape(b, s, h, hd).to(q.dtype)


@pytest.mark.parametrize("window", (None, 20))
def test_skipping_masked_blocks_changes_no_bit(window):
    """``blockwise_attention`` skips the KV blocks that the causal mask and
    the window leave wholly out (the prefill at 32,768 positions runs
    2,080 of 4,096 block pairs on a global layer); against the same
    online softmax over every block pair, written out here, on a global
    layer (``window`` None) and a windowed one, 8 x 8 blocks with the
    softcap: the output and the gradients of q, k and v bit for bit."""
    from repro_torch.models import attention as TA
    gen = torch.Generator().manual_seed(0)
    b, s, kvh, g, hd, blk = 2, 64, 2, 2, 16, 8
    q = torch.randn(b, s, kvh * g, hd, generator=gen)
    k = torch.randn(b, s, kvh, hd, generator=gen)
    v = torch.randn(b, s, kvh, hd, generator=gen)
    ct = torch.randn(b, s, kvh * g, hd, generator=gen)
    pos = torch.arange(s, dtype=torch.int32)
    out = []
    for fn in (lambda *a: TA.blockwise_attention(
            *a, pos, pos, window=window, scale=0.25, attn_softcap=30.0,
            q_block=blk, kv_block=blk),
               lambda *a: _every_block_pair(*a, pos, window, 0.25, 30.0,
                                            blk)):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        o = fn(*leaves)
        out.append([o] + list(torch.autograd.grad(o, leaves, ct)))
    for a, c in zip(*out):
        assert torch.equal(a.detach().view(torch.int32),
                           c.detach().view(torch.int32))
    skipped = sum(TA._masked_out(i, j, blk, blk, window)
                  for i in range(s // blk) for j in range(s // blk))
    assert skipped == (28 if window is None else 28 + 10)
