"""Serving the rest of the attention-only pool (models.transformer's
``prefill`` and ``decode_step``, models.attention's cache and
``attention_decode`` with qkv bias, qk-norm and one KV head; a VLM's
prefix prefill and text decode; audio's (B, 1, CB) decode;
``launch.serve`` and ``examples.serve_model``) against the JAX package's,
on the CPU, at the reduced configs (f32) with the reference's perturbed
parameters (tests/test_torch_archs.py).

Exact: every cache's ``slot_pos``; greedy tokens where the reference's
top-2 margin is at least ``FLIP_MARGIN``. Within ``SERVE_RTOL`` of the
largest magnitude of the reference's values: the prefill's logits and
caches, and each decode step of the port from the reference's own prefill
cache (``cache_from_jax``) against the reference's jitted decode step.
Decode against the full-sequence forward on the port's own weights, the
reference's tests/test_decode_consistency.py cases (every arch; granite
with ``window_override=16``; the VLM after a prefix prefill): below its
``DECODE_VS_FORWARD``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as JT
from repro_torch import configs as TC
from repro_torch.convert import cache_from_jax
from repro_torch.examples import serve_model
from repro_torch.launch import serve as launch_serve
from repro_torch.models import transformer as TT
from test_torch_archs import ARCHS, B, SEQ, model, one_thread  # noqa: F401

SERVE_RTOL = 1e-5         # the bound of tests/test_torch_serve.py
DECODE_VS_FORWARD = 2e-3  # the reference's own bound
FLIP_MARGIN = 1e-4        # a top-2 margin under this may flip a token
DECODE_STEPS = 4


def _rel(got, want) -> float:
    got = got.detach().to(torch.float32).numpy().astype(np.float64)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / (np.abs(want).max() or 1.0))


@pytest.mark.parametrize("arch,wo", [(a, None) for a in ARCHS]
                         + [("granite-34b", 16)])
def test_prefill_and_decode_match_reference(arch, wo):
    """The port's prefill (a VLM's prefix of patch embeddings in front of
    its text) against the reference's jitted one: last-position logits
    ((B, 1, CB, V) for audio), every cache leaf, ``slot_pos`` exactly;
    then ``DECODE_STEPS`` steps of the port from the reference's own
    cache against its jitted decode, at positions that count the prefix,
    both fed the reference's greedy token."""
    m = model(arch)
    jc, tc, jp, tp = m["jc"], m["tc"], m["jp"], m["tp"]
    inputs = {k: v for k, v in m["tb"].items() if k != "labels"}
    jin = {k: v for k, v in m["jb"].items() if k != "labels"}
    max_len = SEQ + DECODE_STEPS
    jl, jcache = jax.jit(lambda p, i: JT.prefill(
        jc, p, i, max_len=max_len, window_override=wo))(jp, jin)
    tl, tcache = TT.prefill(tc, tp, inputs, max_len=max_len,
                            window_override=wo)
    assert tl.shape == jl.shape == ((B, 1, tc.audio_codebooks, tc.vocab)
                                    if tc.modality == "audio"
                                    else (B, 1, tc.vocab))
    assert _rel(tl, jl) <= SERVE_RTOL
    jcache = jax.device_get(jcache)
    for key, jlc in jcache["layers"].items():
        tlc = tcache["layers"][key]
        assert tlc["k"].shape[-2] == tc.n_kv_heads
        for name in ("k", "v"):
            assert _rel(tlc[name], jlc[name]) <= SERVE_RTOL, (key, name)
        assert np.array_equal(tlc["slot_pos"].numpy(), jlc["slot_pos"])

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
        assert _rel(tl2, jl2) <= SERVE_RTOL, t
        ja, ta = np.asarray(jl2[:, -1]), tl2[:, -1].numpy()
        top2 = np.sort(ja, axis=-1)[..., -2:]
        same = ja.argmax(-1) == ta.argmax(-1)
        assert np.all(same | (top2[..., 1] - top2[..., 0] < FLIP_MARGIN)), t
        tok = ja.argmax(-1).astype(np.int32)
    for key, jlc in jax.device_get(jcc)["layers"].items():
        assert np.array_equal(pc["layers"][key]["slot_pos"].numpy(),
                              jlc["slot_pos"])


def _tokens(cfg, n: int, seed: int = 1) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    shape = (B, n, cfg.audio_codebooks) if cfg.modality == "audio" \
        else (B, n)
    return torch.from_numpy(rng.integers(0, cfg.vocab, shape).astype(
        np.int32))


@pytest.mark.parametrize("arch,wo", [(a, None) for a in ARCHS]
                         + [("granite-34b", 16)])
def test_decode_matches_forward(arch, wo):
    """tests/test_decode_consistency.py on the port's own weights: prefill
    32 tokens, decode 3 more, against the full forward's logits at the
    last position."""
    cfg = TC.get_reduced(arch)
    params = TT.init_params(cfg, 0, device="cpu")
    s, extra = 32, 3
    toks = _tokens(cfg, s + extra)
    h, _ = TT.forward(cfg, params, {"tokens": toks}, remat=False,
                      window_override=wo)
    want = TT.logits_fn(cfg, params, h[:, -1:])
    logits, cache = TT.prefill(cfg, params, {"tokens": toks[:, :s]},
                               max_len=s + 8, window_override=wo)
    for t in range(s, s + extra):
        logits, cache = TT.decode_step(cfg, params, cache,
                                       {"tokens": toks[:, t:t + 1]}, t,
                                       window_override=wo)
    assert float((logits - want).abs().max()) < DECODE_VS_FORWARD


def test_vlm_decode_after_prefix_prefill():
    """internvl2-1b: the prefill takes the patch embeddings, the decode is
    text only at position n_prefix + 23 (the reference's test)."""
    cfg = TC.get_reduced("internvl2-1b")
    params = TT.init_params(cfg, 1, device="cpu")
    n_pre = cfg.n_prefix_embeddings
    toks = _tokens(cfg, 24)
    patches = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (B, n_pre, cfg.d_model)).astype(np.float32))
    h, _ = TT.forward(cfg, params, {"tokens": toks,
                                    "patch_embeddings": patches},
                      remat=False)
    want = TT.logits_fn(cfg, params, h[:, -1:])
    _, cache = TT.prefill(cfg, params, {"tokens": toks[:, :-1],
                                        "patch_embeddings": patches},
                          max_len=n_pre + 40)
    logits, _ = TT.decode_step(cfg, params, cache, {"tokens": toks[:, -1:]},
                               n_pre + 23)
    assert float((logits - want).abs().max()) < DECODE_VS_FORWARD


@pytest.mark.parametrize("arch", ["internvl2-1b", "musicgen-large"])
def test_serve_launcher_and_example_on_cpu(arch, capsys):
    """``launch.serve.main`` (the reference's three lines) and
    ``examples.serve_model`` on the CPU: greedy (B,) or (B, CB) tokens a
    step, a VLM's prompt counting its 16 patch embeddings, so its decode
    positions continue after them: the last step's logits equal the
    full forward's over the prompt and every token but the last."""
    out = launch_serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                             "--batch", "2", "--prompt-len", "24",
                             "--decode-steps", "3"])
    lines = capsys.readouterr().out.strip().splitlines()
    cfg = TC.get_reduced(arch)
    audio = cfg.modality == "audio"
    shape = (2, 1, cfg.audio_codebooks, cfg.vocab) if audio else (
        2, 1, cfg.vocab)
    assert lines[0].startswith(f"prefill[2x24] logits={shape}")
    assert lines[1].startswith("decode 3 steps:")
    assert lines[2].startswith("sample tokens: [")
    toks = out["tokens"]
    assert toks.shape == ((2, 4, cfg.audio_codebooks) if audio else (2, 4))
    assert torch.equal(toks[:, -1], out["last_logits"][:, -1].argmax(-1).to(
        torch.int32))
    # the run again, by hand: the prompt, then the generated tokens
    from repro_torch.data.synthetic import synthetic_batch_for_config
    params = TT.init_params(cfg, 0, device="cpu")
    batch = synthetic_batch_for_config(cfg, np.random.default_rng(0), 2, 24)
    inputs = {k: torch.from_numpy(v) for k, v in batch.items()
              if k != "labels"}
    inputs["tokens"] = torch.cat([inputs["tokens"], toks[:, :-1]], dim=1)
    h, _ = TT.forward(cfg, params, inputs, remat=False)
    want = TT.logits_fn(cfg, params, h[:, -1:])
    assert float((out["last_logits"] - want).abs().max()) < DECODE_VS_FORWARD
    ex = serve_model.main(["--arch", arch, "--device", "cpu",
                           "--decode-steps", "2"])
    assert capsys.readouterr().out.startswith(f"{cfg.arch_id}: prefill 2x48")
    assert ex["tokens"].shape[:2] == (2, 3)


def test_serve_refuses_a_prompt_within_the_vlm_prefix():
    """internvl2-1b's prompt counts its patch embeddings: a prompt no
    longer than them is refused naming the prefix, before any weight is
    made (the full config's 64 under 256)."""
    for argv in (["--reduced", "--prompt-len", "16"], ["--prompt-len", "64"]):
        with pytest.raises(ValueError, match="prefix"):
            launch_serve.main(["--arch", "internvl2-1b", "--device", "cpu"]
                              + argv)
