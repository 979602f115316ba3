"""Attention: GQA/MQA with qk-norm, logit softcapping, sliding windows.

Counterpart of the training path of ``repro/models/attention.py``:
``attention_train`` is causal (optionally windowed) self-attention over a
whole sequence, computed blockwise with an online softmax (the
flash-attention recurrence in plain torch, the reference's order of
blocks), so the S x S logit matrix is never materialized. The logits,
softmax and value sums run in f32.

On a mesh's "model" axis (``attention_train(tp=)``, more than one
rank) the projections are this rank's shards by ``sharding.rules``
(``_attention_tp``): where the rule splits the query heads whole over the
ranks, each rank attends with its own query heads (and its own KV heads
where those divide too, else all of them, gathered); where it cuts a
flattened heads x head_dim dim that the head count does not divide, the
projections are gathered over "model" before their reshape (as GSPMD
does) and every rank attends with every head; ``wo`` is row-parallel.

Serving: ``init_attn_cache`` (a per-layer KV cache; with a window, a ring
buffer of ``min(window, max_len)`` slots), ``prefill_into_cache`` and
``attention_decode`` (one token against the cache, the logits and p.V in
f32), from the reference's ``attention.py:163-220``. The port writes a
cache in place and returns the same dict; the positions are Python ints
from the host loop, so a decode step never waits on the card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_rope, column_parallel,
                                       dense_init, rms_norm, row_parallel,
                                       softcap, tp_active)

NEG_INF = -2.0e38


def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype=None,
                   lead=()) -> dict:
    """The attention block's parameters (the reference's names and
    shapes); ``lead`` prepends stacked super-block dims."""
    dtype = dtype or cfg.p_dtype
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    lead = tuple(lead)
    dev = gen.device
    p = {
        "wq": dense_init(gen, lead + (d, h * hd), d, dtype),
        "wk": dense_init(gen, lead + (d, kv * hd), d, dtype),
        "wv": dense_init(gen, lead + (d, kv * hd), d, dtype),
        "wo": dense_init(gen, lead + (h * hd, d), h * hd, dtype),
    }
    if cfg.attn_bias:
        for name, width in (("bq", h * hd), ("bk", kv * hd), ("bv", kv * hd)):
            p[name] = torch.zeros(lead + (width,), dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(lead + (hd,), dtype=dtype, device=dev)
        p["k_norm"] = torch.ones(lead + (hd,), dtype=dtype, device=dev)
    return p


def _project_qkv(cfg: ModelConfig, params, x: torch.Tensor,
                 positions: torch.Tensor, folded_rope: bool = True):
    """q (B, S, H, hd), k and v (B, S, KV, hd): projections, bias,
    qk-norm and rotary embeddings, as the reference orders them
    (``folded_rope``: the jitted reference's frequencies,
    ``layers.rope_frequencies``)."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = torch.einsum("bsd,de->bse", x, params["wq"])
    k = torch.einsum("bsd,de->bse", x, params["wk"])
    v = torch.einsum("bsd,de->bse", x, params["wv"])
    if cfg.attn_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kv, hd)
    v = v.reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.rms_eps)
        k = rms_norm(k, params["k_norm"], cfg.rms_eps)
    q = apply_rope(q, positions, cfg.rope_theta, folded_rope)
    k = apply_rope(k, positions, cfg.rope_theta, folded_rope)
    return q, k, v


def _logit_scale(cfg: ModelConfig) -> float:
    if cfg.attn_logit_scale is not None:
        return cfg.attn_logit_scale
    return 1.0 / math.sqrt(cfg.hd)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_positions: torch.Tensor,
                        kv_positions: torch.Tensor, *,
                        window: Optional[int], scale: float,
                        attn_softcap: Optional[float], q_block: int = 512,
                        kv_block: int = 512) -> torch.Tensor:
    """Causal (optionally windowed) attention without materializing S x S.

    q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd). Returns (B, Sq, H, hd) in
    q's dtype. GQA: query heads are grouped per KV head (H = KV * G). Each
    query block runs the online softmax over every KV block in order, in
    f32, as the reference's scan does. The casts to f32 sit where the
    reference's do, which sets the dtype its gradients add up in (bf16
    activations): each KV block is cast once, as the reference's vmap over
    query blocks casts it once, so its gradients from the query blocks
    add in f32; the query block is cast in every KV step, as inside the
    reference's scan, so its gradients from the KV steps add in q's dtype.

    Both position vectors are one origin plus ``arange(S)``, as every
    caller's are (training and prefill), so the KV blocks that the causal
    mask and the window leave wholly out of a query block are known from
    the block indices and skipped. That changes no bit of the output: a
    skipped block after the diagonal would add ``p = 0`` at ``alpha =
    1``, and one before the window, where ``m`` is still ``NEG_INF``,
    would be wiped by the first kept block's ``alpha = 0``
    (``tests/test_torch_shapes.py`` holds this loop to the full one bit
    for bit).
    """
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    hd_v = v.shape[3]
    g = h // kvh
    if sq % q_block or skv % kv_block:
        raise ValueError(f"sequence lengths {sq}, {skv} are not multiples "
                         f"of the blocks {q_block}, {kv_block}")
    nq, nk = sq // q_block, skv // kv_block
    qb = q.reshape(b, nq, q_block, kvh, g, hd)
    kb = k.reshape(b, nk, kv_block, kvh, hd)
    vb = v.reshape(b, nk, kv_block, kvh, hd_v)
    qp = q_positions.reshape(nq, q_block)
    kp = kv_positions.reshape(nk, kv_block)
    kf = [kb[:, j].to(torch.float32) for j in range(nk)]
    vf = [vb[:, j].to(torch.float32) for j in range(nk)]
    outs = []
    for i in range(nq):
        q_i = qb[:, i]
        qpos = qp[i][None, :, None, None, None]
        m = torch.full((b, q_block, kvh, g), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, q_block, kvh, g), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((b, q_block, kvh, g, hd_v), dtype=torch.float32,
                          device=q.device)
        for j in range(nk):
            if _masked_out(i, j, q_block, kv_block, window):
                continue
            logits = torch.einsum("bqkgd,bskd->bqkgs",
                                  q_i.to(torch.float32), kf[j]) * scale
            logits = softcap(logits, attn_softcap)
            kpos = kp[j][None, None, None, None, :]
            mask = kpos <= qpos
            if window is not None:
                mask = mask & (kpos > qpos - window)
            logits = torch.where(mask, logits,
                                 torch.full_like(logits, NEG_INF))
            m_new = torch.maximum(m, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bqkgs,bskd->bqkgd", p, vf[j])
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    out = torch.stack(outs, dim=1)
    return out.reshape(b, sq, h, hd_v).to(q.dtype)


def _masked_out(i: int, j: int, q_block: int, kv_block: int,
                window: Optional[int]) -> bool:
    """Whether KV block j lies wholly outside query block i's causal
    window, positions counted from one origin in both."""
    q_lo, q_hi = i * q_block, (i + 1) * q_block - 1
    k_lo, k_hi = j * kv_block, (j + 1) * kv_block - 1
    return k_lo > q_hi or (window is not None and k_hi <= q_lo - window)


def _heads(cfg: ModelConfig, t: torch.Tensor, n: int, scale,
           positions: torch.Tensor, rotate: bool = True) -> torch.Tensor:
    """A projection's (B, S, n * hd) as (B, S, n, hd) heads, qk-normed by
    ``scale`` (None: no norm) and rotated (``rotate``), as
    ``_project_qkv`` orders them."""
    b, s, _ = t.shape
    t = t.reshape(b, s, n, cfg.hd)
    if cfg.qk_norm and scale is not None:
        t = rms_norm(t, scale, cfg.rms_eps)
    return apply_rope(t, positions, cfg.rope_theta) if rotate else t


def _attention_tp(cfg: ModelConfig, params, x: torch.Tensor,
                  positions: torch.Tensor, *, window: Optional[int],
                  q_block: int, kv_block: int, tp) -> torch.Tensor:
    """``attention_train`` on this rank's shards (module docstring): x
    replicated over "model", the output summed over it. A replicated
    tensor (a norm scale, a gathered projection) that enters this rank's
    heads passes ``copy_to_model``, so its gradient sums the ranks'."""
    from repro_torch.launch import mesh as M

    b, s, _ = x.shape
    h, kv, hd, m = cfg.n_heads, cfg.n_kv_heads, cfg.hd, tp.size
    norm = {n: params.get(n + "_norm") if cfg.qk_norm else None
            for n in ("q", "k")}
    xc = M.copy_to_model(x, tp)
    proj = {}
    for name, n in (("q", h), ("k", kv), ("v", kv)):
        t, sharded = column_parallel(x, params["w" + name], n * hd, tp, xc)
        if cfg.attn_bias:
            bias = params["b" + name]
            t = t + (M.split_to_model(bias, -1, tp) if sharded else bias)
        proj[name] = (t, sharded)
    local = lambda v: None if v is None else M.copy_to_model(v, tp)
    q, q_sharded = proj["q"]
    if q_sharded and h % m == 0:  # this rank's query heads
        hl = h // m
        q = _heads(cfg, q, hl, local(norm["q"]), positions)
        k, v = proj["k"][0], proj["v"][0]
        if proj["k"][1] and kv % m == 0:
            k = _heads(cfg, k, kv // m, local(norm["k"]), positions)
            v = _heads(cfg, v, kv // m, None, positions, rotate=False)
        else:  # every KV head, then those of this rank's query heads
            if proj["k"][1]:
                k, v = (M.gather_from_model(t, -1, tp) for t in (k, v))
            k = M.copy_to_model(_heads(cfg, k, kv, norm["k"], positions),
                                tp)
            v = M.copy_to_model(_heads(cfg, v, kv, None, positions,
                                       rotate=False), tp)
            g = h // kv
            first = tp.rank * hl
            if hl % g == 0:
                keep = torch.arange(first // g, (first + hl) // g)
            elif g % hl == 0:
                keep = torch.tensor([first // g])
            else:
                keep = torch.arange(first, first + hl) // g
            keep = keep.to(x.device)
            k, v = k.index_select(2, keep), v.index_select(2, keep)
        sharded = True
    else:  # every head on every rank
        full = [M.gather_from_model(t, -1, tp) if sh else t
                for t, sh in (proj["q"], proj["k"], proj["v"])]
        q = _heads(cfg, full[0], h, norm["q"], positions)
        k = _heads(cfg, full[1], kv, norm["k"], positions)
        v = _heads(cfg, full[2], kv, None, positions, rotate=False)
        sharded = False
    out = blockwise_attention(
        q, k, v, positions, positions, window=window,
        scale=_logit_scale(cfg), attn_softcap=cfg.attn_softcap,
        q_block=min(q_block, s), kv_block=min(kv_block, s))
    return row_parallel(out.reshape(b, s, -1), params["wo"], sharded, tp)


def attention_train(cfg: ModelConfig, params, x: torch.Tensor,
                    positions: torch.Tensor, *,
                    window: Optional[int] = None, q_block: int = 512,
                    kv_block: int = 512, return_kv: bool = False,
                    folded_rope: bool = True, tp=None):
    """Self-attention over a full sequence (training). x: (B, S, D);
    ``folded_rope=False`` rotates by the eager reference's frequencies.
    ``tp`` (``launch.mesh.TensorParallel``): the parameters are this
    rank's shards on a "model" axis of more than one rank
    (``_attention_tp``)."""
    if tp_active(tp):
        if return_kv or not folded_rope:
            raise NotImplementedError(
                "serving on a mesh is ROADMAP queue A item 13b.2")
        return _attention_tp(cfg, params, x, positions, window=window,
                             q_block=q_block, kv_block=kv_block, tp=tp)
    b, s, _ = x.shape
    q, k, v = _project_qkv(cfg, params, x, positions, folded_rope)
    out = blockwise_attention(
        q, k, v, positions, positions, window=window,
        scale=_logit_scale(cfg), attn_softcap=cfg.attn_softcap,
        q_block=min(q_block, s), kv_block=min(kv_block, s))
    out = torch.einsum("bse,ed->bsd", out.reshape(b, s, -1), params["wo"])
    if return_kv:
        return out, (k, v)
    return out


# ---------------------------------------------------------------------------
# KV cache + decode
# ---------------------------------------------------------------------------


def init_attn_cache(cfg: ModelConfig, batch: int, max_len: int,
                    window: Optional[int] = None, dtype=None,
                    device=None) -> dict:
    """One layer's cache: ``k`` and ``v`` (B, w, KV, hd) zeros in the
    activation dtype and ``slot_pos`` (w,) int32 -1 (an empty slot), w =
    ``min(window, max_len)`` with a window (a ring buffer), else
    ``max_len``."""
    dtype = dtype or cfg.act_dtype
    w = min(window, max_len) if window is not None else max_len
    shape = (batch, w, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "slot_pos": torch.full((w,), -1, dtype=torch.int32,
                                   device=device)}


def prefill_into_cache(cache: dict, k: torch.Tensor, v: torch.Tensor,
                       start: int = 0) -> dict:
    """Write (B, S, KV, hd) keys and values at slots [start, start + S)
    (no ring wrap), in place; returns ``cache``."""
    s = k.shape[1]
    cache["k"][:, start:start + s] = k.to(cache["k"].dtype)
    cache["v"][:, start:start + s] = v.to(cache["v"].dtype)
    cache["slot_pos"][start:start + s] = torch.arange(
        start, start + s, dtype=torch.int32, device=cache["slot_pos"].device)
    return cache


def ring_slot(pos: int, w: int, window: Optional[int]) -> int:
    """The slot of absolute position ``pos`` in a cache of w slots:
    ``pos % w`` in a ring (a window), else ``min(pos, w - 1)``."""
    return pos % w if window is not None else min(pos, w - 1)


def attention_decode(cfg: ModelConfig, params, x: torch.Tensor, cache: dict,
                     pos: int, *, window: Optional[int] = None):
    """One-token decode. x: (B, 1, D); ``pos`` the token's absolute
    position (a Python int). The token's key and value go to their ring
    slot (``ring_slot``) in place; the query attends to every slot whose
    position is valid (``slot_pos`` >= 0, <= pos and, with a window, >
    pos - window), the logits and p.V in f32 with the attention softcap;
    the rotary frequencies are the jitted reference's, as on every path.
    Returns (out (B, 1, D), ``cache``, written in place)."""
    b = x.shape[0]
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    g = h // kvh
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(cfg, params, x, positions)
    kc, vc, spos = cache["k"], cache["v"], cache["slot_pos"]
    slot = ring_slot(pos, kc.shape[1], window)
    kc[:, slot] = k[:, 0].to(kc.dtype)
    vc[:, slot] = v[:, 0].to(vc.dtype)
    spos[slot] = pos
    logits = torch.einsum("bkgd,bskd->bkgs",
                          q.reshape(b, kvh, g, hd).to(torch.float32),
                          kc.to(torch.float32)) * _logit_scale(cfg)
    logits = softcap(logits, cfg.attn_softcap)
    valid = (spos >= 0) & (spos <= pos)
    if window is not None:
        valid = valid & (spos > pos - window)
    logits = torch.where(valid[None, None, None, :], logits,
                         torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, vc.to(torch.float32))
    out = out.reshape(b, 1, h * hd).to(x.dtype)
    return torch.einsum("bse,ed->bsd", out, params["wo"]), cache
