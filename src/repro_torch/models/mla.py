"""Multi-head Latent Attention (DeepSeek-V2/V3).

Counterpart of ``repro/models/mla.py``. Queries and keys/values come
through low-rank latents; the KV cache holds only the compressed latent
``ckv`` (``kv_lora_rank``) and the shared rope key (``qk_rope_head_dim``):
(kv_lora_rank + qk_rope_head_dim) values a token and layer, where an
expanded cache would hold n_heads * (nope + rope + v).

* train / prefill (``mla_train``): the latents are expanded to per-head
  keys and values (the rope key broadcast to every head) and fed to
  ``attention.blockwise_attention``, whose value head dim may differ from
  the query's.
* decode (``mla_decode``): the **absorbed** form. ``wk_b`` is folded into
  the query and ``wv_b`` into the output, so attention runs in the latent
  space over the cache as it is; its products run in f32, and the
  token's latents go to their ring slot in place (as
  ``attention.attention_decode`` writes its keys).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.models.attention import NEG_INF, blockwise_attention, ring_slot
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, dense_init, rms_norm


def init_mla(gen: torch.Generator, cfg: ModelConfig, dtype=None,
             lead=()) -> dict:
    """The MLA block's parameters (the reference's names and shapes);
    ``lead`` prepends stacked super-block dims."""
    dtype = dtype or cfg.p_dtype
    d, h = cfg.d_model, cfg.n_heads
    qr, kr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    lead, dev = tuple(lead), gen.device
    return {
        "wq_a": dense_init(gen, lead + (d, qr), d, dtype),
        "q_a_norm": torch.ones(lead + (qr,), dtype=dtype, device=dev),
        "wq_b": dense_init(gen, lead + (qr, h * (dn + dr)), qr, dtype),
        "wkv_a": dense_init(gen, lead + (d, kr), d, dtype),
        "kv_a_norm": torch.ones(lead + (kr,), dtype=dtype, device=dev),
        "wk_rope": dense_init(gen, lead + (d, dr), d, dtype),
        "wk_b": dense_init(gen, lead + (kr, h * dn), kr, dtype),
        "wv_b": dense_init(gen, lead + (kr, h * dv), kr, dtype),
        "wo": dense_init(gen, lead + (h * dv, d), h * dv, dtype),
    }


def _mla_scale(cfg: ModelConfig) -> float:
    return 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)


def _queries(cfg: ModelConfig, params, x: torch.Tensor,
             positions: torch.Tensor):
    """(q_nope (B, S, H, nope), q_rope (B, S, H, rope), rotated)."""
    b, s, _ = x.shape
    h, dn, dr = cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    qa = rms_norm(torch.einsum("bsd,dr->bsr", x, params["wq_a"]),
                  params["q_a_norm"], cfg.rms_eps)
    q = torch.einsum("bsr,re->bse", qa, params["wq_b"]).reshape(b, s, h,
                                                              dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _latents(cfg: ModelConfig, params, x: torch.Tensor,
             positions: torch.Tensor):
    """(ckv (B, S, kv_lora_rank) normed, k_rope (B, S, rope) rotated)."""
    ckv = rms_norm(torch.einsum("bsd,dr->bsr", x, params["wkv_a"]),
                   params["kv_a_norm"], cfg.rms_eps)
    k_rope = torch.einsum("bsd,dr->bsr", x, params["wk_rope"])
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    return ckv, k_rope


def mla_train(cfg: ModelConfig, params, x: torch.Tensor,
              positions: torch.Tensor, *, window: Optional[int] = None,
              q_block: int = 512, kv_block: int = 512,
              return_latents: bool = False):
    """Full-sequence MLA (training, prefill): the latents expanded to
    per-head keys and values, blockwise attention. x: (B, S, D); with
    ``return_latents`` also (ckv, k_rope) for the cache."""
    b, s, _ = x.shape
    h, dn, dr, dv = (cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                     cfg.v_head_dim)
    q_nope, q_rope = _queries(cfg, params, x, positions)
    ckv, k_rope = _latents(cfg, params, x, positions)
    k_nope = torch.einsum("bsr,re->bse", ckv, params["wk_b"]).reshape(
        b, s, h, dn)
    v = torch.einsum("bsr,re->bse", ckv, params["wv_b"]).reshape(b, s, h, dv)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, dr)],
                  dim=-1)
    out = blockwise_attention(q, k, v, positions, positions, window=window,
                              scale=_mla_scale(cfg), attn_softcap=None,
                              q_block=min(q_block, s),
                              kv_block=min(kv_block, s))
    out = torch.einsum("bse,ed->bsd", out.reshape(b, s, h * dv),
                       params["wo"])
    if return_latents:
        return out, (ckv, k_rope)
    return out


# ---------------------------------------------------------------------------
# Compressed cache + absorbed decode
# ---------------------------------------------------------------------------


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int,
                   window: Optional[int] = None, dtype=None,
                   device=None) -> dict:
    """One layer's latent cache: ``ckv`` (B, w, kv_lora_rank) and
    ``k_rope`` (B, w, rope) zeros in the activation dtype, ``slot_pos``
    (w,) int32 -1; w = ``min(window, max_len)`` with a window (a ring),
    else ``max_len``."""
    dtype = dtype or cfg.act_dtype
    w = min(window, max_len) if window is not None else max_len
    return {"ckv": torch.zeros((batch, w, cfg.kv_lora_rank), dtype=dtype,
                               device=device),
            "k_rope": torch.zeros((batch, w, cfg.qk_rope_head_dim),
                                  dtype=dtype, device=device),
            "slot_pos": torch.full((w,), -1, dtype=torch.int32,
                                   device=device)}


def mla_prefill_cache(cfg: ModelConfig, params, x: torch.Tensor,
                      positions: torch.Tensor, cache: dict,
                      start: int = 0) -> dict:
    """Write the latents of x (B, S, D) at slots [start, start + S) (no
    ring wrap), in place; returns ``cache``."""
    ckv, k_rope = _latents(cfg, params, x, positions)
    s = x.shape[1]
    cache["ckv"][:, start:start + s] = ckv.to(cache["ckv"].dtype)
    cache["k_rope"][:, start:start + s] = k_rope.to(cache["k_rope"].dtype)
    cache["slot_pos"][start:start + s] = torch.arange(
        start, start + s, dtype=torch.int32, device=cache["slot_pos"].device)
    return cache


def mla_decode(cfg: ModelConfig, params, x: torch.Tensor, cache: dict,
               pos: int, *, window: Optional[int] = None):
    """Absorbed one-token MLA decode. x: (B, 1, D); ``pos`` the token's
    absolute position (a Python int). The token's latents go to their ring
    slot in place; the query, absorbed through ``wk_b``, attends in the
    latent space to every valid slot (``slot_pos`` >= 0, <= pos and, with
    a window, > pos - window), the output absorbed through ``wv_b``, all
    in f32. Returns (out (B, 1, D), ``cache``)."""
    b = x.shape[0]
    h, dn, dv = cfg.n_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    kr = cfg.kv_lora_rank
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _queries(cfg, params, x, positions)
    ckv_t, k_rope_t = _latents(cfg, params, x, positions)
    cc, kc, spos = cache["ckv"], cache["k_rope"], cache["slot_pos"]
    slot = ring_slot(pos, cc.shape[1], window)
    cc[:, slot] = ckv_t[:, 0].to(cc.dtype)
    kc[:, slot] = k_rope_t[:, 0].to(kc.dtype)
    spos[slot] = pos
    wk_b = params["wk_b"].reshape(kr, h, dn)
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].to(torch.float32),
                         wk_b.to(torch.float32))
    ckv = cc.to(torch.float32)
    scores = torch.einsum("bhr,bsr->bhs", q_lat, ckv)
    scores = scores + torch.einsum("bhd,bsd->bhs",
                                   q_rope[:, 0].to(torch.float32),
                                   kc.to(torch.float32))
    scores = scores * _mla_scale(cfg)
    valid = (spos >= 0) & (spos <= pos)
    if window is not None:
        valid = valid & (spos > pos - window)
    scores = torch.where(valid[None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    ctx_lat = torch.einsum("bhs,bsr->bhr", p, ckv)
    wv_b = params["wv_b"].reshape(kr, h, dv)
    out = torch.einsum("bhr,rhd->bhd", ctx_lat, wv_b.to(torch.float32))
    out = out.reshape(b, 1, h * dv).to(x.dtype)
    return torch.einsum("bse,ed->bsd", out, params["wo"]), cache
