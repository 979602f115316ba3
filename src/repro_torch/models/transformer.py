"""The config-driven decoder: attention, Mamba2 and the hybrid.

Counterpart of ``repro/models/transformer.py``. Layer stacks are grouped into repeating
super-blocks (``cfg.layer_pattern``): pattern ("attn",) for
llama/qwen-style decoders (qkv bias, qk-norm, GQA down to a single KV
head), ("local", "global") for gemma2 (alternating sliding-window and
full attention, (1+s) norms, post-norms, sqrt(d) embedding scale, logit
softcaps), ("mamba",) for mamba2 (``models.mamba2``: a pre-norm SSD
block, no MLP) and ("mamba", "mamba", "attn_shared") for zamba2, whose
one attention block (``shared_block``, drawn once outside the stack, a
top-level leaf) serves every ``attn_shared`` position: each super-block
reads the same tensors, so their gradient is the sum over the uses, and
each use keeps its own KV cache. Two stubbed frontends, as in the
reference: a VLM (internvl2-1b) takes
``patch_embeddings`` (B, n_prefix, D) prepended to the text's embeddings
and scores only the text span; audio (musicgen-large) takes (B, S, CB)
codebook tokens, sums their CB embeddings and has one head per codebook,
its loss the mean over the codebooks. The parameter tree is the
reference's, leaf for leaf: ``embed`` ((CB, V, D) for audio),
``layers/pos{i}_{kind}`` with each leaf stacked over the super-blocks
(no entry for ``attn_shared``), ``shared_block`` (the hybrid),
``prefix_layers`` and ``mtp_block`` / ``mtp_norm`` (deepseek),
``final_norm``, ``audio_heads`` (CB, D, V) for audio, else ``head`` only
when embeddings are untied; it flattens in JAX's order (sorted keys), so
flat vectors of the two packages compare coordinate by coordinate. The
reference scans the super-blocks; here ``forward`` loops over them, under
``torch.utils.checkpoint`` with ``remat``.

Serving (the reference's ``transformer.py:328-528``): ``init_cache`` (one
cache per pattern position, stacked over the super-blocks; local layers a
ring of ``sliding_window`` slots, global ones ``window_override`` or the
whole ``max_len``; a mamba position its f32 SSM state and its conv tail,
of a size that does not grow with the sequence), ``prefill`` (the
prompt's forward, each layer's keys and values written into its ring or
its recurrent state into its cache, the last position's logits only) and
``decode_step`` (one token through every layer, the caches written in
place).

MoE and MLA (qwen3-moe-235b-a22b, deepseek-v3-671b): a stacked layer
holds ``moe`` (``models.moe``: the router, the experts, deepseek's shared
expert) in place of ``mlp`` when the config has experts, its aux loss
added up over the layers into ``loss_fn``'s ``router_aux_coef * aux``;
``use_mla`` puts ``models.mla`` in every attention block. deepseek adds
``prefix_layers`` (``n_dense_layers`` dense-FFN blocks of width
``dense_d_ff``, stacked, run before the stack; their caches under
``cache["prefix"]``) and the MTP head (``mtp_block``, ``mtp_norm``: one
more block over the final hidden states, its cross-entropy on the labels
shifted one more position, 0.1 of it added to the loss). As in the
reference, the prefix layers come on top of the ``n_layers`` routed ones.
Decode's MoE takes ``decode_capacity_factor`` (None: ``n_experts /
experts_per_token``, no drops). ``moe_impl="ep"`` is ROADMAP queue A item
13b.2 and raises naming it.

**On a mesh** (``loss_fn(tp=)``, a ``launch.mesh.TensorParallel`` of more
than one "model" rank): the dense attention decoders run on this rank's
shards by ``sharding.rules.param_pspecs`` (``attention.attention_train``,
``layers.gated_mlp``); the embedding's vocabulary rows are this rank's
(the lookup of the others masked to zero, then summed over "model"), the
logits stay split over the vocabulary, and ``_chunked_xent`` takes the
row maximum and the ``exp`` sum over "model" (``layers
.sharded_logsumexp``) and the gold logit from the rank that holds it.
With a batch split over "data" (``tp.data_size``) the loss's sum and
count are summed over "data". With one rank on each axis every op is the
meshless one.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.utils.checkpoint

from repro_torch.common.device import resolve_device
from repro_torch.common.tree import tree_map
from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba2 as mamba_lib
from repro_torch.models import mla as mla_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (dense_init, embed_init, gated_mlp,
                                       init_gated_mlp, logsumexp, rms_norm,
                                       sharded_logsumexp, softcap,
                                       tp_active)

ATTN_KINDS = ("attn", "local", "global", "attn_shared")
KINDS = ATTN_KINDS + ("mamba",)


def _check_config(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` is a decoder of the pool: attention (text, a
    VLM prefix or audio codebooks; MoE, MLA, a dense prefix, MTP), Mamba2
    or the hybrid."""
    if (cfg.family not in ("dense", "moe", "vlm", "audio", "ssm", "hybrid")
            or cfg.modality not in ("text", "vlm", "audio")
            or any(k not in KINDS for k in cfg.layer_pattern)):
        raise ValueError(f"{cfg.arch_id}: unknown family {cfg.family!r}, "
                         f"modality {cfg.modality!r} or layer pattern "
                         f"{cfg.layer_pattern}")


def _moe_apply(cfg: ModelConfig, moe_params, f_in: torch.Tensor,
               capacity_factor: float):
    """The MoE execution strategy (``ModelConfig.moe_impl``): "ep" is
    ROADMAP queue A item 13b.2 and raises."""
    if cfg.moe_impl == "ep":
        return moe_lib.moe_forward_ep(cfg, moe_params, f_in,
                                      capacity_factor=capacity_factor)
    return moe_lib.moe_forward(cfg, moe_params, f_in,
                               capacity_factor=capacity_factor)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_attn_block(gen: torch.Generator, cfg: ModelConfig, lead=(), *,
                     moe: bool = False,
                     d_ff: Optional[int] = None) -> Dict[str, Any]:
    """One attention block (norms, attention or MLA, a gated MLP of width
    ``d_ff`` (default ``cfg.d_ff``) or with ``moe`` the experts);
    ``lead`` stacks it over the super-blocks."""
    lead, dev, dt = tuple(lead), gen.device, cfg.p_dtype
    fill = torch.zeros if cfg.norm_scale_plus_one else torch.ones
    p: Dict[str, Any] = {"ln1": fill(lead + (cfg.d_model,), dtype=dt,
                                     device=dev),
                         "ln2": fill(lead + (cfg.d_model,), dtype=dt,
                                     device=dev)}
    if cfg.norm_scale_plus_one:  # gemma: zeros init -> effective scale 1
        p["post_ln1"] = torch.zeros(lead + (cfg.d_model,), dtype=dt,
                                    device=dev)
        p["post_ln2"] = torch.zeros(lead + (cfg.d_model,), dtype=dt,
                                    device=dev)
    if cfg.use_mla:
        p["attn"] = mla_lib.init_mla(gen, cfg, lead=lead)
    else:
        p["attn"] = attn_lib.init_attention(gen, cfg, lead=lead)
    if moe:
        p["moe"] = moe_lib.init_moe(gen, cfg, lead=lead)
    else:
        p["mlp"] = init_gated_mlp(gen, cfg.d_model,
                                  d_ff if d_ff is not None else cfg.d_ff, dt,
                                  lead=lead)
    return p


def _init_mamba_block(gen, cfg: ModelConfig, lead=()) -> Dict[str, Any]:
    """A pre-norm Mamba2 block: ``ln1`` (ones, in every convention) and
    the SSD block's parameters (``mamba2.init_mamba``)."""
    lead = tuple(lead)
    return {"ln1": torch.ones(lead + (cfg.d_model,), dtype=cfg.p_dtype,
                              device=gen.device),
            "mamba": mamba_lib.init_mamba(gen, cfg, lead=lead)}


def init_params(cfg: ModelConfig, seed: int = 0,
                device=None) -> Dict[str, Any]:
    """Random parameters in the reference's tree, drawn on ``device``
    (None: the card) from a generator seeded with ``seed``; the values are
    not the reference's (carry those across with ``convert``)."""
    _check_config(cfg)
    dev = resolve_device(device)
    return _params(cfg, torch.Generator(device=dev).manual_seed(int(seed)))


class _MetaDraws:
    """Stands in for a generator on the ``meta`` device: the init
    functions then allocate and draw nothing."""
    device = torch.device("meta")


def abstract_params(cfg: ModelConfig) -> Dict[str, Any]:
    """``init_params``' tree of shapes and dtypes without memory (``meta``
    tensors)."""
    _check_config(cfg)
    return _params(cfg, _MetaDraws())


def _params(cfg: ModelConfig, gen) -> Dict[str, Any]:
    """The parameter tree, drawn from ``gen`` on its device."""
    dev = gen.device
    audio = cfg.modality == "audio"
    params: Dict[str, Any] = {"embed": embed_init(
        gen, (cfg.audio_codebooks or 1, cfg.vocab, cfg.d_model) if audio
        else (cfg.vocab, cfg.d_model), cfg.p_dtype)}
    reps = cfg.n_super_blocks
    params["layers"] = {
        f"pos{i}_{kind}": _init_mamba_block(gen, cfg, lead=(reps,))
        if kind == "mamba" else _init_attn_block(
            gen, cfg, lead=(reps,), moe=cfg.n_experts > 0)
        for i, kind in enumerate(cfg.layer_pattern) if kind != "attn_shared"}
    if "attn_shared" in cfg.layer_pattern:  # one block for every use
        params["shared_block"] = _init_attn_block(gen, cfg)
    if cfg.n_dense_layers:  # deepseek: dense-FFN prefix layers
        params["prefix_layers"] = _init_attn_block(
            gen, cfg, lead=(cfg.n_dense_layers,), d_ff=cfg.dense_d_ff)
    params["final_norm"] = (torch.zeros if cfg.norm_scale_plus_one
                            else torch.ones)((cfg.d_model,),
                                             dtype=cfg.p_dtype, device=dev)
    if audio:
        params["audio_heads"] = dense_init(
            gen, (cfg.audio_codebooks, cfg.d_model, cfg.vocab), cfg.d_model,
            cfg.p_dtype)
    elif not cfg.tie_embeddings:
        params["head"] = dense_init(gen, (cfg.d_model, cfg.vocab),
                                    cfg.d_model, cfg.p_dtype)
    if cfg.use_mtp:
        params["mtp_block"] = _init_attn_block(
            gen, cfg, d_ff=cfg.dense_d_ff or cfg.d_ff)
        params["mtp_norm"] = torch.ones((cfg.d_model,), dtype=cfg.p_dtype,
                                        device=dev)
    return params


# ---------------------------------------------------------------------------
# Forward (training)
# ---------------------------------------------------------------------------


def _norm(cfg: ModelConfig, x: torch.Tensor, scale: torch.Tensor):
    return rms_norm(x, scale, cfg.rms_eps, cfg.norm_scale_plus_one)


def _attn_sublayer(cfg: ModelConfig, p, h: torch.Tensor,
                   positions: torch.Tensor, *, window, aux,
                   q_block: int, kv_block: int, tp=None):
    """Pre-norm attention (or MLA) and MLP (or MoE, its aux added to
    ``aux``) with residuals (gemma: post-norms too); ``tp`` as in
    ``loss_fn``."""
    a_in = _norm(cfg, h, p["ln1"])
    if cfg.use_mla:
        a = mla_lib.mla_train(cfg, p["attn"], a_in, positions,
                              window=window, q_block=q_block,
                              kv_block=kv_block)
    else:
        a = attn_lib.attention_train(cfg, p["attn"], a_in, positions,
                                     window=window, q_block=q_block,
                                     kv_block=kv_block, tp=tp)
    return _ffn_sublayer(cfg, p, h, a, aux, cfg.capacity_factor, tp=tp)


def _ffn_sublayer(cfg: ModelConfig, p, h: torch.Tensor, a: torch.Tensor,
                  aux, capacity_factor: float, tp=None):
    """The block's second half after its attention output ``a``: the
    residual, then the MLP or the MoE at ``capacity_factor`` (its aux
    added to ``aux`` unless that is None, as in serving)."""
    if cfg.norm_scale_plus_one:
        a = _norm(cfg, a, p["post_ln1"])
    h = h + a
    f_in = _norm(cfg, h, p["ln2"])
    if "moe" in p:
        f, moe_aux = _moe_apply(cfg, p["moe"], f_in, capacity_factor)
        if aux is not None:
            aux = aux + moe_aux
    else:
        f = gated_mlp(p["mlp"], f_in, cfg.mlp_act, tp=tp, d_ff=cfg.d_ff)
    if cfg.norm_scale_plus_one:
        f = _norm(cfg, f, p["post_ln2"])
    return h + f, aux


def _window_for(cfg: ModelConfig, kind: str,
                window_override: Optional[int]):
    if kind == "local":
        return cfg.sliding_window
    return window_override  # None for full attention


def _vocab_lookup(embed: torch.Tensor, tok: torch.Tensor, vocab: int,
                  tp) -> torch.Tensor:
    """``embed[tok]`` for this rank's rows ``embed`` of a (vocab, D) table
    split over "model": the other ranks' tokens looked up as zeros, then
    the sum over "model"."""
    n = embed.shape[0]
    if not tp_active(tp) or n == vocab:
        return embed[tok]
    from repro_torch.launch.mesh import reduce_from_model

    local = tok - tp.rank * n
    own = (local >= 0) & (local < n)
    rows = embed[local.clamp(0, n - 1)]
    return reduce_from_model(
        torch.where(own[..., None], rows, torch.zeros_like(rows)), tp)


def _embed_inputs(cfg: ModelConfig, params, inputs,
                  tp=None) -> torch.Tensor:
    """The token embeddings: audio sums the codebooks' (B, S, D)
    embeddings with Python's ``sum``, as the reference does: ((0 + e0) +
    e1) + ..., each add rounded to the parameters' dtype (as the eager
    and the jitted reference round it); a VLM puts ``patch_embeddings``,
    cast to that dtype, in front of the text's. ``tp``: the vocabulary
    split over "model" (``_vocab_lookup``)."""
    tok = inputs["tokens"].long()
    if cfg.modality == "audio":  # tok (B, S, CB), embed (CB, V, D)
        h = sum(params["embed"][c][tok[:, :, c]]
                for c in range(cfg.audio_codebooks))
    else:
        h = _vocab_lookup(params["embed"], tok, cfg.vocab, tp)
        if cfg.modality == "vlm" and "patch_embeddings" in inputs:
            h = torch.cat([inputs["patch_embeddings"].to(h.dtype), h], dim=1)
    if cfg.norm_scale_plus_one:  # gemma: scale embeddings by sqrt(d)
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype,
                             device=h.device)
    return h.to(cfg.act_dtype)


def forward(cfg: ModelConfig, params, inputs, *,
            window_override: Optional[int] = None, remat: bool = True,
            q_block: int = 512, kv_block: int = 512, tp=None):
    """Full-sequence forward. Returns (final-normed hidden (B, S, D), aux);
    the logits are taken chunked by ``loss_fn`` / ``logits_fn``.
    ``remat`` recomputes each super-block in the backward pass
    (``torch.utils.checkpoint``); it runs under ``torch.autograd``, not
    under ``torch.func.grad``, so the round's local SGD takes it off.
    ``tp`` as in ``loss_fn``."""
    _check_config(cfg)
    h = _embed_inputs(cfg, params, inputs, tp)
    s = h.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=h.device)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)

    def super_block(h, aux, layer_slice, shared):
        for i, kind in enumerate(cfg.layer_pattern):
            if kind == "mamba":
                p = layer_slice[f"pos{i}_{kind}"]
                h = h + mamba_lib.mamba_train(cfg, p["mamba"],
                                              _norm(cfg, h, p["ln1"]))
                continue
            h, aux = _attn_sublayer(
                cfg, shared if kind == "attn_shared"
                else layer_slice[f"pos{i}_{kind}"], h, positions,
                window=_window_for(cfg, kind, window_override), aux=aux,
                q_block=q_block, kv_block=kv_block, tp=tp)
        return h, aux

    def prefix_block(h, aux, p):
        return _attn_sublayer(cfg, p, h, positions, window=window_override,
                              aux=aux, q_block=q_block, kv_block=kv_block)

    # one unbind a leaf: its backward stacks the super-blocks' gradients
    # once, where a slice per super-block would add a zero-filled gradient
    # of the whole stack per super-block (quadratic in the depth); the
    # shared block's leaves go whole to every super-block
    if cfg.n_dense_layers:  # deepseek's dense-FFN prefix, before the stack
        pslices = tree_map(lambda a: a.unbind(0), params["prefix_layers"])
        for i in range(cfg.n_dense_layers):
            p = tree_map(lambda a: a[i], pslices)
            if remat:
                h, aux = torch.utils.checkpoint.checkpoint(
                    prefix_block, h, aux, p, use_reentrant=False)
            else:
                h, aux = prefix_block(h, aux, p)
    slices = tree_map(lambda a: a.unbind(0), params["layers"])
    shared = params.get("shared_block")
    for sb in range(cfg.n_super_blocks):
        layer_slice = tree_map(lambda a: a[sb], slices)
        if remat:
            h, aux = torch.utils.checkpoint.checkpoint(
                super_block, h, aux, layer_slice, shared,
                use_reentrant=False)
        else:
            h, aux = super_block(h, aux, layer_slice, shared)
    return _norm(cfg, h, params["final_norm"]), aux


def logits_fn(cfg: ModelConfig, params, h: torch.Tensor,
              tp=None) -> torch.Tensor:
    """Full logits of a (B, S, D) hidden, softcapped: (B, S, V), or (B, S,
    CB, V) for audio. ``tp``: the head (or the tied embedding) is this
    rank's vocabulary shard, and so are the logits."""
    if cfg.modality == "audio":
        lg = torch.einsum("bsd,cdv->bscv", h, params["audio_heads"])
    else:
        w = params["embed"] if cfg.tie_embeddings else params["head"]
        if tp_active(tp) and w.numel() != cfg.vocab * cfg.d_model:
            from repro_torch.launch.mesh import copy_to_model
            h = copy_to_model(h, tp)
        lg = torch.einsum("bsd,vd->bsv" if cfg.tie_embeddings
                          else "bsd,dv->bsv", h, w)
    return softcap(lg, cfg.final_softcap)


def _gold(lg: torch.Tensor, labels: torch.Tensor, vocab: int,
          tp) -> torch.Tensor:
    """The labels' logits; of logits split over "model" (``tp``), each
    from the rank that holds its vocabulary row, summed over "model"."""
    n = lg.shape[-1]
    if not tp_active(tp) or n == vocab:
        return torch.gather(lg, -1, labels[..., None].long())[..., 0]
    from repro_torch.launch.mesh import reduce_from_model

    local = labels.long() - tp.rank * n
    own = (local >= 0) & (local < n)
    g = torch.gather(lg, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    return reduce_from_model(torch.where(own, g, torch.zeros_like(g)), tp)


def _chunked_xent(cfg: ModelConfig, params, h: torch.Tensor,
                  labels: torch.Tensor, mask: torch.Tensor,
                  chunk: int, tp=None) -> torch.Tensor:
    """Next-token cross-entropy over sequence chunks (the largest divisor
    of S not above ``chunk``), so (B, S, V) logits never exist at once.
    Audio's labels are (B, S, CB): a position's loss is the mean over its
    codebooks, taken before the mask. ``tp`` as in ``loss_fn``."""
    s = h.shape[1]
    chunk = min(chunk, s)
    while s % chunk:
        chunk -= 1
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, s, chunk):
        lg = logits_fn(cfg, params, h[:, c0:c0 + chunk],
                       tp).to(torch.float32)
        if tp_active(tp) and lg.shape[-1] != cfg.vocab:
            lse = sharded_logsumexp(lg, tp)
        else:
            lse = logsumexp(lg, dim=-1)
        gold = _gold(lg, labels[:, c0:c0 + chunk], cfg.vocab, tp)
        nll = lse - gold
        if cfg.modality == "audio":
            nll = nll.mean(-1)  # over the codebooks
        m_c = mask[:, c0:c0 + chunk]
        tot = tot + torch.sum(nll * m_c)
        cnt = cnt + torch.sum(m_c)
    if tp is not None and tp.data_size > 1:  # the batch split over "data"
        from repro_torch.launch.mesh import all_reduce_data, reduce_from_data
        tot, cnt = reduce_from_data(tot, tp), all_reduce_data(cnt, tp)
    return tot / torch.clamp(cnt, min=1.0)


def loss_fn(cfg: ModelConfig, params, batch, *,
            window_override: Optional[int] = None, remat: bool = True,
            loss_chunk: int = 1024, tp=None):
    """Causal-LM loss. batch: the inputs ({"tokens"}, + "patch_embeddings"
    for a VLM), "labels" (+ optional "loss_mask", (B, S)). A VLM scores
    only the text span, the last ``labels.shape[1]`` positions. With MTP
    (deepseek) 0.1 of the MTP head's cross-entropy on the labels shifted
    one more position (the last repeated) is added. Returns (loss +
    ``router_aux_coef`` * aux, {"xent", "aux"}).

    ``tp`` (``launch.mesh.TensorParallel``): ``params`` are this rank's
    shards of a dense attention decoder on a mesh, and ``batch`` its
    slice of a batch split over ``tp.data_size`` "data" ranks (module
    docstring); the loss is the whole batch's on every rank."""
    if tp_active(tp) and (cfg.family != "dense" or cfg.modality != "text"
                       or cfg.use_mla or cfg.n_experts
                       or any(k not in ("attn", "local", "global")
                              for k in cfg.layer_pattern)):
        raise NotImplementedError(
            f"{cfg.arch_id} on a model-parallel mesh: only the dense "
            "attention decoders are ported (ROADMAP queue A item 13b.2)")
    h, aux = forward(cfg, params, batch, window_override=window_override,
                     remat=remat, tp=tp)
    labels = batch["labels"]
    # the prefix positions of a VLM carry no labels
    h_text = h[:, -labels.shape[1]:] if cfg.modality == "vlm" else h
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(labels.shape[:2], dtype=torch.float32,
                          device=h.device)
    loss = _chunked_xent(cfg, params, h_text, labels, mask, loss_chunk, tp)
    if cfg.use_mtp:  # one depth-1 block over h predicts a token further
        positions = torch.arange(h.shape[1], dtype=torch.int32,
                                 device=h.device)
        h2, _ = _attn_sublayer(
            cfg, params["mtp_block"], h, positions, window=window_override,
            aux=torch.zeros((), dtype=torch.float32, device=h.device),
            q_block=512, kv_block=512)
        h2 = _norm(cfg, h2, params["mtp_norm"])
        mtp_labels = torch.cat([labels[:, 1:], labels[:, -1:]], dim=1)
        loss = loss + 0.1 * _chunked_xent(
            cfg, params, h2[:, -mtp_labels.shape[1]:], mtp_labels, mask,
            loss_chunk)
    return loss + cfg.router_aux_coef * aux, {"xent": loss, "aux": aux}


# ---------------------------------------------------------------------------
# Serving: cache init, prefill, decode
# ---------------------------------------------------------------------------


def _ring_write(layer_cache: dict, arrays: Dict[str, torch.Tensor], s: int,
                window: Optional[int]) -> None:
    """Write full-sequence tensors (B, S, ...) into a layer's (ring) cache
    of w slots, in place: only the last ``min(S, w)`` positions, position
    i at slot ``i % w``; ``slot_pos`` gets their positions."""
    w = layer_cache["slot_pos"].shape[0]
    wk = min(s, w)
    dev = layer_cache["slot_pos"].device
    idxs = torch.arange(s - wk, s, dtype=torch.int64, device=dev)
    slots = idxs % w
    for name, x in arrays.items():
        layer_cache[name].index_copy_(
            1, slots, x[:, s - wk:].to(layer_cache[name].dtype))
    layer_cache["slot_pos"].index_copy_(0, slots, idxs.to(torch.int32))


def _attn_sublayer_prefill(cfg: ModelConfig, p, h: torch.Tensor,
                           positions: torch.Tensor, *, window, layer_cache,
                           q_block: int, kv_block: int) -> torch.Tensor:
    """``_attn_sublayer`` that also fills the layer's cache (in place):
    keys and values, or MLA's latents ``ckv`` and ``k_rope``."""
    s = h.shape[1]
    a_in = _norm(cfg, h, p["ln1"])
    if cfg.use_mla:
        a, (ckv, k_rope) = mla_lib.mla_train(
            cfg, p["attn"], a_in, positions, window=window, q_block=q_block,
            kv_block=kv_block, return_latents=True)
        _ring_write(layer_cache, {"ckv": ckv, "k_rope": k_rope}, s, window)
    else:
        a, (k, v) = attn_lib.attention_train(
            cfg, p["attn"], a_in, positions, window=window, q_block=q_block,
            kv_block=kv_block, return_kv=True)
        _ring_write(layer_cache, {"k": k, "v": v}, s, window)
    return _ffn_sublayer(cfg, p, h, a, None, cfg.capacity_factor)[0]


def _layer_cache(entry: dict, i: int) -> dict:
    """Layer ``i``'s slice of a stacked cache entry (views)."""
    return {name: t[i] for name, t in entry.items()}


@torch.no_grad()
def prefill(cfg: ModelConfig, params, inputs, *,
            max_len: Optional[int] = None,
            window_override: Optional[int] = None, q_block: int = 512,
            kv_block: int = 512):
    """Process a full prompt (a VLM's ``patch_embeddings`` included, in
    front): returns (the last position's logits (B, 1, V), or (B, 1, CB,
    V) for audio, the filled cache). ``max_len`` (default the prompt's
    length) sizes the caches of the layers without a window; a prompt
    longer than a layer's ring leaves its last w positions there; a mamba
    layer leaves its final SSM state and its last W - 1 raw conv inputs.
    ``q_block`` and ``kv_block`` must divide the prompt's length, as in
    ``forward``."""
    _check_config(cfg)
    h = _embed_inputs(cfg, params, inputs)
    b, s, _ = h.shape
    max_len = max_len if max_len is not None else s
    positions = torch.arange(s, dtype=torch.int32, device=h.device)
    cache = init_cache(cfg, b, max_len, window_override, device=h.device)
    for i in range(cfg.n_dense_layers):  # deepseek's prefix, before the stack
        h = _attn_sublayer_prefill(
            cfg, tree_map(lambda a: a[i], params["prefix_layers"]), h,
            positions, window=window_override,
            layer_cache=_layer_cache(cache["prefix"], i), q_block=q_block,
            kv_block=kv_block)
    for sb in range(cfg.n_super_blocks):
        for i, kind in enumerate(cfg.layer_pattern):
            key = f"pos{i}_{kind}"
            layer_cache = _layer_cache(cache["layers"][key], sb)
            if kind == "mamba":
                p = tree_map(lambda a: a[sb], params["layers"][key])
                out, filled = mamba_lib.mamba_train(
                    cfg, p["mamba"], _norm(cfg, h, p["ln1"]),
                    return_cache=True)
                for name, t in filled.items():
                    layer_cache[name].copy_(t)
                h = h + out
                continue
            h = _attn_sublayer_prefill(
                cfg, _block_params(params, key, kind, sb), h, positions,
                window=_window_for(cfg, kind, window_override),
                layer_cache=layer_cache, q_block=q_block,
                kv_block=kv_block)
    h = _norm(cfg, h[:, -1:], params["final_norm"])
    return logits_fn(cfg, params, h), cache


def _block_params(params, key: str, kind: str, sb: int):
    """An attention position's parameters in super-block ``sb``: the
    shared block itself for ``attn_shared``, else its slice of the
    stack."""
    if kind == "attn_shared":
        return params["shared_block"]
    return tree_map(lambda a: a[sb], params["layers"][key])


def _position_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                    window_override: Optional[int], reps: int, device):
    if kind == "mamba":
        one = mamba_lib.init_mamba_cache(cfg, batch, device)
    elif cfg.use_mla:
        one = mla_lib.init_mla_cache(
            cfg, batch, max_len, _window_for(cfg, kind, window_override),
            device=device)
    else:
        one = attn_lib.init_attn_cache(
            cfg, batch, max_len, _window_for(cfg, kind, window_override),
            device=device)
    return {name: t[None].expand((reps,) + t.shape).clone()
            for name, t in one.items()}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               window_override: Optional[int] = None, device=None):
    """Empty caches, one entry per pattern position, each leaf stacked over
    the super-blocks (leading dim ``n_super_blocks``), and with a dense
    prefix ``"prefix"`` stacked over its layers, on ``device`` (None: the
    card). An MLA layer holds its latents (``mla.init_mla_cache``)."""
    _check_config(cfg)
    dev = resolve_device(device)
    cache = {"layers": {
        f"pos{i}_{kind}": _position_cache(cfg, kind, batch, max_len,
                                          window_override,
                                          cfg.n_super_blocks, dev)
        for i, kind in enumerate(cfg.layer_pattern)}}
    if cfg.n_dense_layers:
        cache["prefix"] = _position_cache(cfg, "attn", batch, max_len,
                                          window_override,
                                          cfg.n_dense_layers, dev)
    return cache


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int,
                   window_override: Optional[int] = None):
    """``init_cache``'s shapes and dtypes without memory (``meta``
    tensors)."""
    return init_cache(cfg, batch, max_len, window_override,
                      device=torch.device("meta"))


def _decode_sublayer(cfg: ModelConfig, kind: str, p, h: torch.Tensor,
                     layer_cache: dict, pos: int,
                     window_override: Optional[int]) -> torch.Tensor:
    if kind == "mamba":
        out, _ = mamba_lib.mamba_decode(cfg, p["mamba"],
                                        _norm(cfg, h, p["ln1"]), layer_cache)
        return h + out
    a_in = _norm(cfg, h, p["ln1"])
    decode = mla_lib.mla_decode if cfg.use_mla else attn_lib.attention_decode
    a, _ = decode(cfg, p["attn"], a_in, layer_cache, pos,
                  window=_window_for(cfg, kind, window_override))
    # decode capacity: no drops (n_experts / top_k) unless the config sets
    # a serving factor
    dcf = (cfg.decode_capacity_factor
           if cfg.decode_capacity_factor is not None
           else cfg.n_experts / max(cfg.experts_per_token, 1))
    return _ffn_sublayer(cfg, p, h, a, None, dcf)[0]


@torch.no_grad()
def decode_step(cfg: ModelConfig, params, cache, inputs, pos: int, *,
                window_override: Optional[int] = None):
    """One-token decode through the whole stack. inputs: {"tokens": (B,
    1)}, or (B, 1, CB) for audio (a VLM decodes text only, its prefix in
    the cache); ``pos`` the token's absolute position (a Python int,
    counting a VLM's prefix). Returns (logits (B, 1, V), or (B, 1, CB, V)
    for audio, ``cache``, written in place)."""
    _check_config(cfg)
    pos = int(pos)
    h = _embed_inputs(cfg, params, inputs)
    for i in range(cfg.n_dense_layers):  # deepseek's prefix, before the stack
        h = _decode_sublayer(
            cfg, "attn", tree_map(lambda a: a[i], params["prefix_layers"]),
            h, _layer_cache(cache["prefix"], i), pos, window_override)
    for sb in range(cfg.n_super_blocks):
        for i, kind in enumerate(cfg.layer_pattern):
            key = f"pos{i}_{kind}"
            h = _decode_sublayer(
                cfg, kind, _block_params(params, key, kind, sb), h,
                _layer_cache(cache["layers"][key], sb), pos, window_override)
    h = _norm(cfg, h, params["final_norm"])
    return logits_fn(cfg, params, h), cache
