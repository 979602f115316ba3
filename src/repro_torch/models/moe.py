"""Mixture-of-Experts layer: top-k router and sort-based capacity dispatch.

Counterpart of ``repro/models/moe.py``. Routers: "softmax" (Qwen3-MoE:
softmax gate, renormalized top-k) and "sigmoid" (DeepSeek-V3: sigmoid
scores, renormalized top-k, ``routed_scaling``). Shared experts (DeepSeek)
are a dense gated MLP added to every token. A switch-style load-balance
auxiliary loss, ``E * sum_e f_e * P_e``, is returned beside the output.

The reference's semantics, each kept:

* **top-k** is ``jax.lax.top_k``: the k largest, larger first, a tie's
  lower index first (a stable descending sort, cut at k).
* **capacity** ``max(1, int(factor * T * k / E))`` slots an expert; the
  token copies (T * k, token-major) are sorted by expert, stably, and each
  expert keeps its first ``capacity`` copies: the lowest token indices.
  Dropped copies add nothing.
* **the combine** adds a token's k gated copies ``(y * gate)`` rounded to
  the activation dtype into a zero row *in the activation dtype*, each add
  rounded, in the sorted order: ascending expert within a token (the
  reference's ``.at[sorted_tok].add``, whose XLA:CPU scatter loop runs
  over the updates in order), then multiplies by ``routed_scaling``.

The port's dispatch gathers where the reference scatters: slot c of
expert e holds the (start_e + c)-th sorted copy when c < count_e, so the
(E, capacity, D) expert buffer is built without a scatter or a duplicate
index, and the combine reads each kept copy's row back by its slot. The
expert FFN's three products are batched matrix products over the experts
(``torch.einsum``), run in groups of experts whose buffer stays under
``EXPERT_GROUP_BYTES`` (one group unless a no-drop capacity meets a long
prompt); the groups change no value. Their activation is silu by the
reference's law (``layers.silu``), as the dense MLPs take it.

``moe_forward_ep`` (expert parallelism, shard_map + all_to_all in the
reference) is ROADMAP queue A item 13b.2 and raises naming it.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (dense_init, gated_mlp, init_gated_mlp,
                                      silu)

# the largest (experts, capacity, max(D, F)) buffer of one expert group
EXPERT_GROUP_BYTES = 1 << 30


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype=None,
             lead=()) -> dict:
    """The router (D, E), the experts' ``w_gate``, ``w_up`` (E, D, F) and
    ``w_down`` (E, F, D) and, with shared experts, their gated MLP of width
    ``n_shared_experts * F``; ``lead`` prepends stacked super-block dims."""
    dtype = dtype or cfg.p_dtype
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    lead = tuple(lead)
    p = {
        "router": dense_init(gen, lead + (d, e), d, dtype),
        "w_gate": dense_init(gen, lead + (e, d, f), d, dtype),
        "w_up": dense_init(gen, lead + (e, d, f), d, dtype),
        "w_down": dense_init(gen, lead + (e, f, d), f, dtype),
    }
    if cfg.n_shared_experts:
        p["shared"] = init_gated_mlp(gen, d, cfg.n_shared_experts * f, dtype,
                                     lead=lead)
    return p


def top_k(scores: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: (values, indices) of the k
    largest, larger first, equal values in ascending index."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(cfg: ModelConfig, router_w: torch.Tensor, x2d: torch.Tensor):
    """x2d: (T, D) -> (gates (T, k), expert ids (T, k), probs (T, E)), all
    in f32 but the ids (int64)."""
    logits = torch.einsum("td,de->te", x2d.to(torch.float32),
                          router_w.to(torch.float32))
    k = cfg.experts_per_token
    if cfg.router_type == "sigmoid":
        scores = torch.sigmoid(logits)
        gates, ids = top_k(scores, k)
        probs = scores / torch.clamp(scores.sum(-1, keepdim=True), min=1e-20)
    else:
        probs = torch.softmax(logits, dim=-1)
        gates, ids = top_k(probs, k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-20)
    return gates, ids, probs


def capacity(cfg: ModelConfig, tokens: int, capacity_factor: float) -> int:
    """Slots an expert: ``max(1, int(factor * T * k / E))``, the
    reference's Python arithmetic."""
    return max(1, int(capacity_factor * tokens * cfg.experts_per_token
                      / cfg.n_experts))


def dispatch(ids: torch.Tensor, n_experts: int, cap: int) -> dict:
    """The capacity dispatch of (T, k) expert ids: the copies sorted by
    expert, stably over the token-major order. With ``pos`` (T, k) each
    copy's rank among its expert's copies, returns ``keep`` (T, k), ``pos
    < cap``; ``slot`` (T, k), ``expert * cap + pos``; and, per expert,
    ``tok`` (E, cap) the token in each slot and ``filled`` (E, cap)
    whether the slot holds a copy."""
    t, k = ids.shape
    flat = ids.reshape(-1)
    order = torch.argsort(flat, stable=True)
    sorted_e = flat[order]
    experts = torch.arange(n_experts, device=ids.device)
    starts = torch.searchsorted(sorted_e, experts)
    counts = torch.searchsorted(sorted_e, experts, right=True) - starts
    pos = torch.empty_like(order).scatter_(
        0, order, torch.arange(t * k, device=ids.device) - starts[sorted_e])
    pos = pos.reshape(t, k)
    c = torch.arange(cap, device=ids.device)
    src = torch.clamp(starts[:, None] + c, max=t * k - 1)
    return {"keep": pos < cap, "slot": ids * cap + pos,
            "tok": order[src] // k, "filled": c < counts[:, None]}


def _expert_ffn(params, xe: torch.Tensor, e0: int, e1: int) -> torch.Tensor:
    """Experts [e0, e1)'s gated FFN over their (G, C, D) buffer."""
    whole = e0 == 0 and e1 == params["w_gate"].shape[0]
    w = {n: params[n] if whole else params[n][e0:e1]
         for n in ("w_gate", "w_up", "w_down")}
    g = torch.einsum("ecd,edf->ecf", xe, w["w_gate"])
    u = torch.einsum("ecd,edf->ecf", xe, w["w_up"])
    h = silu(g.to(torch.float32)).to(xe.dtype) * u
    return torch.einsum("ecf,efd->ecd", h, w["w_down"])


def _copy_outputs(params, x2d: torch.Tensor, ids: torch.Tensor,
                  disp: dict, cap: int) -> torch.Tensor:
    """(T, k, D) in x2d's dtype: each kept copy's expert output, zeros
    for the dropped ones; the experts run in groups of at most
    ``EXPERT_GROUP_BYTES`` of buffer."""
    e = params["w_gate"].shape[0]
    t, k = ids.shape
    width = max(x2d.shape[1], params["w_gate"].shape[2])
    group = max(1, min(e, EXPERT_GROUP_BYTES
                       // (cap * width * x2d.element_size())))
    y = torch.zeros((t, k, x2d.shape[1]), dtype=x2d.dtype, device=x2d.device)
    for e0 in range(0, e, group):
        e1 = min(e, e0 + group)
        xe = torch.where(disp["filled"][e0:e1, :, None],
                         x2d[disp["tok"][e0:e1]], 0.0)
        ye = _expert_ffn(params, xe, e0, e1).reshape(-1, x2d.shape[1])
        inside = disp["keep"] & (ids >= e0) & (ids < e1)
        rows = torch.clamp(disp["slot"] - e0 * cap, 0, ye.shape[0] - 1)
        y = torch.where(inside[..., None], ye[rows], y)
    return y


def combine(y: torch.Tensor, gates: torch.Tensor) -> torch.Tensor:
    """(T, k, D) copy outputs (in ascending expert within a token, zeros
    for the dropped copies) and their (T, k) f32 gates -> (T, D) in y's
    dtype: ``(y * gate)`` rounded to that dtype, added from +0 in copy
    order, each add rounded (the reference's scatter-add order)."""
    terms = (y.to(torch.float32) * gates[..., None]).to(y.dtype)
    out = torch.zeros_like(terms[:, 0])
    for j in range(terms.shape[1]):
        out = out + terms[:, j]
    return out


def moe_forward(cfg: ModelConfig, params, x: torch.Tensor, *,
                capacity_factor: float = 1.25
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D) in x's dtype, the aux load-balance
    loss, an f32 scalar)."""
    b, s, d = x.shape
    t = b * s
    e = cfg.n_experts
    x2d = x.reshape(t, d)
    gates, ids, probs = _route(cfg, params["router"], x2d)
    # each token's copies in ascending expert: the order the reference's
    # scatter-add takes them in; the dispatch does not depend on it
    ids_s, perm = torch.sort(ids, dim=-1)
    gates_s = torch.gather(gates, -1, perm)
    cap = capacity(cfg, t, capacity_factor)
    disp = dispatch(ids_s, e, cap)
    y = _copy_outputs(params, x2d, ids_s, disp, cap)
    out = combine(y, gates_s).reshape(b, s, d) * cfg.routed_scaling
    if cfg.n_shared_experts:
        out = out + gated_mlp(params["shared"], x, cfg.mlp_act)
    # switch-style load-balance aux: E * sum_e f_e * P_e
    f_e = torch.bincount(ids.reshape(-1), minlength=e).to(torch.float32) \
        / (t * ids.shape[1])
    p_e = probs.mean(dim=0)
    aux = e * torch.sum(f_e * p_e)
    return out, aux


def set_ep_mesh(mesh) -> None:
    """The expert-parallel mesh (ROADMAP queue A item 13b.2): raises."""
    raise NotImplementedError("the expert-parallel MoE (moe_impl='ep') is "
                              "ROADMAP queue A item 13b.2")


def moe_forward_ep(cfg: ModelConfig, params, x, *,
                   capacity_factor: float = 1.25, data_axis: str = "data"):
    """The expert-parallel MoE (shard_map + all_to_all in the reference):
    ROADMAP queue A item 13b.2; raises."""
    raise NotImplementedError("the expert-parallel MoE (moe_impl='ep') is "
                              "ROADMAP queue A item 13b.2")
