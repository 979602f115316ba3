"""ModelConfig: one declarative dataclass covering the full assigned pool.

Counterpart of ``repro/models/config.py``, field for field, so a config
compares equal across the two packages. Families: dense (llama/qwen/
gemma-style decoders), moe (routed experts, optionally MLA), ssm
(Mamba2/SSD), hybrid (Mamba2 + shared attention blocks), vlm / audio (text
backbone consuming stubbed frontend embeddings); the port runs every
family (``models.transformer``).
Dtypes are names here, as in the reference; ``act_dtype`` and ``p_dtype``
give the torch dtypes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    vocab: int

    # ---- attention ----
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0  # 0 -> d_model // n_heads
    qk_norm: bool = False
    attn_bias: bool = False  # qwen1.5-style qkv bias
    attn_softcap: Optional[float] = None  # gemma2: 50.0
    final_softcap: Optional[float] = None  # gemma2: 30.0
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None  # window for "local" layers
    layer_pattern: Tuple[str, ...] = ("attn",)  # repeating super-block pattern
    attn_logit_scale: Optional[float] = None  # override 1/sqrt(head_dim)

    # ---- mlp ----
    d_ff: int = 0
    mlp_act: str = "silu"  # silu (swiglu) | gelu

    # ---- moe ----
    n_experts: int = 0
    experts_per_token: int = 0
    d_ff_expert: int = 0
    n_shared_experts: int = 0
    n_dense_layers: int = 0  # leading layers with dense FFN (deepseek)
    dense_d_ff: int = 0
    router_aux_coef: float = 0.001
    router_type: str = "softmax"  # softmax | sigmoid (deepseek)
    routed_scaling: float = 1.0  # deepseek routed_scaling_factor
    capacity_factor: float = 1.25  # train-time expert capacity
    # serving-time capacity factor; None -> n_experts/top_k (no drops ever,
    # exact but dense-cost — used by the correctness tests). Full MoE configs
    # set 2.0: realistic serving capacity, drops only under >2x router skew.
    decode_capacity_factor: Optional[float] = None
    # MoE execution strategy: "gspmd" (global sort/scatter dispatch, compiler-
    # sharded) or "ep" (explicit expert parallelism: shard_map + all_to_all —
    # the §Perf hillclimb path; requires set_ep_mesh and divisible batches).
    moe_impl: str = "gspmd"

    # ---- MLA (deepseek) ----
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # ---- MTP (deepseek) ----
    use_mtp: bool = False

    # ---- mamba2 / SSD ----
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_ngroups: int = 1
    ssm_chunk: int = 256

    # ---- embeddings / frontends ----
    tie_embeddings: bool = False
    modality: str = "text"  # text | audio | vlm
    n_prefix_embeddings: int = 0  # vlm: image patch embeddings prepended
    audio_codebooks: int = 0  # musicgen: parallel codebook heads

    # ---- numerics ----
    rms_eps: float = 1e-6
    dtype: str = "float32"  # activation dtype
    param_dtype: str = "float32"
    norm_scale_plus_one: bool = False  # gemma convention: (1 + scale)

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def act_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def p_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def pattern_len(self) -> int:
        return len(self.layer_pattern)

    @property
    def n_super_blocks(self) -> int:
        n, p = self.n_layers, self.pattern_len
        if n % p:
            raise ValueError(f"{self.arch_id}: n_layers={n} not divisible by pattern {self.layer_pattern}")
        return n // p

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def has_attention(self) -> bool:
        return any(k.startswith("attn") or k == "local" or k == "global" for k in self.layer_pattern)

    def has_mamba(self) -> bool:
        return any(k == "mamba" for k in self.layer_pattern)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # Parameter count estimate (for byte accounting / roofline MODEL_FLOPS).
    def param_count(self) -> int:
        d, hd = self.d_model, self.hd
        n_attn = sum(1 for k in self.layer_pattern if k in ("attn", "local", "global", "attn_shared"))
        n_mamba = sum(1 for k in self.layer_pattern if k == "mamba")
        reps = self.n_super_blocks
        total = self.vocab * d  # embed
        if not self.tie_embeddings:
            total += self.vocab * d * max(1, self.audio_codebooks or 1)
        per_attn = 0
        if self.use_mla:
            per_attn += d * self.q_lora_rank + self.q_lora_rank * self.n_heads * (
                self.qk_nope_head_dim + self.qk_rope_head_dim)
            per_attn += d * (self.kv_lora_rank + self.qk_rope_head_dim)
            per_attn += self.kv_lora_rank * self.n_heads * (self.qk_nope_head_dim + self.v_head_dim)
            per_attn += self.n_heads * self.v_head_dim * d
        elif self.has_attention():
            per_attn += d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        per_mlp_dense = 3 * d * (self.d_ff or 1)
        per_moe = self.n_experts * 3 * d * self.d_ff_expert + d * self.n_experts
        per_moe += self.n_shared_experts * 3 * d * self.d_ff_expert
        per_mamba = d * (2 * self.d_inner + 2 * self.ssm_ngroups * self.ssm_state + self.ssm_nheads)
        per_mamba += self.d_inner * d + self.ssm_nheads * 2 + self.d_inner

        total_layers = 0
        shared_attn_counted = False
        for k in self.layer_pattern:
            if k == "mamba":
                total_layers += per_mamba * reps
            elif k == "attn_shared":
                if not shared_attn_counted:
                    total_layers += per_attn + per_mlp_dense  # shared: counted once
                    shared_attn_counted = True
            elif k in ("attn", "local", "global"):
                layer = per_attn
                if self.n_experts:
                    layer += per_moe
                else:
                    layer += per_mlp_dense
                total_layers += layer * reps
        # deepseek: first n_dense_layers use dense FFN instead of MoE
        if self.n_dense_layers and self.n_experts:
            total_layers += self.n_dense_layers * (3 * d * self.dense_d_ff - per_moe)
        total += total_layers
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed top-k experts count)."""
        if not self.n_experts:
            return self.param_count()
        full = self.param_count()
        inactive_frac_experts = (self.n_experts - self.experts_per_token)
        per_expert = 3 * self.d_model * self.d_ff_expert
        n_moe_layers = self.n_layers - self.n_dense_layers
        return int(full - n_moe_layers * inactive_frac_experts * per_expert)
