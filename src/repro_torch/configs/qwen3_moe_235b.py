"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4) expert d_ff=1536
vocab=151936, MoE 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B family scaled per
assignment; qk-norm, decoupled head_dim=128, softmax router].

Counterpart of ``repro/configs/qwen3_moe_235b.py``: the same published
config and the same reduced variant (4 experts, top-2, capacity factor 2.0:
no token drops)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    vocab=151936,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    layer_pattern=("attn",),
    d_ff=1536,
    n_experts=128,
    experts_per_token=8,
    d_ff_expert=1536,
    router_type="softmax",
    decode_capacity_factor=2.0,
    dtype="bfloat16",
    param_dtype="bfloat16",
)

REDUCED = CONFIG.replace(
    arch_id="qwen3-moe-235b-a22b-reduced",
    n_layers=2, d_model=256, vocab=512, n_heads=4, n_kv_heads=2, head_dim=64,
    d_ff=128, n_experts=4, experts_per_token=2, d_ff_expert=128,
    capacity_factor=2.0,  # reduced smoke configs: no token drops
    decode_capacity_factor=None,
    dtype="float32", param_dtype="float32",
)
