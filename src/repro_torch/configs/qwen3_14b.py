"""qwen3-14b [dense] — 40L d_model=5120 40H (GQA kv=8) d_ff=17408
vocab=151936. qk-norm, decoupled head_dim=128 [hf:Qwen/Qwen3-8B family].

Counterpart of ``repro/configs/qwen3_14b.py``: the same published config
and the same reduced variant."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    vocab=151936,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    layer_pattern=("attn",),
    d_ff=17408,
    dtype="bfloat16",
    param_dtype="bfloat16",
)

REDUCED = CONFIG.replace(
    arch_id="qwen3-14b-reduced",
    n_layers=2, d_model=256, vocab=512, n_heads=4, n_kv_heads=2, head_dim=64,
    d_ff=512, dtype="float32", param_dtype="float32",
)
