"""codeqwen1.5-7b [dense] — 32L d_model=4096 32H (kv=32, full MHA)
d_ff=13440 vocab=92416. Qwen1.5 architecture: qkv bias, rope 1e6.
[hf:Qwen/CodeQwen1.5-7B].

Counterpart of ``repro/configs/codeqwen15_7b.py``: the same published config
and the same reduced variant."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    vocab=92416,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    attn_bias=True,
    rope_theta=1_000_000.0,
    layer_pattern=("attn",),
    d_ff=13440,
    dtype="bfloat16",
    param_dtype="bfloat16",
)

REDUCED = CONFIG.replace(
    arch_id="codeqwen1.5-7b-reduced",
    n_layers=2, d_model=256, vocab=512, n_heads=4, n_kv_heads=4, head_dim=64,
    d_ff=512, dtype="float32", param_dtype="float32",
)
