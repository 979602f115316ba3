"""granite-34b [dense] — 88L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152. Llama-architecture code model [arXiv:2405.04324].

Counterpart of ``repro/configs/granite_34b.py``: the same published config
and the same reduced variant."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    vocab=49152,
    n_heads=48,
    n_kv_heads=1,
    head_dim=128,
    rope_theta=10_000.0,
    layer_pattern=("attn",),
    d_ff=24576,
    dtype="bfloat16",
    param_dtype="bfloat16",
)

REDUCED = CONFIG.replace(
    arch_id="granite-34b-reduced",
    n_layers=2, d_model=256, vocab=512, n_heads=4, n_kv_heads=1, head_dim=64,
    d_ff=512, dtype="float32", param_dtype="float32",
)
