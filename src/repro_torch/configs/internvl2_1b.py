"""internvl2-1b [vlm] — 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655. Qwen2-0.5B language backbone; the InternViT-300M vision
encoder + MLP projector are STUBBED: input_specs provides 256 precomputed
patch embeddings of width d_model prepended to the text sequence
[arXiv:2404.16821].

Counterpart of ``repro/configs/internvl2_1b.py``: the same published config
and the same reduced variant."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="internvl2-1b",
    family="vlm",
    modality="vlm",
    n_prefix_embeddings=256,
    n_layers=24,
    d_model=896,
    vocab=151655,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    attn_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    layer_pattern=("attn",),
    d_ff=4864,
    dtype="bfloat16",
    param_dtype="bfloat16",
)

REDUCED = CONFIG.replace(
    arch_id="internvl2-1b-reduced",
    n_layers=2, d_model=256, vocab=512, n_heads=4, n_kv_heads=2, head_dim=64,
    d_ff=512, n_prefix_embeddings=16, dtype="float32", param_dtype="float32",
)
