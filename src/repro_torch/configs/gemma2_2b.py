"""gemma2-2b [dense] — 26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000.
Alternating local(4096-window)/global attention, logit softcaps (attn 50,
final 30), gemma conventions: (1+s) norms, post-norms, sqrt(d) embedding
scale, tied embeddings, head_dim=256 [arXiv:2408.00118].

Counterpart of ``repro/configs/gemma2_2b.py``: the same published config
and the same reduced variant."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    vocab=256000,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    rope_theta=10_000.0,
    layer_pattern=("local", "global"),
    sliding_window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    norm_scale_plus_one=True,
    tie_embeddings=True,
    d_ff=9216,
    mlp_act="gelu",
    dtype="bfloat16",
    param_dtype="bfloat16",
)

REDUCED = CONFIG.replace(
    arch_id="gemma2-2b-reduced",
    n_layers=2, d_model=256, vocab=512, n_heads=4, n_kv_heads=2, head_dim=64,
    d_ff=512, sliding_window=128, dtype="float32", param_dtype="float32",
)
