"""zamba2-7b [hybrid] — 81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000,
ssm_state=64. Mamba2 backbone with a SHARED attention block applied every
third layer (super-block = mamba, mamba, attn_shared; the single attention
block's weights are reused at all 27 occurrences) [arXiv:2411.15242].
Simplification noted in DESIGN.md: Zamba2's per-invocation LoRA deltas on
the shared block are omitted.

Counterpart of ``repro/configs/zamba2_7b.py``: the same published config
and the same reduced variant. Full MHA with head_dim 112, no window,
untied embeddings (``head``); bf16 parameters with 3 x 112 heads x 54
mamba layers = 18,144 f32 coordinates (``A_log``, ``D``, ``dt_bias``)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    vocab=32000,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    rope_theta=10_000.0,
    layer_pattern=("mamba", "mamba", "attn_shared"),
    d_ff=14336,
    ssm_state=64,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_conv=4,
    ssm_ngroups=1,
    ssm_chunk=256,
    dtype="bfloat16",
    param_dtype="bfloat16",
)

REDUCED = CONFIG.replace(
    arch_id="zamba2-7b-reduced",
    n_layers=3, d_model=256, vocab=512, n_heads=4, n_kv_heads=4, head_dim=64,
    d_ff=512, ssm_state=32, ssm_headdim=32, ssm_chunk=32,
    dtype="float32", param_dtype="float32",
)
