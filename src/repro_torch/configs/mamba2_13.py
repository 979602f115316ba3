"""mamba2-1.3b [ssm] — 48L d_model=2048 attention-free, vocab=50280,
ssm_state=128. SSD (state-space duality) [arXiv:2405.21060]. expand=2 ->
d_inner=4096, headdim=64 -> 64 SSD heads, depthwise conv width 4.

Counterpart of ``repro/configs/mamba2_13.py``: the same published config
and the same reduced variant. bf16 parameters, but ``A_log``, ``D`` and
``dt_bias`` are f32 (``models.mamba2.init_mamba``): 3 x 64 heads x 48
layers = 9,216 f32 coordinates in a mixed tree."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    vocab=50280,
    layer_pattern=("mamba",),
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_conv=4,
    ssm_ngroups=1,
    ssm_chunk=256,
    tie_embeddings=True,
    dtype="bfloat16",
    param_dtype="bfloat16",
)

REDUCED = CONFIG.replace(
    arch_id="mamba2-1.3b-reduced",
    n_layers=2, d_model=256, vocab=512, ssm_state=32, ssm_headdim=32,
    ssm_chunk=32, dtype="float32", param_dtype="float32",
)
