"""musicgen-large [audio] — 48L d_model=2048 32H (kv=32) d_ff=8192 vocab=2048.
Decoder-only LM over EnCodec tokens [arXiv:2306.05284]. The EnCodec frontend
is stubbed: the LM consumes 4 parallel codebook token streams whose embeddings
are summed (MusicGen's own input scheme), with one output head per codebook.
Adaptation note: sinusoidal positions -> RoPE (the reference's choice,
DESIGN.md).

Counterpart of ``repro/configs/musicgen_large.py``: the same published config
and the same reduced variant."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="musicgen-large",
    family="audio",
    modality="audio",
    audio_codebooks=4,
    n_layers=48,
    d_model=2048,
    vocab=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    rope_theta=10_000.0,
    layer_pattern=("attn",),
    d_ff=8192,
    mlp_act="gelu",
    dtype="bfloat16",
    param_dtype="bfloat16",
)

REDUCED = CONFIG.replace(
    arch_id="musicgen-large-reduced",
    n_layers=2, d_model=256, vocab=256, n_heads=4, n_kv_heads=4, head_dim=64,
    d_ff=512, dtype="float32", param_dtype="float32",
)
