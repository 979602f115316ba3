"""deepseek-v3-671b [moe] — 61L d_model=7168 128H, MLA (q_lora 1536,
kv_lora 512, nope 128, rope 64, v 128), 1 shared + 256 routed experts top-8
(expert d_ff=2048), sigmoid router with routed_scaling 2.5, 3 dense-FFN
prefix layers (d_ff 18432), MTP head, vocab=129280 [arXiv:2412.19437].

Counterpart of ``repro/configs/deepseek_v3_671b.py``: the same published
config and the same reduced variant. As in the reference, the parameter
tree stacks ``n_layers`` routed layers and adds the ``n_dense_layers``
prefix layers in front of them (64 layers, 706,131,752,960 parameters),
while ``param_count`` counts the prefix as replacing routed layers."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    vocab=129280,
    n_heads=128,
    n_kv_heads=128,
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    rope_theta=10_000.0,
    layer_pattern=("attn",),
    n_dense_layers=3,
    dense_d_ff=18432,
    d_ff=2048,
    n_experts=256,
    experts_per_token=8,
    d_ff_expert=2048,
    n_shared_experts=1,
    router_type="sigmoid",
    decode_capacity_factor=2.0,
    routed_scaling=2.5,
    use_mtp=True,
    dtype="bfloat16",
    param_dtype="bfloat16",
)

REDUCED = CONFIG.replace(
    arch_id="deepseek-v3-671b-reduced",
    n_layers=2, n_dense_layers=1, dense_d_ff=256, d_model=256, vocab=512,
    n_heads=4, n_kv_heads=4, q_lora_rank=64, kv_lora_rank=32,
    qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
    d_ff=128, n_experts=4, experts_per_token=2, d_ff_expert=128,
    capacity_factor=2.0,  # reduced smoke configs: no token drops
    decode_capacity_factor=None,
    dtype="float32", param_dtype="float32",
)
