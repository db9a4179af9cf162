"""DeepSeek-V2-Lite (16B total / 2.4B active) MoE with MLA [arXiv:2405.04434].

27 layers, d_model=2048, 16 heads MLA (kv_lora_rank=512, rope_head=64,
nope_head=128, v_head=128), vocab=102400. Layer 0 is a dense MLP
(d_ff=10944); layers 1..26 are MoE with 2 shared + 64 routed experts, top-6,
expert d_ff=1408. The model card has 64 routed experts. A copy of
``repro.configs.deepseek_v2_lite_16b``.
"""
from repro_torch.configs.base import MLA_D, MLA_MOE, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,  # MLA: per-head latent
    head_dim=128,
    d_ff=10944,  # dense layer-0 MLP; expert FF below
    vocab_size=102400,
    prefix=(MLA_D,),
    pattern=(MLA_MOE,),
    n_repeats=26,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    d_ff_expert=1408,
    kv_lora_rank=512,
    q_lora_rank=0,  # V2-Lite has no Q compression
    rope_head_dim=64,
    nope_head_dim=128,
    v_head_dim=128,
    rope="standard",
    rope_theta=10000.0,
    norm="rmsnorm",
    act="silu",
    glu=True,
    sub_quadratic=False,
    source="arXiv:2405.04434",
)
