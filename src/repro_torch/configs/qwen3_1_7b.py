"""Qwen3-1.7B dense decoder [hf:Qwen/Qwen3-8B family card, 1.7B entry].

28 layers, d_model=2048, 16 heads (GQA kv=8), head_dim=128, d_ff=6144,
vocab=151936, with QK-norm (the Qwen3 signature). A copy of
``repro.configs.qwen3_1_7b``.
"""
from repro_torch.configs.base import SA, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151936,
    pattern=(SA,),
    n_repeats=28,
    qk_norm=True,
    rope="standard",
    rope_theta=1000000.0,
    norm="rmsnorm",
    act="silu",
    glu=True,
    tie_embeddings=True,
    sub_quadratic=False,
    source="hf:Qwen/Qwen3-8B",
)
