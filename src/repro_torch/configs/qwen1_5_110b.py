"""Qwen1.5-110B dense decoder [hf:Qwen/Qwen1.5-0.5B family card, scaled entry].

80 layers, d_model=8192, 64 heads (GQA kv=8), d_ff=49152, vocab=152064,
QKV bias (the Qwen1.5 signature). A copy of
``repro.configs.qwen1_5_110b``.
"""
from repro_torch.configs.base import SA, ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=49152,
    vocab_size=152064,
    pattern=(SA,),
    n_repeats=80,
    qkv_bias=True,
    rope="standard",
    rope_theta=1000000.0,
    norm="rmsnorm",
    act="silu",
    glu=True,
    sub_quadratic=False,
    source="hf:Qwen/Qwen1.5-0.5B",
)
