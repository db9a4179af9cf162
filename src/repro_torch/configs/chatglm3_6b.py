"""ChatGLM3-6B dense decoder [arXiv:2406.12793].

28 layers, d_model=4096, 32 heads (GQA kv=2), d_ff=13696, vocab=65024,
2d RoPE (rotary applied to half of each head dim — the GLM convention).
A copy of ``repro.configs.chatglm3_6b``.
"""
from repro_torch.configs.base import SA, ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=65024,
    pattern=(SA,),
    n_repeats=28,
    qkv_bias=True,  # GLM uses bias on QKV
    rope="half",
    rope_theta=10000.0,
    norm="rmsnorm",
    act="silu",
    glu=True,
    sub_quadratic=False,
    source="arXiv:2406.12793",
)
