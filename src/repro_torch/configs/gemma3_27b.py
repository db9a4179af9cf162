"""Gemma-3-27B dense decoder [hf:google/gemma-3-1b-pt family card, 27B entry].

62 layers, d_model=5376, 32 heads (GQA kv=16), head_dim=128, d_ff=21504,
vocab=262144, 5:1 local:global attention (window 1024), QK-norm, tanh
GELU, tied embeddings scaled by sqrt(d_model), logits soft-capped at 30.
A copy of ``repro.configs.gemma3_27b``.
"""
from repro_torch.configs.base import LSA, SA, ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    # 62 = 2 local + 10 * (5 local + 1 global)
    prefix=(LSA, LSA),
    pattern=(LSA, LSA, LSA, LSA, LSA, SA),
    n_repeats=10,
    qk_norm=True,
    rope="standard",
    rope_theta=1000000.0,
    window=1024,
    norm="rmsnorm",
    act="gelu",
    glu=True,
    logit_softcap=30.0,
    tie_embeddings=True,
    sub_quadratic=True,
    source="hf:google/gemma-3-1b-pt",
)
