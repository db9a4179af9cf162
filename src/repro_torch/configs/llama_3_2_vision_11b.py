"""Llama-3.2-11B-Vision language backbone [hf:meta-llama/Llama-3.2-11B-Vision].

40 decoder layers, d_model=4096, 32 heads (GQA kv=8), d_ff=14336,
vocab=128256, with gated cross-attention image layers every 5th layer
(8 cross-attn layers in all). The vision encoder is a stub: the batch's
``memory_raw`` holds pre-computed patch embeddings (batch, 1600, 7680),
consumed by a linear projector. A copy of
``repro.configs.llama_3_2_vision_11b``.
"""
from repro_torch.configs.base import SA, XA, ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    pattern=(SA, SA, SA, SA, XA),
    n_repeats=8,  # 40 layers
    rope="standard",
    rope_theta=500000.0,
    encoder_len=1600,   # patch tokens (stubbed vision tower output)
    encoder_dim=7680,   # Llama-3.2 vision_output_dim before the projector
    norm="rmsnorm",
    act="silu",
    glu=True,
    sub_quadratic=False,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)
