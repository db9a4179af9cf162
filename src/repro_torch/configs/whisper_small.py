"""Whisper-small encoder-decoder [arXiv:2212.04356].

12 encoder + 12 decoder layers, d_model=768, 12 heads (kv=12), d_ff=3072,
vocab=51865. The mel-spectrogram + conv frontend is a stub: the batch's
``memory_raw`` holds post-conv frame embeddings (batch, 1500, 768).
Decoder layers are self-attn + cross-attn + MLP; GELU, LayerNorm, learned
positions. A copy of ``repro.configs.whisper_small``.
"""
from repro_torch.configs.base import DEC_XA, ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51865,
    pattern=(DEC_XA,),
    n_repeats=12,
    rope="none",
    learned_pos=True,
    n_encoder_layers=12,
    encoder_len=1500,
    encoder_dim=768,  # post-conv frontend width == d_model
    norm="layernorm",
    act="gelu",
    glu=False,
    tie_embeddings=True,  # Whisper ties the decoder embedding and LM head
    sub_quadratic=False,
    max_position=32768,
    source="arXiv:2212.04356",
)
