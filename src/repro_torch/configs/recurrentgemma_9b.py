"""RecurrentGemma-9B (Griffin) hybrid [arXiv:2402.19427].

38 blocks, d_model=4096, 16 heads local attention (MQA kv=1, head_dim 256,
window 2048), d_ff=12288, vocab=256000, RG-LRU recurrent blocks (width
4096, a causal conv of width 4 in front) and local-attention blocks in a
2:1 ratio (pattern rec, rec, attn), tied embeddings scaled by
sqrt(d_model). A copy of ``repro.configs.recurrentgemma_9b``.
"""
from repro_torch.configs.base import LSA, RG, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    # 38 = 2 rec + 12 * (rec, rec, attn)
    prefix=(RG, RG),
    pattern=(RG, RG, LSA),
    n_repeats=12,
    rope="standard",
    window=2048,
    rglru_width=4096,
    norm="rmsnorm",
    act="gelu",
    glu=True,
    tie_embeddings=True,
    sub_quadratic=True,
    source="arXiv:2402.19427",
)
