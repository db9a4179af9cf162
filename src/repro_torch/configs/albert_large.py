"""ALBERT-large — the paper's own §4.2 pretraining subject [arXiv:1909.11942].

24 transformer layers with a SINGLE shared parameter set
(share_pattern_params=True), d_model=1024, 16 heads, d_ff=4096, GELU,
LayerNorm, learned positions. A copy of ``repro.configs.albert_large``.
"""
from repro_torch.configs.base import SA, ModelConfig

CONFIG = ModelConfig(
    name="albert-large",
    family="dense",
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=30000,
    pattern=(SA,),
    n_repeats=24,
    share_pattern_params=True,
    rope="none",
    learned_pos=True,
    norm="layernorm",
    act="gelu",
    glu=False,
    sub_quadratic=False,
    max_position=4096,
    source="arXiv:1909.11942 (paper §4.2)",
)
