"""DBRX-132B fine-grained MoE [hf:databricks/dbrx-base].

40 layers, d_model=6144, 48 heads (GQA kv=8), vocab=100352,
16 experts top-4, expert d_ff=10752, no shared experts. A copy of
``repro.configs.dbrx_132b``.
"""
from repro_torch.configs.base import SA_MOE, ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=0,  # all blocks are MoE
    vocab_size=100352,
    pattern=(SA_MOE,),
    n_repeats=40,
    n_experts=16,
    n_shared_experts=0,
    top_k=4,
    d_ff_expert=10752,
    qkv_bias=False,
    rope="standard",
    rope_theta=500000.0,
    norm="layernorm",
    act="silu",
    glu=True,
    sub_quadratic=False,
    source="hf:databricks/dbrx-base",
)
