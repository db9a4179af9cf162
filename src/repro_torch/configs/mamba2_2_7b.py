"""Mamba2-2.7B: attention-free SSD (state-space duality) [arXiv:2405.21060].

64 layers, d_model=2560, expand=2 (d_inner=5120), head_dim=64 (80 heads),
ssm_state=128, vocab=50280. No MLP blocks (d_ff=0): the SSD mixer is the
whole block, as in the Mamba-2 paper. A copy of
``repro.configs.mamba2_2_7b``.
"""
from repro_torch.configs.base import SSM, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    pattern=(SSM,),
    n_repeats=64,
    rope="none",
    ssm_state=128,
    ssm_head_dim=64,
    ssm_chunk=256,
    ssm_expand=2,
    ssm_conv=4,
    norm="rmsnorm",
    sub_quadratic=True,
    source="arXiv:2405.21060",
)
