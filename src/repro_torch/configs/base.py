"""Model and input-shape configuration: a copy of ``repro.configs.base``
(``LayerSpec``, ``ModelConfig``, ``reduce_config``, ``InputShape``,
``INPUT_SHAPES``, ``shape_applicable``), kept here so the port imports
nothing of the JAX package.

A model is a stack of ``LayerSpec`` blocks: prefix + repeated pattern +
suffix, with the pattern's parameters optionally shared across repeats
(ALBERT).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class LayerSpec:
    """One residual block of the stack.

    mixer: "attn_full" | "attn_local" | "attn_cross" | "mla" | "ssm" | "rglru"
    mlp:   "dense" | "moe" | "none"
    cross: if True, an additional cross-attention sub-block follows the
           self-mixer (encoder-decoder decoders).
    """

    mixer: str = "attn_full"
    mlp: str = "dense"
    cross: bool = False

    def kind(self) -> tuple:
        return (self.mixer, self.mlp, self.cross)


SA = LayerSpec("attn_full", "dense")
LSA = LayerSpec("attn_local", "dense")
SA_MOE = LayerSpec("attn_full", "moe")
MLA_D = LayerSpec("mla", "dense")
MLA_MOE = LayerSpec("mla", "moe")
SSM = LayerSpec("ssm", "none")
RG = LayerSpec("rglru", "dense")
XA = LayerSpec("attn_cross", "dense")  # gated cross attention (VLM)
DEC_XA = LayerSpec("attn_full", "dense", cross=True)  # self + cross + mlp


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- layer stack -----------------------------------------------------
    prefix: tuple = ()
    pattern: tuple = ()
    n_repeats: int = 0
    suffix: tuple = ()
    share_pattern_params: bool = False  # ALBERT-style cross-layer sharing

    # --- attention flavour ------------------------------------------------
    qkv_bias: bool = False
    qk_norm: bool = False
    rope: str = "standard"  # standard | half | none
    rope_theta: float = 10000.0
    window: int = 1024  # sliding window for attn_local
    learned_pos: bool = False  # learned absolute positions
    max_position: int = 524288

    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    router_aux_coef: float = 0.01
    capacity_factor: float = 1.25

    # --- MLA ---------------------------------------------------------------
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128

    # --- SSM ---------------------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_expand: int = 2
    ssm_conv: int = 4

    # --- RG-LRU ------------------------------------------------------------
    rglru_width: int = 0  # d_model when 0
    rglru_conv: int = 4

    # --- encoder / modality stub ---------------------------------------------
    n_encoder_layers: int = 0
    encoder_len: int = 0
    encoder_dim: int = 0

    # --- misc -------------------------------------------------------------
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "silu"
    glu: bool = True
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    logit_softcap: float = 0.0
    sub_quadratic: bool = False
    dtype: str = "bfloat16"
    source: str = ""

    @property
    def layers(self) -> tuple:
        return self.prefix + self.pattern * self.n_repeats + self.suffix

    @property
    def n_layers(self) -> int:
        return len(self.layers)

    @property
    def has_encoder(self) -> bool:
        return self.n_encoder_layers > 0

    @property
    def is_decoder_only(self) -> bool:
        return not self.has_encoder

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_head_dim if self.ssm_state else 0

    def validate(self) -> None:
        assert self.n_layers > 0, self.name
        for spec in self.layers:
            if spec.mlp == "moe":
                assert self.n_experts > 0 and self.top_k > 0, self.name
            if spec.mixer == "mla":
                assert self.kv_lora_rank > 0, self.name
            if spec.mixer == "ssm":
                assert self.ssm_state > 0, self.name
        if self.n_heads:
            assert self.n_heads % max(self.n_kv_heads, 1) == 0, self.name


def reduce_config(cfg: ModelConfig) -> ModelConfig:
    """A 2-layer, d_model 256 smoke variant of the same family (the JAX
    package's ``reduce_config``: the first two distinct block kinds become
    an unshared prefix, vocab 512, float32)."""
    seen, picked = set(), []
    for spec in cfg.layers:
        if spec.kind() not in seen:
            seen.add(spec.kind())
            picked.append(spec)
        if len(picked) == 2:
            break
    while len(picked) < 2:
        picked.append(picked[-1])

    n_kv = (max(1, (4 * cfg.n_kv_heads) // max(cfg.n_heads, 1))
            if cfg.n_heads else 0)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        d_model=256,
        n_heads=4 if cfg.n_heads else 0,
        n_kv_heads=n_kv,
        head_dim=64 if cfg.n_heads else cfg.head_dim,
        d_ff=512 if cfg.d_ff else 0,
        vocab_size=512,
        prefix=tuple(picked),
        pattern=(),
        n_repeats=0,
        suffix=(),
        n_experts=min(cfg.n_experts, 4),
        n_shared_experts=min(cfg.n_shared_experts, 1),
        top_k=min(cfg.top_k, 2),
        d_ff_expert=128 if cfg.d_ff_expert else 0,
        capacity_factor=4.0,
        kv_lora_rank=64 if cfg.kv_lora_rank else 0,
        q_lora_rank=0,
        rope_head_dim=32 if cfg.kv_lora_rank else cfg.rope_head_dim,
        nope_head_dim=64 if cfg.kv_lora_rank else cfg.nope_head_dim,
        v_head_dim=64 if cfg.kv_lora_rank else cfg.v_head_dim,
        ssm_state=64 if cfg.ssm_state else 0,
        ssm_head_dim=32 if cfg.ssm_state else cfg.ssm_head_dim,
        ssm_chunk=16,
        rglru_width=256 if cfg.rglru_width else 0,
        window=32,
        n_encoder_layers=min(cfg.n_encoder_layers, 2),
        encoder_len=64 if cfg.encoder_len else 0,
        encoder_dim=128 if cfg.encoder_dim else 0,
        max_position=4096,
        dtype="float32",
    )


# ---------------------------------------------------------------------------
# Input shapes
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: InputShape) -> bool:
    """long_500k only for the sub-quadratic models."""
    if shape.name == "long_500k":
        return cfg.sub_quadratic
    return True
