"""Model/config schema shared by all architectures.

Counterpart of ``repro.configs.base``, field for field, kept as the port's
own copy.  A model is a sequence of *stages*; a stage is a repeated *block*
(tuple of layer kinds).  JAX stacks a stage's parameters along a leading
repeat dim and scans it; the port keeps the same stages and runs its
layers as a flat list (``models.transformer.layer_kinds``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

Stage = tuple[tuple[str, ...], int]          # (block layer kinds, repeats)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                              # dense|moe|ssm|hybrid|vlm|audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    stages: tuple[Stage, ...]
    head_dim: int = 128

    # attention
    window: int = 0
    rope_theta: float = 1e4
    rope_theta_local: float = 0.0
    qkv_bias: bool = False
    qk_norm: bool = False
    mrope_sections: Optional[tuple[int, ...]] = None
    sandwich_norm: bool = False
    gemma_norm: bool = False                 # (1+g) rmsnorm + sqrt(d) embed scale
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    act: str = "silu"

    # MLA (deepseek)
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0

    # MoE
    n_experts: int = 0
    n_shared: int = 0
    top_k: int = 0
    d_expert: int = 0
    router_type: str = "softmax"             # softmax | sigmoid_bias
    routed_scaling: float = 1.0
    capacity_factor: float = 1.25
    moe_impl: str = "dense"                  # dense | ep

    # SSM (mamba2)
    d_inner: int = 0
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_groups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 128

    # RG-LRU (recurrentgemma)
    lru_width: int = 0
    conv_width: int = 4

    # encoder-decoder
    encoder_layers: int = 0
    encoder_stages: tuple[Stage, ...] = ()
    is_encoder_decoder: bool = False

    # modality frontend: 'none' means token ids; otherwise the stub supplies
    # precomputed (B, S, d_model) embeddings (vlm patches / audio frames).
    frontend: str = "none"

    # long-context capability (decides long_500k applicability)
    subquadratic: bool = False

    def total_layers(self):
        n = sum(len(b) * r for b, r in self.stages)
        if self.is_encoder_decoder:
            n += sum(len(b) * r for b, r in self.encoder_stages)
        return n

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a 256 multiple so the embedding/LM head shard
        evenly on the model axis (Megatron-style); padded logits are masked
        to -inf and never win argmax / contribute to the loss."""
        return -(-self.vocab_size // 256) * 256


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str                                # train_4k | prefill_32k | ...
    kind: str                                # train | prefill | decode
    seq_len: int
    global_batch: int
    grad_accum: int = 1                      # microbatch = batch/accum


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


def uniform_stages(kind: str, n: int) -> tuple[Stage, ...]:
    return (((kind,), n),)


def patterned_stages(pattern: Sequence[str], n_layers: int) -> tuple[Stage, ...]:
    """Repeat ``pattern`` to cover n_layers; leftover becomes a second stage."""
    p = len(pattern)
    reps, rem = divmod(n_layers, p)
    stages: list[Stage] = []
    if reps:
        stages.append((tuple(pattern), reps))
    if rem:
        stages.append((tuple(pattern[:rem]), 1))
    return tuple(stages)
