"""glm4-9b [dense] — RoPE + GQA, hf:THUDM/glm-4-9b.
40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552.

Counterpart of ``repro.configs.glm4_9b``: the same fields."""
import dataclasses

from repro_torch.configs.base import ModelConfig, uniform_stages


def config() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b", family="dense", num_layers=40, d_model=4096,
        num_heads=32, num_kv_heads=2, head_dim=128, d_ff=13696,
        vocab_size=151552, stages=uniform_stages("attn", 40),
        rope_theta=1e4, norm_eps=1.5625e-7,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512,
        stages=uniform_stages("attn", 2))
