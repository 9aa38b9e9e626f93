"""qwen2-7b [dense] — GQA with QKV bias, arXiv:2407.10671.
28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.

Counterpart of ``repro.configs.qwen2_7b``: the same fields."""
import dataclasses

from repro_torch.configs.base import ModelConfig, uniform_stages


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-7b", family="dense", num_layers=28, d_model=3584,
        num_heads=28, num_kv_heads=4, head_dim=128, d_ff=18944,
        vocab_size=152064, stages=uniform_stages("attn", 28),
        qkv_bias=True, rope_theta=1e6, norm_eps=1e-6,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512,
        stages=uniform_stages("attn", 2))
