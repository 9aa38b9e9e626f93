"""llama3.2-1b [dense] — small llama3, hf:meta-llama/Llama-3.2-1B.
16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256; tied embeddings.

Counterpart of ``repro.configs.llama32_1b``: the same fields."""
import dataclasses

from repro_torch.configs.base import ModelConfig, uniform_stages


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-1b", family="dense", num_layers=16, d_model=2048,
        num_heads=32, num_kv_heads=8, head_dim=64, d_ff=8192,
        vocab_size=128256, stages=uniform_stages("attn", 16),
        rope_theta=5e5, tie_embeddings=True, norm_eps=1e-5,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512,
        stages=uniform_stages("attn", 2))
