"""recurrentgemma-2b [hybrid] — RG-LRU + local attention 2:1 (Griffin),
arXiv:2402.19427.  26L d_model=2560 10H (GQA kv=1) d_ff=7680 vocab=256000,
lru_width=2560, local window 2048.

Counterpart of ``repro.configs.recurrentgemma_2b``: the same fields."""
import dataclasses

from repro_torch.configs.base import ModelConfig, patterned_stages


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b", family="hybrid", num_layers=26,
        d_model=2560, num_heads=10, num_kv_heads=1, head_dim=256, d_ff=7680,
        vocab_size=256000,
        stages=patterned_stages(["rec", "rec", "local"], 26),
        window=2048, lru_width=2560, conv_width=4,
        gemma_norm=True, tie_embeddings=True, subquadratic=True,
        rope_theta=1e4, norm_eps=1e-6, act="gelu",
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=3, d_model=64, num_heads=2, num_kv_heads=1,
        head_dim=32, d_ff=128, vocab_size=512, window=8, lru_width=64,
        stages=patterned_stages(["rec", "rec", "local"], 3))
