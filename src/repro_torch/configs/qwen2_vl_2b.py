"""qwen2-vl-2b [vlm] — M-RoPE + dynamic resolution, arXiv:2409.12191.
28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.

The vision frontend is a stub: a batch may carry precomputed patch
embeddings (B, S, d_model) under ``"embeds"``; the backbone applies M-RoPE
over (temporal, height, width) position ids.

Counterpart of ``repro.configs.qwen2_vl_2b``: the same fields."""
import dataclasses

from repro_torch.configs.base import ModelConfig, uniform_stages


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b", family="vlm", num_layers=28, d_model=1536,
        num_heads=12, num_kv_heads=2, head_dim=128, d_ff=8960,
        vocab_size=151936, stages=uniform_stages("attn", 28),
        qkv_bias=True, rope_theta=1e6, mrope_sections=(16, 24, 24),
        frontend="vlm_stub", norm_eps=1e-6,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512, mrope_sections=(2, 3, 3),
        stages=uniform_stages("attn", 2))
