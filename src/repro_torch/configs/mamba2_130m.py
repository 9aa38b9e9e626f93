"""mamba2-130m [ssm] — SSD (state-space duality), arXiv:2405.21060.
24L d_model=768, attn-free, vocab=50280, ssm_state=128.

Counterpart of ``repro.configs.mamba2_130m``: the same fields."""
import dataclasses

from repro_torch.configs.base import ModelConfig, uniform_stages


def config() -> ModelConfig:
    d = 768
    return ModelConfig(
        name="mamba2-130m", family="ssm", num_layers=24, d_model=d,
        num_heads=0, num_kv_heads=0, d_ff=0, vocab_size=50280,
        stages=uniform_stages("ssd", 24),
        d_inner=2 * d, ssm_state=128, ssm_heads=(2 * d) // 64, ssm_groups=1,
        ssm_conv=4, ssm_chunk=128, tie_embeddings=True,
        subquadratic=True, norm_eps=1e-5,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, d_inner=128, ssm_heads=2,
        ssm_state=16, ssm_chunk=16, vocab_size=512,
        stages=uniform_stages("ssd", 2))
