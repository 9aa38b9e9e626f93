"""seamless-m4t-large-v2 [audio] — encoder-decoder, multimodal,
arXiv:2308.11596.  24L enc + 24L dec, d_model=1024 16H (kv=16) d_ff=8192
vocab=256206.

Counterpart of ``repro.configs.seamless_m4t_large_v2``: the same fields.
The speech/text frontend is a stub: the encoder takes precomputed source
frame embeddings (B, S_src, d_model), the decoder token ids; the backbone
(a non-causal self-attention encoder, a causal decoder with cross
attention) is the whole model.  ``SRC_FRAMES`` is the stub source length
of the decode and prefill shapes."""
import dataclasses

from repro_torch.configs.base import ModelConfig, uniform_stages


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2", family="audio", num_layers=48,
        d_model=1024, num_heads=16, num_kv_heads=16, head_dim=64, d_ff=8192,
        vocab_size=256206,
        stages=uniform_stages("dec", 24),
        encoder_stages=uniform_stages("enc", 24),
        is_encoder_decoder=True, frontend="audio_stub",
        rope_theta=1e4, norm_eps=1e-5, act="gelu",
    )


SRC_FRAMES = 3072


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=512,
        stages=uniform_stages("dec", 2),
        encoder_stages=uniform_stages("enc", 2))
