"""gemma3-1b [dense] — 5:1 local:global attention, 128k-capable,
hf:google/gemma-3-1b-pt.  26L d_model=1152 4H (GQA kv=1) d_ff=6912
vocab=262144; sliding window 512; qk-norm; sandwich norms; tied embeddings.

Counterpart of ``repro.configs.gemma3_1b``: the same fields."""
import dataclasses

from repro_torch.configs.base import ModelConfig, patterned_stages


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b", family="dense", num_layers=26, d_model=1152,
        num_heads=4, num_kv_heads=1, head_dim=256, d_ff=6912,
        vocab_size=262144,
        stages=patterned_stages(["local"] * 5 + ["global"], 26),
        window=512, rope_theta=1e6, rope_theta_local=1e4,
        qk_norm=True, gemma_norm=True, sandwich_norm=True,
        tie_embeddings=True, subquadratic=True, norm_eps=1e-6,
        act="gelu",
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=3, d_model=64, num_heads=2, num_kv_heads=1,
        head_dim=32, d_ff=128, vocab_size=512, window=8,
        stages=patterned_stages(["local", "local", "global"], 3))
