"""dbrx-132b [moe] — 16 experts top-4 fine-grained MoE,
hf:databricks/dbrx-base.  40L d_model=6144 48H (GQA kv=8) d_ff=10752
vocab=100352.

Counterpart of ``repro.configs.dbrx_132b``: the same fields.  The port
takes no mesh, so ``moe_impl="ep"`` runs the dense semantics on one card
(``layers.moe.moe_apply``), as JAX's ``serve`` does without one."""
import dataclasses

from repro_torch.configs.base import ModelConfig, uniform_stages


def config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b", family="moe", num_layers=40, d_model=6144,
        num_heads=48, num_kv_heads=8, head_dim=128, d_ff=10752,
        vocab_size=100352,
        stages=uniform_stages("moe", 40),
        n_experts=16, n_shared=0, top_k=4, d_expert=10752,
        router_type="softmax", moe_impl="ep",
        rope_theta=5e5, norm_eps=1e-5,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512, n_experts=4, top_k=2,
        d_expert=64, moe_impl="dense", stages=uniform_stages("moe", 2))
