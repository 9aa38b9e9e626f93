"""deepseek-v3-671b [moe] — MLA + 256-expert top-8 aux-free MoE,
arXiv:2412.19437.  61L d_model=7168 128H, vocab=129280; first 3 layers dense
(d_ff 18432), 58 MoE layers with 1 shared + 256 routed (d_expert 2048).
MTP head omitted.

Counterpart of ``repro.configs.deepseek_v3_671b``: the same fields.  The
MLA prefill's attention core runs at head dim ``qk_nope_dim +
qk_rope_dim`` = 192 (``head_dim``)."""
import dataclasses

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b", family="moe", num_layers=61, d_model=7168,
        num_heads=128, num_kv_heads=128, head_dim=192, d_ff=18432,
        vocab_size=129280,
        stages=((("mla",), 3), (("mla_moe",), 58)),
        use_mla=True, q_lora_rank=1536, kv_lora_rank=512, qk_rope_dim=64,
        qk_nope_dim=128, v_head_dim=128,
        n_experts=256, n_shared=1, top_k=8, d_expert=2048,
        router_type="sigmoid_bias", routed_scaling=2.5, moe_impl="ep",
        rope_theta=1e4, norm_eps=1e-6,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=512, q_lora_rank=32, kv_lora_rank=16,
        qk_rope_dim=8, qk_nope_dim=16, v_head_dim=16, n_experts=8, top_k=2,
        d_expert=32, moe_impl="dense",
        stages=((("mla",), 1), (("mla_moe",), 2)))
