"""Architecture registry: ``--arch <id>`` resolution for the port's
launchers.

Counterpart of ``repro.configs.registry`` over the architectures the port
runs: the dense decoders (llama3.2-1b, gemma3-1b, qwen2-7b, glm4-9b), the
M-RoPE VLM backbone (qwen2-vl-2b), the RG-LRU hybrid (recurrentgemma-2b),
the SSD model (mamba2-130m), the MoE models (dbrx-132b; deepseek-v3-671b
with MLA) and the encoder-decoder with the ``audio_stub`` frontend
(seamless-m4t-large-v2): every architecture of JAX's registry."""
from __future__ import annotations

import importlib

_MODULES = {
    "mamba2-130m": "repro_torch.configs.mamba2_130m",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "qwen2-7b": "repro_torch.configs.qwen2_7b",
    "gemma3-1b": "repro_torch.configs.gemma3_1b",
    "glm4-9b": "repro_torch.configs.glm4_9b",
    "llama3.2-1b": "repro_torch.configs.llama32_1b",
    "qwen2-vl-2b": "repro_torch.configs.qwen2_vl_2b",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "seamless-m4t-large-v2": "repro_torch.configs.seamless_m4t_large_v2",
}

ARCH_IDS = tuple(_MODULES)


def get_config(name: str):
    return importlib.import_module(_MODULES[name]).config()


def get_reduced(name: str):
    return importlib.import_module(_MODULES[name]).reduced()


def shape_applicable(cfg, shape) -> tuple[bool, str]:
    """Which (arch x shape) cells run: ``long_500k`` only for the
    subquadratic architectures."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "full-attention arch: 512k dense-KV decode skipped per brief"
    return True, ""
