"""Dense FFNs: gated (SwiGLU/GeGLU) and plain.

Counterpart of ``repro.layers.mlp``, the same parameter names."""
from __future__ import annotations

import torch

from repro_torch.layers import common as cm


def glu_init(gen: torch.Generator, d_model, d_ff, dtype=torch.bfloat16):
    return {"wi": cm.dense_init(gen, d_model, d_ff, dtype),
            "wg": cm.dense_init(gen, d_model, d_ff, dtype),
            "wo": cm.dense_init(gen, d_ff, d_model, dtype)}


def glu_apply(p, x, act="silu"):
    a = cm.ACTS[act](cm.dense_apply(p["wg"], x).float())
    h = a * cm.dense_apply(p["wi"], x).float()
    return cm.dense_apply(p["wo"], h.to(x.dtype))


def mlp_init(gen: torch.Generator, d_model, d_ff, dtype=torch.bfloat16):
    return {"wi": cm.dense_init(gen, d_model, d_ff, dtype),
            "wo": cm.dense_init(gen, d_ff, d_model, dtype)}


def mlp_apply(p, x, act="gelu"):
    h = cm.ACTS[act](cm.dense_apply(p["wi"], x).float())
    return cm.dense_apply(p["wo"], h.to(x.dtype))
