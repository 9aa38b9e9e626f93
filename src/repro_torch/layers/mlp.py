"""Dense FFNs: gated (SwiGLU/GeGLU) and plain.

Counterpart of ``repro.layers.mlp``, the same parameter names; the gated
FFN's logical specs are ``glu_specs``.  On a mesh whose 'ffn' axis splits
its hidden width ``width``, ``wi``/``wg`` are column-parallel and ``wo``
row-parallel: each rank runs its ``width/TP`` hidden units and the
partial outputs are summed in f32 over the group, rounded once."""
from __future__ import annotations

import torch

from repro_torch.layers import common as cm


def glu_init(gen: torch.Generator, d_model, d_ff, dtype=torch.bfloat16):
    return {"wi": cm.dense_init(gen, d_model, d_ff, dtype),
            "wg": cm.dense_init(gen, d_model, d_ff, dtype),
            "wo": cm.dense_init(gen, d_ff, d_model, dtype)}


def glu_specs() -> dict:
    return {"wi": cm.dense_specs(None, "ffn"),
            "wg": cm.dense_specs(None, "ffn"),
            "wo": cm.dense_specs("ffn", None)}


def glu_apply(p, x, act="silu", dist=None, width=None):
    """``width`` is the whole hidden width (what ``dist`` splits)."""
    group = None
    if dist is not None:
        group, _, _ = cm.tp(dist, "ffn", width)
        x = cm.tp_input(x, group)
    a = cm.ACTS[act](cm.dense_apply(p["wg"], x).float())
    h = a * cm.dense_apply(p["wi"], x).float()
    return cm.row_parallel(p["wo"], h.to(x.dtype), group)


def mlp_init(gen: torch.Generator, d_model, d_ff, dtype=torch.bfloat16):
    return {"wi": cm.dense_init(gen, d_model, d_ff, dtype),
            "wo": cm.dense_init(gen, d_ff, d_model, dtype)}


def mlp_apply(p, x, act="gelu"):
    h = cm.ACTS[act](cm.dense_apply(p["wi"], x).float())
    return cm.dense_apply(p["wo"], h.to(x.dtype))
