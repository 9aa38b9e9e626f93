"""Meta-tensor stand-ins for every model input, with their logical specs.

Counterpart of ``repro.launch.specs``: JAX's ``ShapeDtypeStruct``s become
tensors on the ``meta`` device (shapes and dtypes, no storage), JAX's
``PartitionSpec``s the port's ``sharding.Spec``s with the same logical
axis names.  Train and prefill shapes get a token (or stub-embedding)
batch, decode shapes the tokens, the cache and an encoder-decoder's
memory.  Nothing here allocates: the cache comes from ``init_cache`` on
the meta device, the params from ``tfm.param_shapes`` (``init`` under
``FakeTensorMode``).  The cache and the params are the port's unstacked
trees (one entry a layer), as ``tfm.specs`` is.
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer as tfm
from repro_torch.sharding import Spec

# decode/prefill shapes for enc-dec archs: stub source memory length
SRC_FRAMES = 3072


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg, shape):
    """(train or prefill batch as meta tensors, logical specs)."""
    b, s = shape.global_batch, shape.seq_len
    sds, shard = {}, {}
    if cfg.frontend != "none" and not cfg.is_encoder_decoder:
        sds["embeds"] = _meta((b, s, cfg.d_model), torch.bfloat16)
        shard["embeds"] = Spec("batch", None, None)
    sds["inputs"] = _meta((b, s), torch.int32)
    shard["inputs"] = Spec("batch", None)
    if shape.kind == "train":
        sds["targets"] = _meta((b, s), torch.int32)
        shard["targets"] = Spec("batch", None)
    if cfg.is_encoder_decoder:
        sds["src_embeds"] = _meta((b, SRC_FRAMES, cfg.d_model),
                                  torch.bfloat16)
        shard["src_embeds"] = Spec("batch", None, None)
    return sds, shard


def cache_specs(cfg, shape):
    """(the decode cache as meta tensors, one dict a layer; its logical
    specs, ``tfm.cache_specs_only``)."""
    b, s = shape.global_batch, shape.seq_len
    return (tfm.init_cache(cfg, b, s, device="meta"),
            tfm.cache_specs_only(cfg))


def decode_specs(cfg, shape):
    """(tokens, their spec, memory, its spec) for ``serve_step``; the
    memory and its spec are None but for an encoder-decoder."""
    b = shape.global_batch
    tok, tok_shard = _meta((b, 1), torch.int32), Spec("batch", None)
    mem, mem_shard = None, None
    if cfg.is_encoder_decoder:
        mem = _meta((b, SRC_FRAMES, cfg.d_model), torch.bfloat16)
        mem_shard = Spec("batch", None, None)
    return tok, tok_shard, mem, mem_shard


def param_specs(cfg):
    """(the params as meta tensors, their logical specs), allocating
    nothing."""
    return tfm.param_shapes(cfg), tfm.specs(cfg)
