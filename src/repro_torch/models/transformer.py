"""Decoder-only transformer over the layer kinds ``attn``/``global``.

Counterpart of ``repro.models.transformer`` for dense-attention decoders
(llama3.2-1b): ``init``, ``forward`` (teacher-forced logits), the decode
cache and ``decode_step``.  JAX stacks a stage's parameters along a
leading repeat dim and scans it; the port keeps one dict per layer in
execution order (``params["layers"]``, kinds from ``layer_kinds``), and
``params_from_jax`` unstacks JAX's stages into that list.  Params are plain
dicts of tensors with JAX's names.

Any other layer kind, and the features only other architectures use
(sandwich and gemma norms, M-RoPE, stub frontends, encoder-decoder),
raise ``NotImplementedError``: they are ROADMAP Queue 1 item 14.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.layers import attention as attn
from repro_torch.layers import common as cm
from repro_torch.layers import mlp as mlp_lib

KINDS = ("attn", "global")


def layer_kinds(cfg) -> list[str]:
    """The layer kinds in execution order (the stages unrolled)."""
    return [kind for kinds, reps in cfg.stages for _ in range(reps)
            for kind in kinds]


def check_supported(cfg):
    kinds = set(layer_kinds(cfg))
    missing = sorted(kinds - set(KINDS))
    for flag in ("sandwich_norm", "gemma_norm", "mrope_sections",
                 "is_encoder_decoder"):
        if getattr(cfg, flag):
            missing.append(flag)
    if cfg.frontend != "none":
        missing.append(f"frontend={cfg.frontend}")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet (the port "
            f"runs layer kinds {KINDS}): ROADMAP Queue 1 item 14")


def _check_kind(kind):
    if kind not in KINDS:
        raise NotImplementedError(f"layer kind {kind!r} is not ported yet: "
                                  f"ROADMAP Queue 1 item 14")


def _rms(p, x, cfg):
    return cm.rmsnorm_apply(p, x, cfg.norm_eps, gemma_style=cfg.gemma_norm)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_layer(gen: torch.Generator, kind: str, cfg, dtype=torch.bfloat16):
    _check_kind(kind)
    dev = gen.device
    return {"ln1": cm.rmsnorm_init(cfg.d_model, dev),
            "attn": attn.gqa_init(gen, cfg, dtype),
            "ln2": cm.rmsnorm_init(cfg.d_model, dev),
            "mlp": mlp_lib.glu_init(gen, cfg.d_model, cfg.d_ff, dtype)}


def init_block(gen: torch.Generator, kinds, cfg, dtype=torch.bfloat16):
    return {f"l{i}": init_layer(gen, kind, cfg, dtype)
            for i, kind in enumerate(kinds)}


def init(cfg, *, seed=0, device="cuda", dtype=torch.bfloat16):
    """Random params from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (JAX's shapes and scales, not its numbers)."""
    check_supported(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = {"embed": cm.embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                     dtype)}
    layers = []
    for kinds, reps in cfg.stages:
        for _ in range(reps):
            block = init_block(gen, kinds, cfg, dtype)
            layers += [block[f"l{i}"] for i in range(len(kinds))]
    params["layers"] = layers
    params["final_norm"] = cm.rmsnorm_init(cfg.d_model, gen.device)
    if not cfg.tie_embeddings:
        params["head"] = cm.dense_init(gen, cfg.d_model, cfg.padded_vocab,
                                       dtype)
    return params


def _tensor(arr, device):
    """A numpy array (JAX's bf16 as ``ml_dtypes.bfloat16``) as a tensor on
    ``device``, bit for bit: bf16 goes across as its uint16 bits."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16)
                             .copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr).copy())
    return t.to(device)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(np_params, cfg, device="cuda"):
    """JAX's params (``jax.tree.map(np.asarray, params)``) as the port's:
    each stage's stacked blocks unstacked into ``params["layers"]``."""
    check_supported(cfg)
    out = {"embed": _map(lambda a: _tensor(a, device), np_params["embed"])}
    layers = []
    for (kinds, reps), stage in zip(cfg.stages, np_params["stages"]):
        for r in range(reps):
            for i in range(len(kinds)):
                layers.append(_map(lambda a, r=r: _tensor(np.asarray(a)[r],
                                                          device),
                                   stage[f"l{i}"]))
    out["layers"] = layers
    out["final_norm"] = _map(lambda a: _tensor(a, device),
                             np_params["final_norm"])
    if "head" in np_params:
        out["head"] = _map(lambda a: _tensor(a, device), np_params["head"])
    return out


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def apply_layer(p, x, kind, cfg, *, positions, kv_chunk=1024):
    _check_kind(kind)
    h = attn.gqa_apply(p["attn"], _rms(p["ln1"], x, cfg), cfg,
                       positions=positions, layer_kind="global",
                       kv_chunk=kv_chunk)
    x = x + h
    h = mlp_lib.glu_apply(p["mlp"], _rms(p["ln2"], x, cfg), cfg.act)
    return x + h


def _positions_for(b, s, device):
    return torch.arange(s, device=device)[None].expand(b, s)


def hidden(params, batch, cfg, *, kv_chunk=1024):
    """The residual stream after the last layer, before the final norm:
    (B, S, D) in the params' dtype."""
    check_supported(cfg)
    x = cm.embed_apply(params["embed"], batch["inputs"])
    b, s = x.shape[0], x.shape[1]
    positions = _positions_for(b, s, x.device)
    for p, kind in zip(params["layers"], layer_kinds(cfg)):
        x = apply_layer(p, x, kind, cfg, positions=positions,
                        kv_chunk=kv_chunk)
    return x


def forward(params, batch, cfg, *, kv_chunk=1024):
    """Teacher-forced logits: (B, S, V) float32."""
    x = hidden(params, batch, cfg, kv_chunk=kv_chunk)
    x = cm.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps,
                         gemma_style=cfg.gemma_norm)
    return _readout(params, x, cfg)


def _readout(params, x, cfg):
    """LM head over the padded vocab; padding columns masked to -1e30."""
    if cfg.tie_embeddings:
        logits = cm.embed_logits(params["embed"], x)
    else:
        logits = cm.dense_apply(params["head"], x).float()
    if cfg.padded_vocab != cfg.vocab_size:
        col = torch.arange(logits.shape[-1], device=logits.device)
        logits = logits.masked_fill(col >= cfg.vocab_size, -1e30)
    return logits


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def init_cache_layer(kind, cfg, batch, max_len, dtype=torch.bfloat16,
                     device="cuda"):
    _check_kind(kind)
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_cache(cfg, batch, max_len, dtype=torch.bfloat16, device="cuda"):
    """One {"k", "v"} cache per layer, in execution order (bf16 by default,
    as JAX's)."""
    check_supported(cfg)
    return [init_cache_layer(kind, cfg, batch, max_len, dtype, device)
            for kind in layer_kinds(cfg)]


def decode_layer(p, x, kind, cfg, cache, idx):
    _check_kind(kind)
    h, nc = attn.gqa_decode(p["attn"], _rms(p["ln1"], x, cfg), cache, idx,
                            cfg, layer_kind="global")
    x = x + h
    h = mlp_lib.glu_apply(p["mlp"], _rms(p["ln2"], x, cfg), cfg.act)
    return x + h, nc


def decode_step(params, cache, tokens, idx, cfg):
    """One decode step.  tokens: (B, 1) int; ``idx`` a Python int or a 0-d
    int64 tensor on the tokens' device (a captured graph's position).
    Returns (logits (B, 1, V), cache), the cache written in place at
    ``idx``."""
    check_supported(cfg)
    x = cm.embed_apply(params["embed"], tokens)
    idx = torch.as_tensor(idx, dtype=torch.int64, device=x.device)
    new_cache = []
    for p, c, kind in zip(params["layers"], cache, layer_kinds(cfg)):
        x, nc = decode_layer(p, x, kind, cfg, c, idx)
        new_cache.append(nc)
    x = cm.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps,
                         gemma_style=cfg.gemma_norm)
    return _readout(params, x, cfg), new_cache
