"""Attention: the flash attention core and the MHA/GQA layer (+ sliding
window, qk-norm, qkv bias, M-RoPE).

Counterpart of ``repro.layers.attention``.  Layout: activations
(B, S, D); q/k/v (B, S, H, Dh).  ``cross_*`` (the encoder-decoder) and
``mla_*`` (deepseek's MLA) are not ported yet: ROADMAP Queue 1 item 14.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.layers import common as cm
from repro_torch.layers import rope as rp

NEG_INF = -2.0 ** 30


def flash_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                    kv_chunk=1024, scale=None):
    """Online-softmax attention over KV chunks.  q: (B, Sq, H, D); k, v:
    (B, Sk, Kh, D); ``q_offset`` is the absolute position of q[0].

    CUDA tensors go through kernel F, which stages its own key chunks;
    CPU tensors through F's plain version with ``kv_chunk`` keys a chunk.
    JAX's jnp core pads K/V with zero keys to a multiple of ``kv_chunk``
    and masks them only through the causal test, so with ``causal=False``
    and a ragged Sk it differs from F and from the dense oracle; the port
    excludes keys past Sk outright, as the oracle does."""
    if q.device.type == "cpu":
        return fa.flash_attention_plain(q, k, v, causal=causal,
                                        window=window, q_offset=q_offset,
                                        scale=scale, ck=kv_chunk)
    return fa.flash_attention(q, k, v, causal=causal, window=window,
                              q_offset=q_offset, scale=scale)


def gqa_init(gen: torch.Generator, cfg, dtype=torch.bfloat16):
    d, h, kh, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {"q": cm.dense_init(gen, d, h * dh, dtype, bias=cfg.qkv_bias),
         "k": cm.dense_init(gen, d, kh * dh, dtype, bias=cfg.qkv_bias),
         "v": cm.dense_init(gen, d, kh * dh, dtype, bias=cfg.qkv_bias),
         "o": cm.dense_init(gen, h * dh, d, dtype)}
    if cfg.qk_norm:
        p["qn"] = cm.rmsnorm_init(dh, gen.device)
        p["kn"] = cm.rmsnorm_init(dh, gen.device)
    return p


def _theta(cfg, layer_kind):
    if layer_kind == "local" and cfg.rope_theta_local:
        return cfg.rope_theta_local
    return cfg.rope_theta


def _rope(x, positions, cfg, theta):
    """M-RoPE over (3, B, S) positions where the config has sections, else
    RoPE over (B, S) positions (the first axis of (3, B, S) ones)."""
    if cfg.mrope_sections:
        return rp.apply_mrope(x, positions, cfg.mrope_sections, theta)
    pos2d = positions if positions.dim() == 2 else positions[0]
    return rp.apply_rope(x, pos2d, theta)


def _qkv(p, x, cfg):
    b, sq, _ = x.shape
    h, kh, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = cm.dense_apply(p["q"], x).reshape(b, sq, h, dh)
    k = cm.dense_apply(p["k"], x).reshape(b, sq, kh, dh)
    v = cm.dense_apply(p["v"], x).reshape(b, sq, kh, dh)
    if "qn" in p:
        q = cm.rmsnorm_apply(p["qn"], q, cfg.norm_eps)
        k = cm.rmsnorm_apply(p["kn"], k, cfg.norm_eps)
    return q, k, v


def gqa_apply(p, x, cfg, *, positions, layer_kind="global", kv_chunk=1024,
              causal=True):
    """Training / prefill self-attention.  x: (B, S, D); positions (B, S),
    or (3, B, S) under M-RoPE."""
    b, sq, _ = x.shape
    q, k, v = _qkv(p, x, cfg)
    theta = _theta(cfg, layer_kind)
    q = _rope(q, positions, cfg, theta)
    k = _rope(k, positions, cfg, theta)
    window = cfg.window if layer_kind == "local" else 0
    o = flash_attention(q, k, v, causal=causal, window=window,
                        kv_chunk=kv_chunk)
    return cm.dense_apply(p["o"], o.reshape(b, sq, -1))


def gqa_decode(p, x, cache, cache_index, cfg, *, layer_kind="global"):
    """Single-token decode.  cache: {"k", "v"}: (B, Smax, Kh, Dh), updated
    in place at ``cache_index`` (JAX returns a new cache; the port writes
    the one it was given and returns it).  ``cache_index`` is a Python int
    or a 0-d int64 tensor on ``x``'s device (what a captured CUDA graph
    needs, as JAX traces it); both give the same bits.  The attention is
    JAX's dense f32 softmax over the whole cache; kernel F is not launched
    here."""
    b, sq, _ = x.shape
    h, kh, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    idx = torch.as_tensor(cache_index, dtype=torch.int64, device=x.device)
    q, k, v = _qkv(p, x, cfg)
    pos = idx.expand(b, sq)
    if cfg.mrope_sections:
        pos = pos.expand(3, b, sq)
    theta = _theta(cfg, layer_kind)
    q = _rope(q, pos, cfg, theta)
    k = _rope(k, pos, cfg, theta)
    ck, cv = cache["k"], cache["v"]
    rows = idx + torch.arange(sq, device=x.device)
    ck.index_copy_(1, rows, k.to(ck.dtype))
    cv.index_copy_(1, rows, v.to(cv.dtype))
    kpos = torch.arange(ck.shape[1], device=x.device)
    window = cfg.window if layer_kind == "local" else 0
    qr = q.reshape(b, sq, kh, h // kh, dh).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qr, ck.float()) * (dh ** -0.5)
    mask = kpos <= idx
    if window:
        mask &= kpos > idx - window
    s = s.masked_fill(~mask, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", w, cv.float())
    o = o.reshape(b, sq, h * dh).to(x.dtype)
    return cm.dense_apply(p["o"], o), cache
