"""Rotary position embeddings (standard RoPE).

Counterpart of ``repro.layers.rope``; ``apply_mrope`` (Qwen2-VL) waits for
that architecture (ROADMAP Queue 1 item 14)."""
from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=64)
def rope_freqs(head_dim: int, theta: float = 1e4, device="cpu"):
    """The (head_dim / 2,) inverse frequencies, made once per head dim,
    theta and device (every layer and decode step reuses them)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4):
    """x: (B, S, H, Dh); positions: (B, S) int.  Rotates the two halves of
    the head dim in f32 and rounds once to ``x``'s dtype."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                 # (Dh/2,)
    ang = positions[..., None].float() * freqs              # (B, S, Dh/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)
