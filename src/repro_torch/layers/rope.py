"""Rotary position embeddings: standard RoPE and Qwen2-VL M-RoPE.

Counterpart of ``repro.layers.rope``."""
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
    freqs = rope_freqs(x.shape[-1], theta, x.device)        # (Dh/2,)
    return _rotate(x, positions[..., None].float() * freqs)  # (B, S, Dh/2)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, sections,
                theta: float = 1e4):
    """Qwen2-VL multimodal RoPE.  x: (B, S, H, Dh); positions: (3, B, S)
    temporal / height / width ids (text tokens carry t == h == w); the
    frequencies are cut into ``sections`` (summing to Dh / 2), section i
    taking its angles from axis i."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)        # (Dh/2,)
    ang_per_axis = positions[..., None].float() * freqs     # (3, B, S, Dh/2)
    parts, start = [], 0
    for i, sec in enumerate(sections):
        parts.append(ang_per_axis[i, :, :, start:start + sec])
        start += sec
    return _rotate(x, torch.cat(parts, -1))                 # (B, S, Dh/2)


def _rotate(x, ang):
    """Rotate the two halves of x's head dim by ``ang`` (B, S, Dh/2) in
    f32, one rounding to ``x``'s dtype."""
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)
