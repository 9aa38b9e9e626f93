"""Dense oracles for the hand-written kernels (a CPU and test oracle only).

Counterpart of ``repro.kernels.ref``'s ``flash_attention_ref``.  The
convolution oracles live in ``core/reference.py``."""
from __future__ import annotations

import torch

NEG_INF = -2.0 ** 30


def flash_attention_ref(q, k, v, *, causal=True, window=0, scale=None,
                        q_offset=0):
    """Dense-softmax oracle for kernel F.  q: (B, Sq, H, D); k, v:
    (B, Sk, Kh, D).  Computes in f32 (f64 for f64 inputs) and rounds to
    q's dtype.  ``q_offset`` (absent in JAX's, where it is 0) puts q[0] at
    that absolute position for the causal and window masks."""
    b, sq, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    scale = scale or d ** -0.5
    ct = torch.promote_types(q.dtype, torch.float32)
    qr = q.reshape(b, sq, kh, g, d).to(ct)
    s = torch.einsum("bqkgd,bskd->bkgqs", qr, k.to(ct)) * scale
    qpos = q_offset + torch.arange(sq, device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = torch.ones((sq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window:
        mask &= qpos[:, None] - kpos[None, :] < window
    s = s.masked_fill(~mask, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", w, v.to(ct))
    return o.reshape(b, sq, h, d).to(q.dtype)
