"""Kernel F: forward flash attention, hand-written for Hopper.

``flash_attention`` is the port of ``repro.kernels.flash_attention
.flash_attention_pallas`` (TPU kernel ``_kernel``): the online softmax over
KV chunks with F's causal and sliding-window masks, ``q_offset``, GQA (kv
head = h // g), the finite mask value ``NEG_INF = -2^30`` and f32 scores,
statistics and accumulator, written in q's dtype.  The CUDA source is
``csrc/flash_attention.cu`` (its header says what bounds the kernel on the
card and what the design does about it); ``_build`` compiles it with
``nvcc`` at first use and binds its plain C entry with ``ctypes``.  The
entry goes by dtype: bfloat16 runs on the tensor cores (bf16 ``mma.sync``
with f32 accumulation, P·V on the two-term split P = hi + lo that keeps
F's f32 P within the bf16 gate), float32 on IEEE f32 FFMA (tensor cores
would be TF32).

q (B, Sq, H, D) and k, v (B, Sk, Kh, D) keep JAX's layout and are read by
strides.  Unlike F, any Sq and Sk are taken: keys past Sk are excluded
outright, query rows past Sq are not written.

The wrapper launches the kernel for CUDA tensors and raises on anything
the kernel does not take (a head dim outside ``HEAD_DIMS``, another
dtype, a tensor that requires grad); it takes the plain version
``flash_attention_plain`` (F's recurrence in PyTorch, the same masks and
constants) only for tensors on the CPU.  A fake tensor off the CPU
(``kernels.fake``) gets the empty output, and the launch and its ``work``
go to the analysis that made it; ``launches`` moves only where the kernel
launches.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import fake

NEG_INF = -2.0 ** 30
HEAD_DIMS = (32, 64, 128, 192, 256)
_DTYPES = (torch.float32, torch.bfloat16)
_MAX_Q_TILES = 65535           # grid.y, one query tile each
_Q_TILE = 64                   # the smallest query tile of either entry


def flash_attention_plain(q, k, v, *, causal=True, window=0, q_offset=0,
                          scale=None, ck=512):
    """F's recurrence in PyTorch: KV chunks of ``ck`` keys, the online
    softmax with running max ``m``, sum ``l`` and accumulator in f32, masked
    scores at ``NEG_INF``, P kept in f32 for P·V, ``acc / max(l, 1e-30)``
    rounded to q's dtype.  The last chunk is cut at Sk, so keys past Sk
    never enter."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = scale if scale is not None else d ** -0.5
    dev = q.device
    qf = q.float().reshape(b, sq, kh, g, d)
    qpos = q_offset + torch.arange(sq, device=dev)
    acc = torch.zeros((b, kh, g, sq, d), dtype=torch.float32, device=dev)
    m = torch.full((b, kh, g, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, kh, g, sq), dtype=torch.float32, device=dev)
    for c0 in range(0, sk, ck):
        kc, vc = k[:, c0:c0 + ck].float(), v[:, c0:c0 + ck].float()
        s = torch.einsum("bqkgd,bskd->bkgqs", qf, kc) * scale
        kpos = c0 + torch.arange(kc.shape[1], device=dev)
        mask = torch.ones((sq, kc.shape[1]), dtype=torch.bool, device=dev)
        if causal:
            mask &= qpos[:, None] >= kpos[None, :]
        if window > 0:
            mask &= qpos[:, None] - kpos[None, :] < window
        s = s.masked_fill(~mask, NEG_INF)
        m2 = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m2[..., None])
        r = torch.exp(m - m2)
        acc = acc * r[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p, vc)
        l = l * r + p.sum(dim=-1)
        m = m2
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


@functools.lru_cache(maxsize=256)
def pairs_per_head(sq: int, sk: int, causal: bool = True, window: int = 0,
                   q_offset: int = 0) -> int:
    """The (query, key) pairs F's masks leave in one head: query i at
    position ``q_offset + i`` reads the keys k < Sk with k <= its position
    (``causal``) and position - k < ``window`` (``window`` > 0)."""
    pos = q_offset + np.arange(sq, dtype=np.int64)
    hi = np.minimum(pos, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(pos - window + 1, 0) if window > 0 else np.zeros(sq)
    return int(np.maximum(hi - lo + 1, 0).sum())


def work(q, k, v, *, causal: bool = True, window: int = 0,
         q_offset: int = 0) -> tuple[int, int]:
    """(FLOPs, bytes) of one kernel F call: 4·D a (query, key) pair the
    masks leave (two products, Q·Kᵀ and P·V), and q, k, v and the output
    each moved once at their dtype's size."""
    b, sq, h, d = q.shape
    pairs = b * h * pairs_per_head(sq, k.shape[1], bool(causal),
                                   int(window), int(q_offset))
    return 4 * d * pairs, fake.nbytes(q, k, v) + fake.nbytes(q)


@functools.cache
def _entry():
    from repro_torch.kernels import _build
    fn = _build.load("flash_attention").flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, window, q_offset):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"kernel F takes q (B, Sq, H, D) and k, v "
                         f"(B, Sk, Kh, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    kh = k.shape[2]
    if kh == 0 or h % kh:
        raise ValueError(f"{h} query heads are no multiple of {kh} kv heads")
    if k.shape[1] == 0:
        raise ValueError("kernel F needs at least one key")
    if window < 0 or q_offset < 0:
        raise ValueError(f"window {window} and q_offset {q_offset} must be "
                         f">= 0")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    scale: float | None = None) -> torch.Tensor:
    """Kernel F.  q: (B, Sq, H, D); k, v: (B, Sk, Kh, D), H % Kh == 0.
    Returns (B, Sq, H, D) in q's dtype.  CUDA tensors launch the kernel
    (float32 or bfloat16, D in ``HEAD_DIMS``, each last dim contiguous, no
    grad) and count one in ``flash_attention.launches``; CPU tensors run
    ``flash_attention_plain``."""
    _check(q, k, v, window, q_offset)
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    devs = {t.device for t in (q, k, v)}
    if devs == {torch.device("cpu")}:
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset, scale=scale)
    if len(devs) != 1 or (q.device.type != "cuda" and not fake.is_fake(q)):
        raise ValueError(f"kernel F needs q, k, v on one CUDA device, got "
                         f"{sorted(map(str, devs))}")
    if any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "kernel F has no backward of its own: differentiate through "
            "layers.attention.FlashAttention (F forward, its chunked "
            "backward)")
    if q.dtype not in _DTYPES:
        raise TypeError(f"kernel F takes float32 or bfloat16, got {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"kernel F is built for head dims {HEAD_DIMS}, "
                         f"got {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"kernel F needs {name}'s head dim contiguous")
    if -(-sq // _Q_TILE) > _MAX_Q_TILES or b * h > 2 ** 31 - 1 \
            or max(sq, sk, q_offset + sq) > 2 ** 31 - 1:
        raise ValueError(f"kernel F: (B, Sq, H) = {(b, sq, h)} is too large")
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    if fake.is_fake(q):
        fake.launched("F", work(q, k, v, causal=causal, window=window,
                                q_offset=q_offset))
        return o
    esize = q.element_size()
    vec = int(all(t.data_ptr() % 16 == 0
                  and all((t.stride(i) * esize) % 16 == 0 for i in range(3))
                  for t in (q, k, v)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _entry()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            int(q.dtype == torch.bfloat16), b, h, kh, sq, sk, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(causal), int(window), int(q_offset), float(scale), vec,
            stream)
    if rc != 0:
        raise RuntimeError(f"kernel F launch failed: cudaError {rc}")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
