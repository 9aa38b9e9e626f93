"""Attention: the flash attention core (with its backward), the MHA/GQA
layer (+ sliding window, qk-norm, qkv bias, M-RoPE), the encoder-decoder's
cross attention and DeepSeek's MLA (multi-head latent attention with its
compressed decode cache).

Counterpart of ``repro.layers.attention``.  Layout: activations
(B, S, D); q/k/v (B, S, H, Dh).  ``gqa_specs``, ``cross_specs`` and
``mla_specs`` are JAX's logical specs (q, k, v columns and the o rows on
"heads"; MLA's ``uq``, ``uk``, ``uv`` on "heads", ``dq`` and ``dkv``
replicated).

Tensor parallelism (``dist`` with 'heads' split over TP ranks): each
rank runs the attention core (kernel F on the card) on its local heads,
the q heads its block of the ``H·Dh`` columns touches, and the kv heads
they read.  Where the block cuts a head (JAX's ``shard_params`` splits the
columns wherever they divide the axis: gemma3-1b's 4 heads over 16 ranks)
the rank gathers its heads' other columns of q, runs F on those whole
heads and keeps its own columns of the output, so a cut head is computed
on each rank that holds part of it (``Heads``); where the local q heads do
not group contiguously onto their kv heads, each q head's kv head is
picked out (``_group_kv``).  Where k and v are not split at whole kv heads
(replicated, or a block that cuts a head) the rank takes the kv heads its
q heads read from the whole projection.  Under autograd such a read is
conjugated: a gathered projection's gradient (k/v, or q where a block
cuts a head) is reduce-scattered back, and a replicated weight's gradient
(k/v, the qk-norm gains) summed over the group, since each rank reads
other heads of it.  The output projection is
row-parallel: the partial products are summed over the group in f32 and
rounded once.  The cross attention runs the same way on its local heads.

Decode on a mesh (``gqa_decode``, ``mla_decode``): the cache is the
rank's block of JAX's layout, kv heads over 'kv_heads' and positions over
'kv_seq'.  Where 'kv_seq' splits the sequence (context-parallel decode)
the new row is written by the rank that holds its position, each rank
scores its own positions, and the softmax is merged over the sequence's
group: the max, then the rescaled numerators and denominators.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import comm
from repro_torch.kernels import flash_attention as fa
from repro_torch.layers import common as cm
from repro_torch.layers import rope as rp
from repro_torch.sharding import _axes

NEG_INF = -2.0 ** 30


def _core(q, k, v, causal, window, q_offset, scale, ck):
    """The forward core: kernel F for CUDA tensors, F's plain version with
    ``ck`` keys a chunk for CPU tensors."""
    if q.device.type == "cpu":
        return fa.flash_attention_plain(q, k, v, causal=causal,
                                        window=window, q_offset=q_offset,
                                        scale=scale, ck=ck)
    return fa.flash_attention(q, k, v, causal=causal, window=window,
                              q_offset=q_offset, scale=scale)


def _mask(qpos, kpos, causal, window):
    mask = torch.ones((qpos.numel(), kpos.numel()), dtype=torch.bool,
                      device=qpos.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window > 0:
        mask &= qpos[:, None] - kpos[None, :] < window
    return mask


def flash_attention_bwd(q, k, v, o, do, *, causal=True, window=0,
                        q_offset=0, scale=None, ck=1024):
    """(dq, dk, dv) of ``o = flash_attention(q, k, v)`` for the cotangent
    ``do``: the flash backward as plain PyTorch products in f32, a loop
    over chunks of ``ck`` keys, twice.  The first pass recomputes each
    row's log-sum-exp of the masked scores (the forward's masks and
    ``NEG_INF``, keys past Sk never entering); the second recomputes
    P = exp(S - lse) chunk by chunk and accumulates dV += Pᵀ dO,
    dS = P ⊙ (dO Vᵀ - delta) on the unmasked pairs, dQ += dS K and
    dK += dSᵀ Q, with delta = rowsum(dO ⊙ O) read from the forward's
    output ``o`` (kernel F's, in its dtype).  Under a causal mask a chunk
    skips the query rows that lie before all its keys.  dK and dV are
    summed over each kv head's group of query heads.  Memory: a few
    (B, H, Sq, ck) f32 tensors at a time, never the (Sq, Sk) matrix."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = scale if scale is not None else d ** -0.5
    dev = q.device
    qf = q.float().reshape(b, sq, kh, g, d)
    dof = do.float().reshape(b, sq, kh, g, d)
    delta = (dof * o.float().reshape(b, sq, kh, g, d)).sum(-1)
    delta = delta.permute(0, 2, 3, 1)                       # (b, kh, g, sq)
    qpos = q_offset + torch.arange(sq, device=dev)
    chunks = []
    for c0 in range(0, sk, ck):
        # rows before the chunk's first key see none of it under causality
        r0 = min(sq, max(0, c0 - q_offset)) if causal else 0
        chunks.append((c0, min(sk, c0 + ck), r0))
    m = torch.full((b, kh, g, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, kh, g, sq), dtype=torch.float32, device=dev)

    def scores(c0, c1, r0):
        s = torch.einsum("bqkgd,bskd->bkgqs", qf[:, r0:],
                         k[:, c0:c1].float()) * scale
        mask = _mask(qpos[r0:], torch.arange(c0, c1, device=dev), causal,
                     window)
        return s.masked_fill(~mask, NEG_INF), mask

    for c0, c1, r0 in chunks:
        s, _ = scores(c0, c1, r0)
        m2 = torch.maximum(m[..., r0:], s.amax(dim=-1))
        l[..., r0:] = l[..., r0:] * torch.exp(m[..., r0:] - m2) \
            + torch.exp(s - m2[..., None]).sum(-1)
        m[..., r0:] = m2
    lse = m + torch.log(l)
    dq = torch.zeros_like(qf)
    dk = torch.zeros((b, sk, kh, d), dtype=torch.float32, device=dev)
    dv = torch.zeros((b, sk, kh, d), dtype=torch.float32, device=dev)
    for c0, c1, r0 in chunks:
        s, mask = scores(c0, c1, r0)
        p = torch.exp(s - lse[..., r0:, None])
        dor = dof[:, r0:]
        dv[:, c0:c1] = torch.einsum("bkgqs,bqkgd->bskd", p, dor)
        dp = torch.einsum("bqkgd,bskd->bkgqs", dor, v[:, c0:c1].float())
        ds = (p * (dp - delta[..., r0:, None])).masked_fill(~mask, 0.0)
        dq[:, r0:] += torch.einsum("bkgqs,bskd->bqkgd", ds,
                                   k[:, c0:c1].float())
        dk[:, c0:c1] = torch.einsum("bkgqs,bqkgd->bskd", ds, qf[:, r0:])
    dq = (dq * scale).reshape(b, sq, h, d)
    return dq.to(q.dtype), (dk * scale).to(k.dtype), dv.to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """The attention core under autograd.  Forward: ``core`` (``_core``:
    kernel F on the card) on detached q, k, v, so the kernel's wrapper,
    which refuses tensors that require grad, sees none.  Backward:
    ``flash_attention_bwd`` on the saved q, k, v and the forward's own
    output O (what delta reads)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, scale, ck,
                core=_core):
        o = core(q.detach(), k.detach(), v.detach(), causal, window,
                 q_offset, scale, ck)
        ctx.save_for_backward(q, k, v, o)
        ctx.kw = dict(causal=causal, window=window, q_offset=q_offset,
                      scale=scale, ck=ck)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                    kv_chunk=1024, scale=None):
    """Online-softmax attention over KV chunks.  q: (B, Sq, H, D); k, v:
    (B, Sk, Kh, D); ``q_offset`` is the absolute position of q[0].

    CUDA tensors go through kernel F, which stages its own key chunks;
    CPU tensors through F's plain version with ``kv_chunk`` keys a chunk.
    Where grad is on and an input requires it, the core runs inside
    ``FlashAttention``, whose backward loops over ``kv_chunk`` keys a
    chunk.  JAX's jnp core pads K/V with zero keys to a multiple of
    ``kv_chunk`` and masks them only through the causal test, so with
    ``causal=False`` and a ragged Sk it differs from F and from the dense
    oracle; the port excludes keys past Sk outright, as the oracle does."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, window, q_offset,
                                    scale, kv_chunk)
    return _core(q, k, v, causal, window, q_offset, scale, kv_chunk)


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


def gqa_specs(cfg) -> dict:
    s = {"q": cm.dense_specs(None, "heads", cfg.qkv_bias),
         "k": cm.dense_specs(None, "heads", cfg.qkv_bias),
         "v": cm.dense_specs(None, "heads", cfg.qkv_bias),
         "o": cm.dense_specs("heads", None)}
    if cfg.qk_norm:
        s["qn"] = cm.rmsnorm_specs()
        s["kn"] = cm.rmsnorm_specs()
    return s


class Heads(NamedTuple):
    """How a rank's block of the 'heads' columns meets the heads
    (``_local_heads``): ``group`` the heads' group (None: whole); ``cols``
    = [c0, c1) the rank's columns of q and of o's rows; ``heads`` = [ha,
    hb) the q heads those columns touch; ``kv`` = [k0, k1) the kv heads
    those heads read; ``cut`` where a column block cuts a head (the rank
    gathers its heads' other columns); ``kv_gather`` where some rank reads
    kv heads outside its block of the k/v projection (every rank then
    gathers it, so the collective runs on all of them)."""

    group: object
    cols: tuple
    heads: tuple
    kv: tuple
    cut: bool
    kv_gather: bool


def _head_span(c0, c1, dh, g):
    """(the q heads [ha, hb) columns [c0, c1) touch, the kv heads they
    read) for ``g`` q heads a kv head."""
    ha, hb = c0 // dh, -(-c1 // dh)
    return (ha, hb), (ha // g, (hb - 1) // g + 1)


def _local_heads(dist, h, kh, dh) -> Heads:
    """``Heads`` of this rank under ``dist``'s 'heads' split (all heads,
    group None, off a mesh or where the q projection stays whole).  A
    block may cut a head (JAX's ``shard_params`` splits ``h·dh`` columns
    wherever they divide the axis, as GSPMD then runs the cut)."""
    group, i, n = cm.tp(dist, "heads", h * dh)
    if n == 1:
        return Heads(None, (0, h * dh), (0, h), (0, kh), False, False)
    g, w = h // kh, h * dh // n
    nk = cm.tp(dist, "heads", kh * dh)[2]
    wk = kh * dh // nk

    def outside(j):
        k0, k1 = _head_span(j * w, (j + 1) * w, dh, g)[1]
        return not (j * wk <= k0 * dh and k1 * dh <= (j + 1) * wk)
    heads, kv = _head_span(i * w, (i + 1) * w, dh, g)
    return Heads(group, (i * w, (i + 1) * w), heads, kv, w % dh != 0,
                 nk > 1 and any(outside(j) for j in range(n)))


def _q_heads(pq, x, hd: Heads, dh, whole=False, kind="q_head_gather"):
    """q of ``x`` on this rank's heads [ha, hb) (every head with
    ``whole``), (B, S, heads, dh): the rank's columns of the projection,
    gathered over the heads' group where its block cuts a head (or for
    ``whole``).  Each rank reads other columns of the gathered q, so its
    backward reduce-scatters: every rank's cotangent summed into the
    owner's columns."""
    b, s, _ = x.shape
    q = cm.dense_apply(pq, x)
    if hd.group is not None and (whole or hd.cut):
        q = comm.gather_from(q, hd.group, dim=-1, kind=kind,
                             reduce_bwd=True)
        if not whole:
            q = q[..., hd.heads[0] * dh:hd.heads[1] * dh]
    return q.reshape(b, s, -1, dh)


def _own_cols(o, hd: Heads, dh, h0=None):
    """The rank's columns [c0, c1) of the attention output ``o`` (B, S,
    heads·dh) computed on heads from ``h0`` (``hd.heads[0]`` by default):
    what its block of o's rows reads."""
    h0 = hd.heads[0] if h0 is None else h0
    c0, c1 = hd.cols
    if (c0 - h0 * dh, c1 - h0 * dh) == (0, o.shape[-1]):
        return o
    return o[..., c0 - h0 * dh:c1 - h0 * dh]


def _group_kv(k, v, heads, kv, g):
    """k and v on the kv heads [k0, k1) as kernel F reads them for the q
    heads [ha, hb): as they are where F's contiguous grouping (local q
    head j on local kv head j // (H_l / K_l)) reads each q head's own kv
    head; else each q head's kv head picked out (one kv head a q head)."""
    (ha, hb), (k0, k1) = heads, kv
    hl, kl = hb - ha, k1 - k0
    want = [(ha + j) // g - k0 for j in range(hl)]
    if hl % kl == 0 and want == [j // (hl // kl) for j in range(hl)]:
        return k, v
    idx = torch.tensor(want, device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def _kv_local(p, x, kh, dh, dist, kv, group, gather):
    """The k (or v) projection's kv heads ``kv`` = [k0, k1) on this rank:
    from the rank's own columns where they hold those heads whole, else
    from the whole projection (gathered over ``group`` where it is split;
    ``gather`` is the same on every rank of the group)."""
    k0, k1 = kv
    _, i, n = cm.tp(dist, "heads", kh * dh)
    if n == 1:
        # the whole projection on every rank, each reading its own kv
        # heads of it: the weight's gradient is summed over the group
        p = {k: comm.copy_to(w, group, kind="kv_weight")
             for k, w in p.items()}
    y = cm.dense_apply(p, x)
    c0 = i * (kh * dh // n)
    if n > 1 and gather:
        # each rank reads other columns of the gathered projection: the
        # backward reduce-scatters
        y = comm.gather_from(y, group, dim=-1, kind="kv_gather",
                             reduce_bwd=True)
        c0 = 0
    return y[..., k0 * dh - c0:k1 * dh - c0]


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


def _qkv(p, x, cfg, hd=None, dist=None, q_whole=False):
    """(q, k, v) heads of ``x``; with ``hd`` (``Heads`` on a mesh) q on
    this rank's heads (every head with ``q_whole``, ``_q_heads``) and k
    and v on the kv heads ``hd.kv`` (``_kv_local``)."""
    b, sq, _ = x.shape
    kh, dh = cfg.num_kv_heads, cfg.head_dim
    if hd is None:
        q = cm.dense_apply(p["q"], x).reshape(b, sq, -1, dh)
        k = cm.dense_apply(p["k"], x)
        v = cm.dense_apply(p["v"], x)
    else:
        q = _q_heads(p["q"], x, hd, dh, q_whole,
                     "decode_q_gather" if q_whole else "q_head_gather")
        tp = (dist, hd.kv, hd.group, hd.kv_gather)
        k = _kv_local(p["k"], x, kh, dh, *tp)
        v = _kv_local(p["v"], x, kh, dh, *tp)
    k = k.reshape(b, sq, -1, dh)
    v = v.reshape(b, sq, -1, dh)
    if "qn" in p:
        qn, kn = p["qn"], p["kn"]
        if hd is not None and hd.group is not None:
            # each rank norms its own heads with the replicated scales:
            # their gradients are summed over the heads' group
            qn, kn = ({k: comm.copy_to(w, hd.group, kind="qk_norm_weight")
                       for k, w in n.items()} for n in (qn, kn))
        q = cm.rmsnorm_apply(qn, q, cfg.norm_eps)
        k = cm.rmsnorm_apply(kn, k, cfg.norm_eps)
    return q, k, v


def gqa_apply(p, x, cfg, *, positions, layer_kind="global", kv_chunk=1024,
              causal=True, dist=None):
    """Training / prefill self-attention.  x: (B, S, D); positions (B, S),
    or (3, B, S) under M-RoPE.  ``dist``: tensor-parallel over 'heads'
    (module docstring)."""
    h, kh = cfg.num_heads, cfg.num_kv_heads
    hd = _local_heads(dist, h, kh, cfg.head_dim)
    x = cm.tp_input(x, hd.group)
    b, sq, _ = x.shape
    if hd.group is None:
        q, k, v = _qkv(p, x, cfg)
    else:
        q, k, v = _qkv(p, x, cfg, hd, dist)
    theta = _theta(cfg, layer_kind)
    q = _rope(q, positions, cfg, theta)
    k = _rope(k, positions, cfg, theta)
    k, v = _group_kv(k, v, hd.heads, hd.kv, h // kh)
    window = cfg.window if layer_kind == "local" else 0
    o = flash_attention(q, k, v, causal=causal, window=window,
                        kv_chunk=kv_chunk)
    o = _own_cols(o.reshape(b, sq, -1), hd, cfg.head_dim)
    return cm.row_parallel(p["o"], o, hd.group)


def _write_rows(cache, rows, idx, s0, group):
    """Write ``rows`` (B, n, ...) at the positions ``idx + [0, n)`` of a
    cache block that holds positions ``[s0, s0 + L)`` on dim 1.  With
    ``group`` (the ranks that hold the sequence's other blocks) a row
    whose position lies in the block is written at ``position - s0`` and
    any other row leaves the block as it is (its owner writes it).
    ``idx`` is a 0-d device tensor and stays one: no host sync."""
    n, length = rows.shape[1], cache.shape[1]
    pos = idx - s0 + torch.arange(n, device=cache.device)
    rows = rows.to(cache.dtype)
    if group is None:
        cache.index_copy_(1, pos, rows)
        return
    own = ((pos >= 0) & (pos < length)).view((1, n) + (1,) * (rows.dim() - 2))
    local = pos.clamp(0, length - 1)
    cache.index_copy_(1, local, torch.where(own, rows,
                                            cache.index_select(1, local)))


def _decode_seq(dist, length, heads_group):
    """(group, first position, gather q) of a decode cache block of
    ``length`` positions under ``dist``'s 'kv_seq' rule: the group of the
    ranks that hold the sequence's other blocks (None where it is whole)
    and this block's first position; ``gather q`` where that group shares
    a mesh axis with the heads' group ``heads_group`` (its ranks hold
    other q heads, so every rank scores every head on its positions)."""
    if dist is None or dist.mesh is None:
        return None, 0, False
    entry = dist.resolve(("kv_seq",))[0]
    n = dist.extent(entry)
    if n == 1:
        return None, 0, False
    j, _ = dist.shard_of(entry, length * n)
    seq_axes = {a for a in _axes(entry) if dist.extent(a) > 1}
    head_axes = {a for a in _axes(dist.resolve(("heads",))[0])
                 if dist.extent(a) > 1}
    return (dist.group(entry), j * length,
            heads_group is not None and bool(seq_axes & head_axes))


def _attend(s, values, eq, group):
    """``einsum(eq, softmax(s), values)``, the softmax over the keys (the
    last dim of ``s``, f32).  With ``group`` (the ranks that hold the keys'
    other blocks) every rank's partial is merged: the max all-reduced,
    then one all-reduce of the rescaled numerators, the denominators
    riding along as one more value column.  A rank whose keys are all
    masked (``NEG_INF``) adds exp(NEG_INF - max) = 0."""
    if group is None:
        return torch.einsum(eq, torch.softmax(s, dim=-1), values)
    m = comm.all_reduce(s.amax(-1), group, kind="kv_seq_max", op="max")
    e = torch.exp(s - m[..., None])
    ones = values.new_ones(values.shape[:-1] + (1,))
    num = torch.einsum(eq, e, torch.cat([values, ones], -1))
    num = comm.all_reduce(num, group, kind="kv_seq_merge")
    return num[..., :-1] / num[..., -1:]


def gqa_decode(p, x, cache, cache_index, cfg, *, layer_kind="global",
               dist=None):
    """Single-token decode.  cache: {"k", "v"}: (B, Smax, Kh, Dh), updated
    in place at ``cache_index`` (JAX returns a new cache; the port writes
    the one it was given and returns it).  ``cache_index`` is a Python int
    or a 0-d int64 tensor on ``x``'s device (what a captured CUDA graph
    needs, as JAX traces it); both give the same bits.  The attention is
    JAX's dense f32 softmax over the whole cache; kernel F is not launched
    here.

    On a mesh (``dist``) ``cache`` is this rank's block of JAX's
    ``("batch", "kv_seq", "kv_heads", None)`` layout and ``x`` its rows.
    The rank's q heads are its 'heads' columns, k and v the kv heads its
    block holds (``_kv_local``); ``o`` is row-parallel.  Where 'kv_seq'
    splits the sequence, the new row is written by the block that holds
    its position only (``_write_rows``), each rank scores its own
    positions and the softmax is merged over the sequence's group
    (``_attend``); where that group shares the heads' axis, q is gathered
    over the heads first and the rank keeps its heads of the output."""
    b, sq, _ = x.shape
    h, kh, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    idx = torch.as_tensor(cache_index, dtype=torch.int64, device=x.device)
    ck, cv = cache["k"], cache["v"]
    hd = _local_heads(dist, h, kh, dh)
    group = hd.group
    sgroup, s0, gather = _decode_seq(dist, ck.shape[1], group)
    kv_entry = None if dist is None else dist.resolve(("kv_heads",))[0]
    c0, c1 = (0, kh) if dist is None else dist.span(kv_entry, kh)
    heads = (0, h) if gather else hd.heads
    ka, kb = (0, kh) if gather else hd.kv
    if group is None:
        q, k, v = _qkv(p, x, cfg)
    else:
        # k and v of the cache block's kv heads, gathered where the
        # projection's blocks are not the cache's
        nk = cm.tp(dist, "heads", kh * dh)[2]
        aligned = (kv_entry == dist.resolve(("heads",))[0]
                   and kh % nk == 0)
        q, k, v = _qkv(p, comm.copy_to(x, group), cfg, hd._replace(
            kv=(c0, c1), kv_gather=nk > 1 and not aligned), dist,
            q_whole=gather)
    pos = idx.expand(b, sq)
    if cfg.mrope_sections:
        pos = pos.expand(3, b, sq)
    theta = _theta(cfg, layer_kind)
    q = _rope(q, pos, cfg, theta)
    k = _rope(k, pos, cfg, theta)
    _write_rows(ck, k, idx, s0, sgroup)
    _write_rows(cv, v, idx, s0, sgroup)
    if not (c0 <= ka and kb <= c1):
        # the rank's q heads read kv heads outside its cache block: the
        # blocks gathered over the kv heads' group (after every rank wrote
        # its own rows)
        kgroup = dist.group(kv_entry)
        ck = comm.all_gather(ck, kgroup, 2, kind="decode_kv_gather")
        cv = comm.all_gather(cv, kgroup, 2, kind="decode_kv_gather")
        c0, c1 = 0, kh
    ck, cv = ck[:, :, ka - c0:kb - c0], cv[:, :, ka - c0:kb - c0]
    ck, cv = _group_kv(ck, cv, heads, (ka, kb), h // kh)
    kv_n = ck.shape[2]
    kpos = s0 + torch.arange(ck.shape[1], device=x.device)
    window = cfg.window if layer_kind == "local" else 0
    qr = q.reshape(b, sq, kv_n, -1, dh).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qr, ck.float()) * (dh ** -0.5)
    mask = kpos <= idx
    if window:
        mask &= kpos > idx - window
    s = s.masked_fill(~mask, NEG_INF)
    o = _attend(s, cv.float(), "bkgqs,bskd->bqkgd", sgroup)
    o = _own_cols(o.reshape(b, sq, -1), hd, dh, heads[0])
    return cm.row_parallel(p["o"], o.to(x.dtype), group), cache


# ---------------------------------------------------------------------------
# cross attention (encoder-decoder)
# ---------------------------------------------------------------------------


def cross_init(gen: torch.Generator, cfg, dtype=torch.bfloat16):
    d, h, kh, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {"q": cm.dense_init(gen, d, h * dh, dtype),
            "k": cm.dense_init(gen, d, kh * dh, dtype),
            "v": cm.dense_init(gen, d, kh * dh, dtype),
            "o": cm.dense_init(gen, h * dh, d, dtype)}


def cross_specs(cfg) -> dict:
    return {"q": cm.dense_specs(None, "heads"),
            "k": cm.dense_specs(None, "heads"),
            "v": cm.dense_specs(None, "heads"),
            "o": cm.dense_specs("heads", None)}


def cross_apply(p, x, memory, cfg, kv_chunk=1024, dist=None):
    """x: (B, Sq, D) decoder states; memory: (B, Sk, D) encoder output.  q
    from the decoder, k and v from the memory, no RoPE, the shared core
    with ``causal=False`` (kernel F on the card: one launch, at prefill
    and at every decode step, where JAX recomputes k and v from the
    memory too).  ``dist``: tensor-parallel over 'heads' as
    ``gqa_apply`` (``memory`` the same rows as ``x``): the rank's q heads
    and the kv heads they read, F on those heads, ``o`` row-parallel."""
    sk = memory.shape[1]
    h, kh, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    hd = _local_heads(dist, h, kh, dh)
    group = hd.group
    x = cm.tp_input(x, group)
    b, sq, _ = x.shape
    if group is None:
        k = cm.dense_apply(p["k"], memory)
        v = cm.dense_apply(p["v"], memory)
    else:
        memory = comm.copy_to(memory, group, kind="cross_memory")
        tp = (dist, hd.kv, group, hd.kv_gather)
        k = _kv_local(p["k"], memory, kh, dh, *tp)
        v = _kv_local(p["v"], memory, kh, dh, *tp)
    q = _q_heads(p["q"], x, hd, dh)
    k, v = _group_kv(k.reshape(b, sk, -1, dh), v.reshape(b, sk, -1, dh),
                     hd.heads, hd.kv, h // kh)
    o = flash_attention(q, k, v, causal=False, kv_chunk=kv_chunk)
    o = _own_cols(o.reshape(b, sq, -1), hd, dh)
    return cm.row_parallel(p["o"], o, group, kind="cross_all_reduce")


# ---------------------------------------------------------------------------
# DeepSeek MLA (multi-head latent attention, compressed KV cache)
# ---------------------------------------------------------------------------


def mla_init(gen: torch.Generator, cfg, dtype=torch.bfloat16):
    d, h = cfg.d_model, cfg.num_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    dev = gen.device
    return {"dq": cm.dense_init(gen, d, qr, dtype),
            "dq_n": cm.rmsnorm_init(qr, dev),
            "uq": cm.dense_init(gen, qr, h * (dn + dr), dtype),
            "dkv": cm.dense_init(gen, d, kvr + dr, dtype),
            "dkv_n": cm.rmsnorm_init(kvr, dev),
            "uk": cm.dense_init(gen, kvr, h * dn, dtype),
            "uv": cm.dense_init(gen, kvr, h * dv, dtype),
            "o": cm.dense_init(gen, h * dv, d, dtype)}


def mla_specs(cfg) -> dict:
    return {"dq": cm.dense_specs(None, None),
            "dq_n": cm.rmsnorm_specs(),
            "uq": cm.dense_specs(None, "heads"),
            "dkv": cm.dense_specs(None, None),
            "dkv_n": cm.rmsnorm_specs(),
            "uk": cm.dense_specs(None, "heads"),
            "uv": cm.dense_specs(None, "heads"),
            "o": cm.dense_specs("heads", None)}


class MlaHeads(NamedTuple):
    """How a rank's blocks of MLA's 'heads' columns meet the heads
    (``_mla_heads``): ``group`` the heads' group (None: every projection
    whole); ``heads`` = [ha, hb) the heads the rank computes, those its
    block of o's rows (``h·v_head_dim`` columns: ``cols``) touches, every
    head where o stays whole; ``o_split`` where o's rows are split (the
    ranks read different heads, so their gradients are summed)."""

    group: object
    heads: tuple
    cols: tuple
    o_split: bool


def _mla_heads(dist, cfg) -> MlaHeads:
    """``MlaHeads`` under ``dist``: o's row block picks the heads; ``uq``,
    ``uk`` and ``uv`` give them from the rank's own columns where they
    split at the same head boundaries, else gathered (``_mla_proj``)."""
    h, dv = cfg.num_heads, cfg.v_head_dim
    widths = (cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.qk_nope_dim, dv)
    if all(cm.tp(dist, "heads", h * w)[2] == 1 for w in widths):
        return MlaHeads(None, (0, h), (0, h * dv), False)
    entry = dist.resolve(("heads",))[0]
    group, i, n = cm.tp(dist, "heads", h * dv)
    if n == 1:
        return MlaHeads(dist.group(entry), (0, h), (0, h * dv), False)
    c0, c1 = i * (h * dv // n), (i + 1) * (h * dv // n)
    return MlaHeads(group, (c0 // dv, -(-c1 // dv)), (c0, c1), True)


def _mla_proj(pw, x, width, cfg, hd: MlaHeads, dist, heads=None,
              kind="mla_head_gather"):
    """A head projection (``uq``, ``uk`` or ``uv``, ``width`` columns a
    head) of ``x`` on the heads ``heads`` (``hd.heads`` by default), (B,
    S, heads, width).  The rank's own columns where they are exactly those
    heads; else the whole output, gathered where the weight is split (each
    rank reads its own heads: a reduce-scatter backward where o is split,
    the rank's slice where every rank computes every head), and a
    replicated weight's gradient summed over the group where o is split.
    ``x`` enters through ``copy_to`` wherever the ranks' gradients of it
    are partial."""
    b, s, _ = x.shape
    h = cfg.num_heads
    ha, hb = hd.heads if heads is None else heads
    if hd.group is None:
        return cm.dense_apply(pw, x).reshape(b, s, h, width)[:, :, ha:hb]
    group, i, n = cm.tp(dist, "heads", h * width)
    own = n > 1 and (ha, hb) == (i * h // n, (i + 1) * h // n) \
        and h % n == 0
    if hd.o_split or n > 1:
        x = comm.copy_to(x, hd.group)
    if n == 1 and hd.o_split:
        pw = {k: comm.copy_to(w, hd.group, kind="mla_weight")
              for k, w in pw.items()}
    y = cm.dense_apply(pw, x)
    if not own:
        if n > 1:
            y = comm.gather_from(y, group, dim=-1, kind=kind,
                                 reduce_bwd=hd.o_split)
        y = y[..., ha * width:hb * width]
    return y.reshape(b, s, hb - ha, width)


def _mla_weight(w, width, cfg, hd: MlaHeads, dist, heads):
    """A head projection's weight on the heads ``heads``, (in, heads,
    width): the rank's columns where they are those heads, else gathered
    whole over the group (decode: no gradient)."""
    h = cfg.num_heads
    ha, hb = heads
    group, i, n = cm.tp(dist, "heads", h * width)
    if n > 1 and not ((ha, hb) == (i * h // n, (i + 1) * h // n)
                      and h % n == 0):
        w = comm.all_gather(w, group, 1, kind="mla_weight_gather")
    if w.shape[1] != (hb - ha) * width:
        w = w[:, ha * width:hb * width]
    return w.reshape(w.shape[0], hb - ha, width)


def _mla_q(p, x, cfg, hd=None, dist=None, heads=None, kind=None):
    """(q_nope (B, S, H, dn), q_rope (B, S, H, dr)) before the rotation,
    on the heads ``heads`` (``_mla_proj``)."""
    dn = cfg.qk_nope_dim
    cq = cm.rmsnorm_apply(p["dq_n"], cm.dense_apply(p["dq"], x),
                          cfg.norm_eps)
    hd = hd or MlaHeads(None, (0, cfg.num_heads), None, False)
    q = _mla_proj(p["uq"], cq, dn + cfg.qk_rope_dim, cfg, hd, dist, heads,
                  kind or "mla_head_gather")
    return q[..., :dn], q[..., dn:]


def _mla_kv(p, x, cfg):
    """(c_kv (B, S, kv_lora_rank) normed, k_rope (B, S, 1, dr) before the
    rotation)."""
    b, sq, _ = x.shape
    kvr = cfg.kv_lora_rank
    ckv_full = cm.dense_apply(p["dkv"], x)
    ckv = cm.rmsnorm_apply(p["dkv_n"], ckv_full[..., :kvr], cfg.norm_eps)
    return ckv, ckv_full[..., kvr:].reshape(b, sq, 1, cfg.qk_rope_dim)


def mla_apply(p, x, cfg, *, positions, kv_chunk=1024, dist=None):
    """Training / prefill MLA (the decompressed form): q and k at head dim
    ``qk_nope + qk_rope`` (192 at deepseek-v3-671b), v zero-padded to it
    for the shared flash core (kernel F on the card: one launch) and the
    output sliced back to ``v_head_dim``, as JAX does.  ``dist``: each
    rank runs the heads its block of o's rows touches (``_mla_heads``;
    ``uq``/``uk``/``uv`` on those heads, gathered where a block cuts a
    head or they split unevenly), its columns of o's output summed in f32
    over the group.  The compressions ``dq`` and ``dkv`` run whole on
    every rank; their outputs enter the head projections through
    ``copy_to``, so their weights' gradients, summed over the group there,
    are whole on every rank."""
    b, sq, _ = x.shape
    hd = _mla_heads(dist, cfg)
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    q_nope, q_rope = _mla_q(p, x, cfg, hd, dist)
    ckv, k_rope = _mla_kv(p, x, cfg)
    h = hd.heads[1] - hd.heads[0]
    if hd.o_split:
        k_rope = comm.copy_to(k_rope, hd.group)
    pos2d = positions if positions.dim() == 2 else positions[0]
    q_rope = rp.apply_rope(q_rope, pos2d, cfg.rope_theta)
    k_rope = rp.apply_rope(k_rope, pos2d, cfg.rope_theta)
    k_nope = _mla_proj(p["uk"], ckv, dn, cfg, hd, dist)
    v = _mla_proj(p["uv"], ckv, dv, cfg, hd, dist)
    q_full = torch.cat([q_nope, q_rope], -1)
    k_full = torch.cat([k_nope, k_rope.expand(b, sq, h, dr)], -1)
    if dv < dn + dr:
        v = torch.nn.functional.pad(v, (0, dn + dr - dv))
    o = flash_attention(q_full, k_full, v, causal=True, kv_chunk=kv_chunk,
                        scale=(dn + dr) ** -0.5)[..., :dv]
    o = _own_cols(o.reshape(b, sq, h * dv), hd, dv)
    return cm.row_parallel(p["o"], o, hd.group if hd.o_split else None)


def mla_decode(p, x, cache, cache_index, cfg, dist=None):
    """Absorbed-form MLA decode: attention runs in the compressed space,
    the cache holds (c_kv, k_rope) only.  cache: {"ckv": (B, Smax,
    kv_lora_rank), "kr": (B, Smax, qk_rope_dim)}, written in place at
    ``cache_index`` (a Python int or a 0-d int64 tensor, as
    ``gqa_decode``).  JAX's f32 einsums: ``W_uk`` folded into q, ``W_uv``
    applied after; kernel F is not launched here.  ``dist``: the rank's
    heads of ``uq``/``uk``/``uv`` (``_mla_heads``), ``o`` row-parallel;
    the compressed cache has no heads, so a 'kv_seq' split (over 'model'
    under ``make_dist``) has each rank score every head on its positions
    (q gathered over the heads where the two groups share an axis) and
    merge as ``gqa_decode`` does."""
    b, sq, _ = x.shape
    h = cfg.num_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    kvr = cfg.kv_lora_rank
    idx = torch.as_tensor(cache_index, dtype=torch.int64, device=x.device)
    hd = _mla_heads(dist, cfg)
    group = hd.group if hd.o_split else None
    cc, cr = cache["ckv"], cache["kr"]
    sgroup, s0, gather = _decode_seq(dist, cc.shape[1], group)
    # every head where the sequence's group shares the heads' axis
    heads = (0, h) if gather else hd.heads
    q_nope, q_rope = _mla_q(p, x, cfg, hd, dist, heads,
                            "decode_q_gather" if gather else None)
    pos = idx.expand(b, sq)
    q_rope = rp.apply_rope(q_rope, pos, cfg.rope_theta)
    ckv, k_rope = _mla_kv(p, x, cfg)
    k_rope = rp.apply_rope(k_rope, pos, cfg.rope_theta)
    _write_rows(cc, ckv, idx, s0, sgroup)
    _write_rows(cr, k_rope[:, :, 0], idx, s0, sgroup)
    wuk = _mla_weight(p["uk"]["w"], dn, cfg, hd, dist, heads).float()
    q_c = torch.einsum("bqhd,khd->bqhk", q_nope.float(), wuk)
    q_r = q_rope.float()
    ccf = cc.float()
    s = (torch.einsum("bqhk,bsk->bhqs", q_c, ccf)
         + torch.einsum("bqhd,bsd->bhqs", q_r, cr.float())) \
        * ((dn + dr) ** -0.5)
    kpos = s0 + torch.arange(cc.shape[1], device=x.device)
    s = s.masked_fill(~(kpos <= idx), NEG_INF)
    o_c = _attend(s, ccf, "bhqs,bsk->bqhk", sgroup)
    ha, hb = hd.heads
    o_c = o_c[:, :, ha - heads[0]:hb - heads[0]]
    wuv = _mla_weight(p["uv"]["w"], dv, cfg, hd, dist, hd.heads).float()
    o = torch.einsum("bqhk,khd->bqhd", o_c, wuv)
    o = _own_cols(o.reshape(b, sq, (hb - ha) * dv), hd, dv).to(x.dtype)
    return cm.row_parallel(p["o"], o, group), cache
