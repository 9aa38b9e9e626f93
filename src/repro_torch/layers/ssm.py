"""Mamba-2 SSD mixer (state-space duality, arXiv:2405.21060).

Counterpart of ``repro.layers.ssm``, the same parameter names.  Prefill
runs the chunked SSD algorithm: intra-chunk attention-like products and
a carry of the chunk-boundary states, a loop over the chunks where JAX
has ``lax.scan`` (S / ``ssm_chunk`` steps).  Decode is the O(1)
recurrent update, written into the state cache in place.  The short
causal depthwise conv in front of (x, B, C) runs through the untangled
depthwise path (``core.untangle``).

Tensor parallelism (``dist`` whose rules split 'heads', as JAX's specs
put ``in``, ``conv``, ``norm`` and ``out`` there; ``make_dist`` never
does for mamba2, hand-written rules may): the fused in-projection's
blocks do not fall on its segment boundaries (under ``DEFAULT_RULES`` on
(2, 2) the 3352 columns split at 1676, across z | x), so each rank runs
its columns of the in-projection and gathers them, with the conv and
norm weights, over the heads' group; z, x, B, C and dt are whole, the
conv and the SSD run whole on every rank, and the rank's block of the
gated norm's output feeds its rows of ``out``, summed in f32 over the
group.  Where ``out`` is split the ranks read different columns, so the
gathers' backwards reduce-scatter and the replicated parameters' (and
the input's) gradients are summed over the group.  Decode gathers the
rank's blocks of the state cache the same way and writes back its own.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import comm
from repro_torch.core.untangle import untangled_depthwise_conv1d
from repro_torch.layers import common as cm


def ssd_init(gen: torch.Generator, cfg, dtype=torch.bfloat16):
    d, di, h = cfg.d_model, cfg.d_inner, cfg.ssm_heads
    n, g = cfg.ssm_state, cfg.ssm_groups
    dev = gen.device
    conv_dim = di + 2 * g * n

    def normal(shape, scale):
        return (cm._randn(gen, shape) * scale).to(dtype)

    def f32(t):
        return t.to(device=dev, dtype=torch.float32)
    return {
        # fused in-proj: [z (di), x (di), B (g*n), C (g*n), dt (h)]
        "in": normal((d, 2 * di + 2 * g * n + h), d ** -0.5),
        "conv": normal((cfg.ssm_conv, conv_dim), 0.2),
        "A_log": f32(torch.log(torch.linspace(1.0, 16.0, h))),
        "D": f32(torch.ones(h)),
        "dt_bias": f32(torch.zeros(h)),
        "norm": f32(torch.ones(di)),
        "out": normal((di, d), di ** -0.5),
    }



def ssd_specs() -> dict:
    """JAX's ``ssd_init`` specs (the fused in-proj and the width on
    "heads")."""
    return {"in": cm.spec(None, "heads"), "conv": cm.spec(None, "heads"),
            "A_log": cm.spec(None), "D": cm.spec(None),
            "dt_bias": cm.spec(None), "norm": cm.spec("heads"),
            "out": cm.spec("heads", None)}

def _split_in(y, cfg):
    di, g, n = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    return torch.split(y, [di, di, g * n, g * n, cfg.ssm_heads], dim=-1)


def ssd_chunked(x, dt, a_log, b, c, d_skip, chunk: int = 128):
    """Chunked SSD.  x: (B, S, H, P), dt: (B, S, H), b, c: (B, S, G, N)
    -> (B, S, H, P) f32.

    Within a chunk: Y += (C B^T, decay-masked) dt X.  Across chunks: the
    state h (B, H, N, P) carried chunk to chunk with the chunk's decay."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    nchunk = -(-s // chunk)
    pad = nchunk * chunk - s
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
    sp = nchunk * chunk
    a = -torch.exp(a_log)                                   # (H,) negative
    xf = x.float().reshape(bsz, nchunk, chunk, h, p)
    dtf = dt.float().reshape(bsz, nchunk, chunk, h)
    bf = b.float().reshape(bsz, nchunk, chunk, g, n)
    cf = c.float().reshape(bsz, nchunk, chunk, g, n)
    hg = h // g                                             # heads a group
    bf = torch.repeat_interleave(bf, hg, dim=3)             # (B,Nc,Q,H,N)
    cf = torch.repeat_interleave(cf, hg, dim=3)

    da = dtf * a                                            # (B,Nc,Q,H)
    cum = torch.cumsum(da, dim=2)                           # within-chunk
    # decay from position j to i (i >= j): exp(cum[i] - cum[j]), the
    # exponent masked (not the product) so masked entries are exactly 0
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (B,Nc,Qi,Qj,H)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    seg = seg.masked_fill(~tri[None, None, :, :, None], -1e30)
    l_mask = torch.exp(seg)
    xdt = xf * dtf[..., None]                               # (B,Nc,Q,H,P)
    scores = torch.einsum("bnqhs,bnkhs->bnhqk", cf, bf)     # (B,Nc,H,Qi,Qj)
    scores = scores * l_mask.permute(0, 1, 4, 2, 3)
    y_intra = torch.einsum("bnhqk,bnkhp->bnqhp", scores, xdt)

    # chunk-boundary states
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)       # (B,Nc,Q,H)
    state_c = torch.einsum("bnkhs,bnkhp->bnhsp", bf,
                           xdt * decay_to_end[..., None])   # per-chunk inject
    chunk_decay = torch.exp(cum[:, :, -1, :])               # (B,Nc,H)
    hprev = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
    h_in = []
    for ci in range(nchunk):
        h_in.append(hprev)
        hprev = hprev * chunk_decay[:, ci, :, None, None] + state_c[:, ci]
    h_in = torch.stack(h_in, 1)                             # (B,Nc,H,N,P)
    decay_from_start = torch.exp(cum)                       # (B,Nc,Q,H)
    y_inter = torch.einsum("bnqhs,bnhsp->bnqhp",
                           cf * decay_from_start[..., None], h_in)
    y = (y_intra + y_inter).reshape(bsz, sp, h, p)[:, :s]
    return y + d_skip[None, None, :, None] * xf.reshape(bsz, sp, h, p)[:, :s]


def _gated_norm(yss, z, p):
    """Mamba-2's gated RMSNorm: (y * silu(z)) normalised, scaled by
    ``norm``; f32."""
    yn = yss * F.silu(z.float())
    var = torch.mean(yn * yn, -1, keepdim=True)
    return yn * torch.rsqrt(var + 1e-6) * p["norm"]


def _tp(p, xin, cfg, dist):
    """(the params with ``in``'s output, ``conv`` and ``norm`` made whole,
    the in-projection's whole output, the group ``out``'s rows split over
    (None: whole), its row block) under ``dist`` (module docstring)."""
    di, gn = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state
    sizes = {"in": 2 * di + 2 * gn + cfg.ssm_heads, "conv": di + 2 * gn,
             "norm": di}
    group, i, n = cm.tp(dist, "heads", di)
    split = {k: cm.tp(dist, "heads", m)[2] > 1 for k, m in sizes.items()}
    if n == 1 and not any(split.values()):
        return p, cm.dense_apply({"w": p["in"]}, xin), None, (0, di)
    heads = dist.group(dist.resolve(("heads",))[0])
    o_split = n > 1
    p = dict(p)
    if o_split:
        for k in ("A_log", "D", "dt_bias"):
            p[k] = comm.copy_to(p[k], heads, kind="ssd_param")
    for k in ("in", "conv", "norm"):
        if o_split and not split[k]:
            # a whole weight read for other columns on each rank
            p[k] = comm.copy_to(p[k], heads, kind="ssd_param")
    if split["in"] or o_split:
        xin = comm.copy_to(xin, heads)
    y = cm.dense_apply({"w": p["in"]}, xin)
    if split["in"]:
        y = comm.gather_from(y, heads, dim=-1, kind="ssd_in_gather",
                             reduce_bwd=o_split)
    for k, dim in (("conv", -1), ("norm", 0)):
        if split[k]:
            p[k] = comm.gather_from(p[k], heads, dim=dim,
                                    kind="ssd_weight_gather",
                                    reduce_bwd=o_split)
    return p, y, group, (i * di // n, (i + 1) * di // n)


def ssd_apply(p, xin, cfg, dist=None):
    """Full mixer: in-proj -> conv -> SSD -> gated norm -> out-proj
    (``dist``: tensor-parallel, module docstring)."""
    bsz, s, _ = xin.shape
    di, h, n, g = cfg.d_inner, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups
    p, y, group, (r0, r1) = _tp(p, xin, cfg, dist)
    z, x, bmat, cmat, dt = _split_in(y, cfg)
    xbc = torch.cat([x, bmat, cmat], -1)
    xbc = untangled_depthwise_conv1d(xbc, p["conv"], causal=True)
    xbc = F.silu(xbc.float()).to(xin.dtype)
    x = xbc[..., :di].reshape(bsz, s, h, di // h)
    bmat = xbc[..., di:di + g * n].reshape(bsz, s, g, n)
    cmat = xbc[..., di + g * n:].reshape(bsz, s, g, n)
    dt = F.softplus(dt.float() + p["dt_bias"])
    yss = ssd_chunked(x, dt, p["A_log"], bmat, cmat, p["D"],
                      chunk=cfg.ssm_chunk).reshape(bsz, s, di)
    yn = _gated_norm(yss, z, p).to(xin.dtype)
    return cm.row_parallel({"w": p["out"]}, yn[..., r0:r1], group,
                           kind="ssd_all_reduce")


def _state_whole(t, dist, dim, size):
    """(a state cache block gathered whole along ``dim``, its [start,
    stop) there) under the cache's 'heads' spec (``t`` itself whole)."""
    group, i, n = cm.tp(dist, "heads", size)
    if n == 1:
        return t, (0, size)
    return (comm.all_gather(t, group, dim, kind="ssd_state_gather"),
            (i * size // n, (i + 1) * size // n))


def ssd_decode(p, xin, state, cfg, dist=None):
    """O(1) decode.  state: {"h": (B, H, N, P) f32, "conv": (B, K-1,
    conv_dim)}, written in place (a captured decode graph holds these
    buffers; JAX returns new ones) and returned; on a mesh this rank's
    blocks of it (JAX's cache specs), gathered whole for the step and
    written back block by block."""
    bsz, s, _ = xin.shape
    assert s == 1
    di, h, n, g = cfg.d_inner, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups
    p, y, group, (r0, r1) = _tp(p, xin, cfg, dist)
    z, x, bmat, cmat, dt = _split_in(y, cfg)
    hs, (h0, h1) = _state_whole(state["h"], dist, 1, h)
    cs, (k0, k1) = _state_whole(state["conv"], dist, 2, di + 2 * g * n)
    xbc = torch.cat([x, bmat, cmat], -1)                    # (B,1,conv_dim)
    window = torch.cat([cs, xbc], 1)                        # (B,K,conv_dim)
    conv_out = torch.einsum("bkc,kc->bc", window.float(),
                            p["conv"].float())[:, None]
    xbc = F.silu(conv_out).to(xin.dtype)
    x = xbc[..., :di].reshape(bsz, h, di // h)
    bmat = xbc[..., di:di + g * n].reshape(bsz, g, n)
    cmat = xbc[..., di + g * n:].reshape(bsz, g, n)
    bmat = torch.repeat_interleave(bmat, h // g, dim=1)     # (B,H,N)
    cmat = torch.repeat_interleave(cmat, h // g, dim=1)
    dt = F.softplus(dt.float() + p["dt_bias"])[:, 0]        # (B,H)
    dec = torch.exp(dt * -torch.exp(p["A_log"]))            # (B,H)
    inj = torch.einsum("bh,bhs,bhp->bhsp", dt, bmat.float(), x.float())
    hnew = hs * dec[:, :, None, None] + inj
    yss = torch.einsum("bhs,bhsp->bhp", cmat.float(), hnew)
    yss = yss + p["D"][None, :, None] * x.float()
    yn = _gated_norm(yss.reshape(bsz, 1, di), z, p).to(xin.dtype)
    out = cm.row_parallel({"w": p["out"]}, yn[..., r0:r1], group,
                          kind="ssd_all_reduce")
    state["h"].copy_(hnew[:, h0:h1])
    state["conv"].copy_(window[:, 1:, k0:k1])
    return out, state
