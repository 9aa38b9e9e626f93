"""Mamba-2 SSD mixer (state-space duality, arXiv:2405.21060).

Counterpart of ``repro.layers.ssm``, the same parameter names.  Prefill
runs the chunked SSD algorithm: intra-chunk attention-like products and
a carry of the chunk-boundary states, a loop over the chunks where JAX
has ``lax.scan`` (S / ``ssm_chunk`` steps).  Decode is the O(1)
recurrent update, written into the state cache in place.  The short
causal depthwise conv in front of (x, B, C) runs through the untangled
depthwise path (``core.untangle``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

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


def ssd_apply(p, xin, cfg):
    """Full mixer: in-proj -> conv -> SSD -> gated norm -> out-proj."""
    bsz, s, _ = xin.shape
    di, h, n, g = cfg.d_inner, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups
    y = cm.dense_apply({"w": p["in"]}, xin)
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
    return cm.dense_apply({"w": p["out"]},
                          _gated_norm(yss, z, p).to(xin.dtype))


def ssd_decode(p, xin, state, cfg):
    """O(1) decode.  state: {"h": (B, H, N, P) f32, "conv": (B, K-1,
    conv_dim)}, written in place (a captured decode graph holds these
    buffers; JAX returns new ones) and returned."""
    bsz, s, _ = xin.shape
    assert s == 1
    di, h, n, g = cfg.d_inner, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups
    y = cm.dense_apply({"w": p["in"]}, xin)
    z, x, bmat, cmat, dt = _split_in(y, cfg)
    xbc = torch.cat([x, bmat, cmat], -1)                    # (B,1,conv_dim)
    window = torch.cat([state["conv"], xbc], 1)             # (B,K,conv_dim)
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
    hnew = state["h"] * dec[:, :, None, None] + inj
    yss = torch.einsum("bhs,bhsp->bhp", cmat.float(), hnew)
    yss = yss + p["D"][None, :, None] * x.float()
    out = cm.dense_apply({"w": p["out"]},
                         _gated_norm(yss.reshape(bsz, 1, di), z, p)
                         .to(xin.dtype))
    state["h"].copy_(hnew)
    state["conv"].copy_(window[:, 1:])
    return out, state
