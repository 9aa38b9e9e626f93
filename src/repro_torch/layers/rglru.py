"""Griffin / RecurrentGemma RG-LRU recurrent block (arXiv:2402.19427).

Counterpart of ``repro.layers.rglru``, the same parameter names.  Block:
in-proj to two branches -> (conv1d -> RG-LRU) * gelu(gate) -> out-proj.
The temporal conv1d runs through the untangled depthwise path
(``core.untangle``).  The prefill runs the diagonal linear recurrence
h_t = a_t h_{t-1} + b_t as a log-step (Hillis-Steele) scan over S with
JAX's ``associative_scan`` combine; decode is the O(1) update, written
into the state cache in place.

On a mesh (``dist`` splitting 'heads', JAX's ``rglru_init`` specs) each
rank runs its block of the ``lru_width`` channels: ``in_x``, ``in_g``,
``conv``, ``lam``, the scan and the state.  ``wa`` and ``wx`` are
column-parallel on the whole post-conv branch, so it is gathered over
the heads' group first (its backward sums the ranks' cotangents: each
rank reads every channel); ``out`` is row-parallel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import comm
from repro_torch.core.untangle import untangled_depthwise_conv1d
from repro_torch.layers import common as cm

_C = 8.0  # RG-LRU exponent constant


def rglru_init(gen: torch.Generator, cfg, dtype=torch.bfloat16):
    d, dr = cfg.d_model, cfg.lru_width

    def normal(shape, scale):
        return (cm._randn(gen, shape) * scale).to(dtype)
    return {
        "in_x": normal((d, dr), d ** -0.5),
        "in_g": normal((d, dr), d ** -0.5),
        "conv": normal((cfg.conv_width, dr), 0.2),
        "wa": normal((dr, dr), dr ** -0.5),
        "wx": normal((dr, dr), dr ** -0.5),
        "lam": torch.full((dr,), 2.0, dtype=torch.float32,
                          device=gen.device),   # sigmoid(lam)^c ~ decay
        "out": normal((dr, d), dr ** -0.5),
    }


def rglru_specs() -> dict:
    """JAX's ``rglru_init`` specs (the width on "heads")."""
    return {"in_x": cm.spec(None, "heads"), "in_g": cm.spec(None, "heads"),
            "conv": cm.spec(None, "heads"),
            "wa": cm.spec(None, "heads"), "wx": cm.spec(None, "heads"),
            "lam": cm.spec("heads"), "out": cm.spec("heads", None)}


def _rglru_gates(p, x, group=None):
    """x: (..., dr) post-conv branch (this rank's channels on a mesh) ->
    (a, gated_x) in f32; ``group``: the channels' group, over which x is
    gathered whole for ``wa``/``wx``."""
    xw = comm.gather_from(x, group, dim=-1, kind="rec_gather",
                          reduce_bwd=True)
    rg = torch.sigmoid(cm.dense_apply({"w": p["wa"]}, xw).float())
    ig = torch.sigmoid(cm.dense_apply({"w": p["wx"]}, xw).float())
    log_a = -_C * rg * F.softplus(p["lam"])             # log a_t  (<= 0)
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    return a, mult * ig * x.float()


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t (h_{-1} = 0) along dim 1, in ceil(log2 S)
    elementwise passes: pass d combines each position with the one d
    before it, (a_l, b_l) then (a_r, b_r) -> (a_l a_r, b_l a_r + b_r).
    Products of the decays only shrink (a in (0, 1]), so no pass
    overflows."""
    s, d = a.shape[1], 1
    while d < s:
        a, b = (torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], 1),
                torch.cat([b[:, :d], b[:, :-d] * a[:, d:] + b[:, d:]], 1))
        d *= 2
    return b


def _group(dist, cfg):
    """The group the ``lru_width`` channels split over (None: whole)."""
    return cm.tp(dist, "heads", cfg.lru_width)[0]


def rglru_apply(p, xin, cfg, dist=None):
    """Prefill / train.  xin: (B, S, D) -> (B, S, D) (under sequence
    parallelism the rank's S rows of each: ``common.tp_input``)."""
    group = _group(dist, cfg)
    xin = cm.tp_input(xin, group)
    x = cm.dense_apply({"w": p["in_x"]}, xin)
    g = cm.dense_apply({"w": p["in_g"]}, xin)
    x = untangled_depthwise_conv1d(x, p["conv"], causal=True)
    a, bx = _rglru_gates(p, x, group)
    h = linear_scan(a, bx)
    y = h * F.gelu(g.float(), approximate="tanh")
    return cm.row_parallel({"w": p["out"]}, y.to(xin.dtype), group,
                           kind="rec_all_reduce")


def rglru_decode(p, xin, state, cfg, dist=None):
    """O(1) decode.  state: {"h": (B, dr) f32, "conv": (B, K-1, dr)},
    written in place (a captured decode graph holds these buffers; JAX
    returns new ones) and returned; on a mesh this rank's channel block
    of it."""
    assert xin.shape[1] == 1
    group = _group(dist, cfg)
    xin = comm.copy_to(xin, group)
    x = cm.dense_apply({"w": p["in_x"]}, xin)
    g = cm.dense_apply({"w": p["in_g"]}, xin)
    window = torch.cat([state["conv"], x], 1)
    xc = torch.einsum("bkc,kc->bc", window.float(),
                      p["conv"].float())[:, None].to(xin.dtype)
    a, bx = _rglru_gates(p, xc, group)
    hnew = a[:, 0] * state["h"] + bx[:, 0]
    y = hnew[:, None] * F.gelu(g.float(), approximate="tanh")
    out = cm.row_parallel({"w": p["out"]}, y.to(xin.dtype), group,
                          kind="rec_all_reduce")
    state["h"].copy_(hnew)
    state["conv"].copy_(window[:, 1:])
    return out, state
