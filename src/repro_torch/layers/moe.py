"""Mixture-of-Experts on one card: the exact top-k combine.

Counterpart of ``repro.layers.moe`` without a mesh (``dist=None``, as
JAX's ``serve`` runs it): its ``moe_apply`` then takes
``moe_apply_dense``, every selected expert on every token in f32 with no
capacity drop.  The port computes that function without running every
expert on every token (at deepseek-v3-671b a prefill at S = 4096 would
hold a (T, E, d) f32 array of 30 GB):

* ``moe_apply`` (prefill, forward; eager): the tokens sorted by expert,
  one product per expert that has any, a scatter-add of ``gate · y`` in
  f32, cast once.  It reads the expert counts on the host.
* ``moe_decode`` (``decode_step``): static shapes and no host sync, so a
  CUDA graph captures it: each (token, slot)'s expert weights gathered,
  one batched product per weight, the k slots summed in f32.  It moves
  the selected experts' weights three times (read, gathered copy written,
  copy read): ROADMAP Queue 2.
* ``moe_apply_dense``: JAX's all-experts form (every expert on every
  token, combined by the gate matrix), a loop over experts so that no
  (T, E, ·) array is made; the plain reference both forms are held to.

Products of bf16 inputs are exact in f32 and summed in f32 (cuBLAS with
an f32 output on the card, f32 operands on the CPU); ``h = act(x·wg) *
(x·wi)`` stays f32 through ``h @ wo``, as in JAX's dense path.  The router
product ``x.float() @ router`` runs in IEEE f32 with TF32 off on the card
whatever the global setting: TF32 would change the top-k selection.

Routers: 'softmax' (DBRX: top-k softmax renormalized) and 'sigmoid_bias'
(DeepSeek-V3 aux-loss-free: sigmoid affinity + selection-only bias, the
weights scaled by ``routed_scaling``).  JAX's expert-parallel paths
(``moe_apply_ep``, ``moe_apply_ep_a2a``: shard_map over a mesh, with
expert capacity) are ROADMAP Queue 1 item 13b.
"""
from __future__ import annotations

import torch

from repro_torch.core.reference import ieee_fp32
from repro_torch.layers import common as cm


def _expert_init(gen: torch.Generator, shape, scale, dtype):
    """(E, ...) normal weights times ``scale`` in ``dtype``, drawn one
    expert at a time (no f32 copy of the whole stack)."""
    w = torch.empty(shape, dtype=dtype, device=gen.device)
    for e in range(shape[0]):
        w[e] = (cm._randn(gen, shape[1:]) * scale).to(dtype)
    return w


def moe_init(gen: torch.Generator, cfg, dtype=torch.bfloat16):
    """JAX's tree: ``router`` f32 (d, E), ``bias`` f32 (E,), ``wi``/``wg``
    (E, d, de), ``wo`` (E, de, d)."""
    d, de, e = cfg.d_model, cfg.d_expert, cfg.n_experts
    scale = d ** -0.5
    return {"router": cm._randn(gen, (d, e)) * scale,
            "bias": torch.zeros((e,), dtype=torch.float32,
                                device=gen.device),
            "wi": _expert_init(gen, (e, d, de), scale, dtype),
            "wg": _expert_init(gen, (e, d, de), scale, dtype),
            "wo": _expert_init(gen, (e, de, d), de ** -0.5, dtype)}


def _route(x2d, p, cfg):
    """x2d: (T, D) -> (weights (T, k) f32, idx (T, k) int64)."""
    with ieee_fp32():
        logits = x2d.float() @ p["router"].float()
    if cfg.router_type == "sigmoid_bias":
        scores = torch.sigmoid(logits)
        _, idx = torch.topk(scores + p["bias"].float(), cfg.top_k, dim=-1)
        w = torch.gather(scores, -1, idx)
        w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)
        w = w * cfg.routed_scaling
    else:
        scores = torch.softmax(logits, dim=-1)
        w, idx = torch.topk(scores, cfg.top_k, dim=-1)
        w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)
    return w, idx


def _mm_f32(a, b):
    """a @ b (batched or not) as f32: bf16 operands' products summed in
    f32 with an f32 result on the card (``common.mm_f32``, which has a
    backward); f32 operands on the CPU and for f32 tensors, in IEEE
    f32."""
    if a.device.type == "cpu" or a.dtype == torch.float32 \
            or b.dtype == torch.float32:
        with ieee_fp32():
            return torch.matmul(a.float(), b.float())
    return cm.mm_f32(a, b.to(a.dtype))


def _expert_ffn_f32(wi, wg, wo, x, act):
    """One expert (or a batch of gathered experts) on ``x``, in f32:
    ``act(x·wg) * (x·wi)`` kept f32 through ``· wo``."""
    h = cm.ACTS[act](_mm_f32(x, wg)) * _mm_f32(x, wi)
    with ieee_fp32():
        return torch.matmul(h, wo.float())


def moe_apply_dense(p, x, cfg):
    """JAX's exact all-experts-all-tokens combine: every expert on every
    token in f32, summed over experts with the (T, E) gate matrix as
    weights.  A loop over experts, each one (T, d) f32 product."""
    b, s, d = x.shape
    x2 = x.reshape(b * s, d)
    w, idx = _route(x2, p, cfg)
    gates = torch.zeros((b * s, cfg.n_experts), dtype=torch.float32,
                        device=x.device).scatter_add_(1, idx, w)
    xf = x2.float()
    out = torch.zeros((b * s, d), dtype=torch.float32, device=x.device)
    for e in range(cfg.n_experts):
        y = _expert_ffn_f32(p["wi"][e].float(), p["wg"][e].float(),
                            p["wo"][e], xf, cfg.act)
        out += y * gates[:, e:e + 1]
    return out.to(x.dtype).reshape(b, s, d)


def moe_apply(p, x, cfg):
    """The one-card MoE (prefill, forward): ``moe_apply_dense``'s result,
    computed as one product per expert over the tokens routed to it
    (sorted by expert), the gated outputs scatter-added in f32 (each
    expert's call adds once to a token, in expert order: deterministic on
    the card), cast once.  Eager only: the expert counts go to the
    host."""
    b, s, d = x.shape
    x2 = x.reshape(b * s, d)
    w, idx = _route(x2, p, cfg)
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    tok = order // cfg.top_k                  # token of each sorted slot
    gate = w.reshape(-1)[order]
    counts = torch.bincount(flat, minlength=cfg.n_experts).tolist()
    out = torch.zeros((b * s, d), dtype=torch.float32, device=x.device)
    start = 0
    for e, n in enumerate(counts):
        if n == 0:
            continue
        t = tok[start:start + n]
        y = _expert_ffn_f32(p["wi"][e], p["wg"][e], p["wo"][e],
                            x2.index_select(0, t), cfg.act)
        out.index_add_(0, t, y * gate[start:start + n, None])
        start += n
    return out.to(x.dtype).reshape(b, s, d)


def moe_decode(p, x, cfg):
    """The same function in static shapes with no host sync (``decode_step``
    under a CUDA graph): each token's k experts' weights gathered, three
    batched products over the (T·k) pairs, the k gated outputs summed in
    f32 in slot order, cast once.  Suited to few tokens: it copies T·k
    experts' weights."""
    b, s, d = x.shape
    k = cfg.top_k
    x2 = x.reshape(b * s, d)
    w, idx = _route(x2, p, cfg)
    flat = idx.reshape(-1)
    xr = x2[:, None, None, :].expand(b * s, k, 1, d).reshape(-1, 1, d)
    y = _expert_ffn_f32(p["wi"].index_select(0, flat),
                        p["wg"].index_select(0, flat),
                        p["wo"].index_select(0, flat), xr, cfg.act)
    y = y.reshape(b * s, k, d) * w[..., None]
    out = y[:, 0]
    for j in range(1, k):
        out = out + y[:, j]
    return out.to(x.dtype).reshape(b, s, d)


def update_balance_bias(bias, expert_load, gamma: float = 1e-3):
    """DeepSeek-V3 aux-loss-free balancing (arXiv:2408.15664): between
    steps, nudge each expert's selection bias against its load error.

    expert_load: (E,) fraction of routed tokens per expert this step."""
    target = 1.0 / bias.shape[-1]
    return bias - gamma * torch.sign(expert_load - target)


def expert_load_from_idx(idx, n_experts: int):
    """(T, k) routing indices -> (E,) load fractions (f32)."""
    one = torch.zeros((n_experts,), dtype=torch.float32, device=idx.device)
    one.index_add_(0, idx.reshape(-1),
                   torch.ones((idx.numel(),), dtype=torch.float32,
                              device=idx.device))
    return one / idx.numel()
