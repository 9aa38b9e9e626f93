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
weights scaled by ``routed_scaling``).

On a mesh (``moe_apply(p, x, cfg, dist)``, JAX's dispatch) a
``moe_impl="ep"`` config takes JAX's expert-parallel semantics, with the
expert-capacity drop (``capacity_factor``):

* ``moe_apply_ep`` (one expert axis, 'model'): each model rank runs its
  ``E/TP`` local experts over its data rank's tokens, each expert on its
  top-``cap`` tokens by gate (``cap = min(T_l, max(1, int(T_l·k·cf) //
  E))``, a ``gv > 0`` mask), and the f32 outputs are summed over 'model'.
* ``moe_apply_ep_a2a`` (experts over several axes, e.g. ('data',
  'model')): tokens padded to a multiple of the EP extent (``valid``
  masks the pad) and split over the batch and expert axes; each rank
  builds the ``(E, cap, D)`` dispatch of its tokens, ``all_to_all`` sends
  each expert's block to its rank, the local experts run, ``all_to_all``
  brings the results back and they are scatter-added in f32.

Under autograd each path is conjugated as JAX's SPMD transpose is: the
router, replicated, reads other tokens or other experts' gates on each
rank, so its gradient is summed over the expert ranks that share a batch
row (``copy_to``; the train step sums the batch axes), and a token
gather whose rows other ranks read reduce-scatters its gradient back.

Their arithmetic is JAX's EP arithmetic, not the dense path's:
``_expert_ffn_ep`` takes its products in the input dtype and casts ``h``
to it before ``@ wo``.  ``jax.lax.top_k`` breaks ties by the lower
index; the capacity selection here is a stable descending sort, which
does the same.  A ``moe_impl="dense"`` config on a mesh keeps the dense
semantics (no capacity), its experts split as the rules say: each rank's
experts over the tokens of its expert group, summed in f32 over the group.

Where 'expert_ffn' splits the experts' hidden dim (``make_dist`` sets it
to 'data' for dbrx-132b on the production mesh, beside 'expert' on
'model'), every path first gathers the layer's hidden blocks over those
axes (``_whole_hidden``), as GSPMD gathers them into JAX's ``shard_map``
whose specs name 'expert' only, and runs as above.  The gather's backward
reduce-scatters: the weights' gradients summed over the ranks of the
axes, which, 'data' carrying batch rows, is also their sum over the
batch (the train step sums over the batch axes a spec leaves out only).
"""
from __future__ import annotations

import torch

from repro_torch.core import comm
from repro_torch.core.reference import ieee_fp32
from repro_torch.kernels import fake
from repro_torch.layers import common as cm
from repro_torch.sharding import _axes


def _expert_init(gen: torch.Generator, shape, scale, dtype, keep=None):
    """(E, ...) normal weights times ``scale`` in ``dtype``, drawn one
    expert at a time (no f32 copy of the whole stack).  ``keep`` = (e0,
    e1) keeps experts ``[e0, e1)`` only, every expert still drawn (the
    same numbers as the whole stack's)."""
    from torch._subclasses.fake_tensor import FakeTensor
    e0, e1 = keep or (0, shape[0])
    w = torch.empty((e1 - e0,) + tuple(shape[1:]), dtype=dtype,
                    device=gen.device)
    if isinstance(w, FakeTensor):
        return w            # shapes only (``param_shapes``): no draw is read
    for e in range(shape[0]):
        x = cm._randn(gen, shape[1:])
        if e0 <= e < e1:
            w[e - e0] = (x * scale).to(dtype)
    return w


def moe_init(gen: torch.Generator, cfg, dtype=torch.bfloat16, keep=None):
    """JAX's tree: ``router`` f32 (d, E), ``bias`` f32 (E,), ``wi``/``wg``
    (E, d, de), ``wo`` (E, de, d); ``keep`` = (e0, e1) keeps those experts
    of the three stacks (a rank's block, drawn in the whole stack's
    order)."""
    d, de, e = cfg.d_model, cfg.d_expert, cfg.n_experts
    scale = d ** -0.5
    return {"router": cm._randn(gen, (d, e)) * scale,
            "bias": torch.zeros((e,), dtype=torch.float32,
                                device=gen.device),
            "wi": _expert_init(gen, (e, d, de), scale, dtype, keep),
            "wg": _expert_init(gen, (e, d, de), scale, dtype, keep),
            "wo": _expert_init(gen, (e, de, d), de ** -0.5, dtype, keep)}


def moe_specs() -> dict:
    """JAX's ``moe_init`` specs."""
    return {"router": cm.spec(None, None), "bias": cm.spec(None),
            "wi": cm.spec("expert", None, "expert_ffn"),
            "wg": cm.spec("expert", None, "expert_ffn"),
            "wo": cm.spec("expert", "expert_ffn", None)}


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


def _expert_counts(flat, n_experts: int) -> list[int]:
    """Tokens routed to each expert, on the host.  A fake tensor
    (``launch.hlo_analysis``) has no data: its counts are the balanced
    load, ``len(flat) / n_experts`` an expert, the first ones one more
    where it does not divide (the load ``roofline.model_flops_for``
    assumes), and the analysis is told so."""
    if fake.is_fake(flat):
        fake.note("moe_load", "balanced")
        q, r = divmod(flat.numel(), n_experts)
        return [q + (e < r) for e in range(n_experts)]
    return torch.bincount(flat, minlength=n_experts).tolist()


def _moe_sorted(p, x2, w, idx, cfg, e0=0):
    """The f32 sum over tokens' selected experts among the ``p`` experts
    ``[e0, e0 + E_l)``: the tokens sorted by expert, one product per
    expert that has any, ``gate · y`` scatter-added in expert order."""
    e_l = p["wi"].shape[0]
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    tok = order // cfg.top_k                  # token of each sorted slot
    gate = w.reshape(-1)[order]
    counts = _expert_counts(flat, cfg.n_experts)
    out = torch.zeros(x2.shape, dtype=torch.float32, device=x2.device)
    start = sum(counts[:e0])
    for e in range(e_l):
        n = counts[e0 + e]
        if n == 0:
            continue
        t = tok[start:start + n]
        y = _expert_ffn_f32(p["wi"][e], p["wg"][e], p["wo"][e],
                            x2.index_select(0, t), cfg.act)
        out.index_add_(0, t, y * gate[start:start + n, None])
        start += n
    return out


def moe_apply(p, x, cfg, dist=None):
    """The MoE FFN (prefill, forward).  Off a mesh: ``moe_apply_dense``'s
    result, computed as one product per expert over the tokens routed to
    it (sorted by expert), the gated outputs scatter-added in f32 (each
    expert's call adds once to a token, in expert order: deterministic on
    the card), cast once.  Eager only: the expert counts go to the
    host.  On a mesh JAX's dispatch: ``moe_impl="ep"`` takes
    ``moe_apply_ep_a2a`` where ``rules["expert"]`` is a tuple,
    ``moe_apply_ep`` where it is one axis; a dense config keeps the dense
    semantics on its split experts (``_moe_dense_split``); the experts'
    hidden blocks are gathered first where 'expert_ffn' splits them."""
    if dist is not None and dist.mesh is not None:
        p = _whole_hidden(p, cfg, dist)
        if cfg.moe_impl == "ep":
            if isinstance(dist.rules.get("expert"), tuple):
                return moe_apply_ep_a2a(p, x, cfg, dist)
            return moe_apply_ep(p, x, cfg, dist)
        return _moe_dense_split(p, x, cfg, dist)
    b, s, d = x.shape
    x2 = x.reshape(b * s, d)
    w, idx = _route(x2, p, cfg)
    return _moe_sorted(p, x2, w, idx, cfg).to(x.dtype).reshape(b, s, d)


# ---------------------------------------------------------------------------
# on a mesh
# ---------------------------------------------------------------------------


def _whole_hidden(p, cfg, dist):
    """The rank's experts with their hidden dim whole: where 'expert_ffn'
    splits it, ``wi``/``wg`` (E_l, d, de) and ``wo`` (E_l, de, d) gathered
    over its axes, the backward a reduce-scatter (module docstring)."""
    group, _, n = cm.tp(dist, "expert_ffn", cfg.d_expert)
    if n == 1:
        return p
    return dict(p, **{k: comm.gather_from(p[k], group, dim=dim,
                                          kind="expert_ffn_gather",
                                          reduce_bwd=True)
                      for k, dim in (("wi", 2), ("wg", 2), ("wo", 1))})


def _expert_split(dist, cfg):
    """(mesh axes the experts split over, their group, this rank's first
    expert, local count)."""
    entry = dist.rules.get("expert")
    i, n = dist.shard_of(entry, cfg.n_experts)
    axes = tuple(a for a in _axes(entry) if dist.extent(a) > 1) if n > 1 \
        else ()
    return axes, dist.group(axes), i * (cfg.n_experts // n), \
        cfg.n_experts // n


def _batch_axes(dist) -> tuple:
    return tuple(a for a in _axes(dist.rules.get("batch"))
                 if dist.extent(a) > 1)


def _moe_dense_split(p, x, cfg, dist):
    """Dense semantics on split experts: the tokens of every rank that
    holds other experts gathered (over the batch axes the expert group
    spans), each rank's experts over them in f32, the sum over the
    expert group, this rank's rows, cast once."""
    b, s, d = x.shape
    axes, group, e0, _ = _expert_split(dist, cfg)
    shared = tuple(a for a in _batch_axes(dist) if a in axes)
    tgroup = dist.group(shared)
    # the expert axes off the batch see the same rows: their partial
    # gradients of the rows and of the router are summed there (copy_to);
    # the gathered rows' come back summed over the batch axes they span
    rgroup = dist.group(tuple(a for a in axes if a not in shared))
    x2 = comm.copy_to(x.reshape(b * s, d), rgroup)
    xa = comm.gather_from(x2, tgroup, dim=0, kind="moe_token_gather",
                          reduce_bwd=True)
    p = dict(p, router=comm.copy_to(p["router"], rgroup))
    w, idx = _route(xa, p, cfg)
    out = comm.reduce_from(_moe_sorted(p, xa, w, idx, cfg, e0), group,
                           kind="moe_all_reduce")
    out = comm.split_to(out, tgroup, dim=0)
    return out.to(x.dtype).reshape(b, s, d)


def _top_k(v, k: int):
    """``jax.lax.top_k`` along the last dim: values descending, ties by
    the lower index (a stable descending sort)."""
    vals, idx = torch.sort(v, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _mm_in(a, b):
    """``a @ b`` in JAX's promoted dtype of the two (f32 sum, one
    rounding): IEEE f32 products on the CPU and for f32 operands."""
    dt = torch.promote_types(a.dtype, b.dtype)
    if a.device.type == "cpu" or dt == torch.float32:
        with ieee_fp32():
            return torch.matmul(a.float(), b.float()).to(dt)
    return torch.matmul(a.to(dt), b.to(dt))


def _expert_ffn_ep(wi, wg, wo, x, act):
    """JAX's ``_expert_ffn``: ``act(x·wg) * (x·wi)`` in f32 from products
    in the input dtype, cast to it before ``· wo``."""
    h = cm.ACTS[act](_mm_in(x, wg).float()) * _mm_in(x, wi).float()
    return _mm_in(h.to(x.dtype), wo)


def _capacity(t_l: int, cfg) -> int:
    return min(t_l, max(1, int(t_l * cfg.top_k * cfg.capacity_factor)
                        // cfg.n_experts))


def ep_local_body(x2, p, cfg, e0: int):
    """JAX's ``_ep_local_body`` on one rank before its psum: the f32 sum
    of this rank's experts ``[e0, e0 + E_l)`` over its tokens ``x2``
    (T_l, D), each expert on its top-``cap`` tokens by gate."""
    t_l, d = x2.shape
    w, idx = _route(x2, p, cfg)
    cap = _capacity(t_l, cfg)
    out = torch.zeros((t_l, d), dtype=torch.float32, device=x2.device)
    for e in range(p["wi"].shape[0]):
        gate_e = torch.where(idx == e0 + e, w, 0.0).sum(-1)
        gv, tok = _top_k(gate_e, cap)
        ye = _expert_ffn_ep(p["wi"][e], p["wg"][e], p["wo"][e],
                            x2.index_select(0, tok), cfg.act)
        ye = ye.float() * gv[:, None]
        out.index_add_(0, tok, torch.where((gv > 0)[:, None], ye, 0.0))
    return out


def moe_apply_ep(p, x, cfg, dist):
    """JAX's ``moe_apply_ep``: this rank's tokens (its batch rows, as
    ``x`` holds them) through its ``E/TP`` experts with the capacity
    drop, the f32 outputs summed over the expert axis, cast once."""
    b, s, d = x.shape
    axes, group, e0, _ = _expert_split(dist, cfg)
    if len(axes) > 1:
        raise ValueError(f"moe_apply_ep takes one expert axis, got {axes}")
    x2 = comm.copy_to(x.reshape(b * s, d), group)
    # every rank routes the same tokens and reads its experts' gates: the
    # router's gradient is summed over the group
    p = dict(p, router=comm.copy_to(p["router"], group))
    out = comm.reduce_from(ep_local_body(x2, p, cfg, e0), group,
                           kind="ep_psum")
    return out.to(x.dtype).reshape(b, s, d)


def ep_dispatch(x2, valid, p, cfg):
    """One rank's side of JAX's ``_ep_a2a_body`` up to the first
    all-to-all: (the (E, cap, D) dispatch buffer, the gates (E, cap),
    their tokens (E, cap))."""
    t_l, d = x2.shape
    e = cfg.n_experts
    w, idx = _route(x2, p, cfg)
    w = w * valid[:, None].to(w.dtype)
    cap = _capacity(t_l, cfg)
    gates = torch.zeros((t_l, e), dtype=torch.float32,
                        device=x2.device).scatter_add_(1, idx, w)
    gv, tok = _top_k(gates.t(), cap)                           # (E, cap)
    buf = x2.index_select(0, tok.reshape(-1)).reshape(e, cap, d)
    buf = torch.where((gv > 0)[..., None], buf, torch.zeros((), dtype=buf.dtype,
                                                             device=buf.device))
    return buf, gv, tok


def ep_experts(recv, p, cfg, n_dev: int):
    """The local experts on what the first all-to-all delivered: recv
    (E, cap, D) in (source rank, local expert) order -> the results in
    the same order."""
    e_l = p["wi"].shape[0]
    _, cap, d = recv.shape
    recv = recv.reshape(n_dev, e_l, cap, d)
    outs = [_expert_ffn_ep(p["wi"][el], p["wg"][el], p["wo"][el],
                           recv[:, el].reshape(n_dev * cap, d),
                           cfg.act).reshape(n_dev, cap, d)
            for el in range(e_l)]
    return torch.stack(outs, 1).reshape(n_dev * e_l, cap, d)


def ep_combine(ret, gv, tok, t_l: int, dtype):
    """The scatter-add of the returned expert outputs times their gates,
    in f32, cast once."""
    d = ret.shape[-1]
    flat = (ret.float() * gv[..., None]).reshape(-1, d)
    flat = torch.where((gv > 0).reshape(-1, 1), flat, 0.0)
    y = torch.zeros((t_l, d), dtype=torch.float32, device=ret.device)
    y.index_add_(0, tok.reshape(-1), flat)
    return y.to(dtype)


def moe_apply_ep_a2a(p, x, cfg, dist):
    """JAX's ``moe_apply_ep_a2a``: the (B·S) tokens padded to a multiple
    of the EP extent and split over the batch and expert axes (in mesh
    order, the first axis major); each rank dispatches its block to the
    experts' ranks (``all_to_all``), runs its local experts, takes the
    results back (``all_to_all``) and scatter-adds them; the blocks are
    gathered back into this rank's batch rows."""
    b, s, d = x.shape
    axes, group, _, _ = _expert_split(dist, cfg)
    n_ep = dist.extent(axes)
    names = list(dist.mesh.mesh_dim_names)
    tok_axes = tuple(sorted(set(_batch_axes(dist)) | set(axes),
                            key=names.index))
    ba = _batch_axes(dist)
    t_loc = b * s
    n_tok = dist.extent(tok_axes)
    n_b = dist.extent(ba)
    x2 = x.reshape(t_loc, d)
    if tok_axes[:len(ba)] == ba and t_loc % (n_tok // n_b) == 0:
        # this rank's batch rows are its tok group's blocks: split them
        inner = dist.group(tok_axes[len(ba):])
        xt = comm.split_to(x2, inner, dim=0, kind="moe_token_split")
        valid = torch.ones((xt.shape[0],), dtype=torch.bool, device=x.device)
        t_l = xt.shape[0]
        pad = 0
    else:
        # the general case: every token of the batch, padded, split
        bgroup = dist.group(ba)
        inner = dist.group(tok_axes)
        xa = comm.gather_from(x2, bgroup, dim=0, kind="moe_token_gather")
        tokens = xa.shape[0]
        padded = -(-tokens // n_tok) * n_tok
        pad = padded - tokens
        valid = torch.arange(padded, device=x.device) < tokens
        xa = torch.nn.functional.pad(xa, (0, 0, 0, pad))
        xt = comm.split_to(xa, inner, dim=0, kind="moe_token_split")
        i, _ = dist.shard_of(tok_axes, padded)
        t_l = xt.shape[0]
        valid = valid[i * t_l:(i + 1) * t_l]
    # each rank routes other tokens: the router's gradient is summed over
    # the token axes off the batch (the train step sums the batch axes)
    p = dict(p, router=comm.copy_to(
        p["router"], dist.group(tuple(a for a in tok_axes if a not in ba))))
    buf, gv, tok = ep_dispatch(xt, valid, p, cfg)
    recv = comm.all_to_all_fn(buf, group, kind="ep_all_to_all")
    back = ep_experts(recv, p, cfg, n_ep)
    ret = comm.all_to_all_fn(back, group, kind="ep_all_to_all")
    y = ep_combine(ret, gv, tok, t_l, x.dtype)
    y = comm.gather_from(y, inner, dim=0, kind="moe_token_gather")
    if pad or y.shape[0] != t_loc:
        y = y[:y.shape[0] - pad]
        y = comm.split_to(y, dist.group(ba), dim=0)
    return y.reshape(b, s, d)


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
