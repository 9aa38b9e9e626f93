"""Decoder-only and encoder-decoder transformer over the layer kinds
``attn``/``local``/``global`` (GQA attention), ``moe`` (GQA + MoE FFN),
``mla``/``mla_moe`` (DeepSeek's MLA, with a dense or MoE FFN), ``rec``
(RG-LRU), ``ssd`` (Mamba-2), ``enc`` (non-causal GQA) and ``dec`` (causal
GQA, then cross attention over the encoder's output).

Counterpart of ``repro.models.transformer`` for every architecture of its
registry: ``init``, ``encode``, ``forward`` (teacher-forced logits),
``loss_fn``, the decode cache and ``decode_step``, with the gemma norm
(the ``(1 + g)`` RMSNorm and the sqrt(d) embedding scale), sandwich
norms, M-RoPE, the stub frontends' embeddings, MLA's compressed cache and
the MoE FFN (with DeepSeek's shared expert).  JAX stacks a stage's
parameters along a leading repeat dim and scans it; the port keeps one
dict per layer in execution order (``params["layers"]``, kinds from
``layer_kinds``; the encoder's in ``params["enc_layers"]``, kinds from
``enc_layer_kinds``), and ``params_from_jax`` unstacks JAX's stages
(``stages``, ``enc_stages``) into those lists.  Params are plain dicts
of tensors with JAX's names.  ``remat=True`` recomputes each layer in
the backward (``torch.utils.checkpoint``), as JAX's ``jax.checkpoint``
of each stage's scan body.

On a (data, model) mesh (``dist``, a ``sharding.DistContext``): ``specs``
(``layer_specs``, ``block_specs``) gives JAX's logical spec tree in the
port's unstacked layout (JAX's ``init`` specs with ``stack_specs``'
leading None taken off), ``init(..., dist=)`` each rank's blocks of the
seeded params (``shard_params``; a MoE layer's experts drawn in the whole
stack's order and only the rank's kept).  ``hidden``, ``forward`` and
``encode`` take ``dist``: the batch (whole on every rank, as JAX's jit
takes a global array) is split over the batch axes, attention and the
dense FFN run tensor-parallel, the MoE on its mesh path
(``moe.moe_apply``), the embedding vocab-parallel (each rank looks up the
ids in its vocab block, zeros the rest, and the ranks' rows are summed)
and the readout gives each rank its rows and its vocab block of the
logits, JAX's ``P(batch, None, "vocab")``.  The ``rec`` kind runs its
channel block (``rglru``), the ``dec`` kind its heads of the cross
attention; the ``ssd`` kind its columns of the in-projection, gathered
(``layers.ssm``).  Under ``make_dist(..., seq_parallel=True)`` the
residual stream between layers holds each rank's S rows (``hidden``,
``apply_layer``).
Decode on a mesh: ``cache_specs_only`` (JAX's cache specs, a dict a
layer), ``init_cache(..., dist=)`` each rank's cache blocks (heads over
'kv_heads', the sequence over 'kv_seq'), ``decode_step(..., dist=)``
(the layouts: ``layers.attention.gqa_decode``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import comm
from repro_torch.layers import attention as attn
from repro_torch.layers import common as cm
from repro_torch.layers import mlp as mlp_lib
from repro_torch.layers import moe as moe_lib
from repro_torch.layers import rglru as rglru_lib
from repro_torch.layers import ssm as ssm_lib
from repro_torch.train.tree import tree_paths

MLA_KINDS = ("mla", "mla_moe")
MOE_KINDS = ("moe", "mla_moe")
# a self-attention core (kernel F on the card) a layer: GQA or MLA; a
# ``dec`` layer adds a second, its cross attention
ATTN_KINDS = ("attn", "local", "global", "moe", "enc", "dec") + MLA_KINDS
KINDS = ATTN_KINDS + ("rec", "ssd")
FRONTENDS = ("none", "vlm_stub", "audio_stub")


def layer_kinds(cfg) -> list[str]:
    """The decoder's layer kinds in execution order (the stages
    unrolled)."""
    return _unrolled(cfg.stages)


def enc_layer_kinds(cfg) -> list[str]:
    """The encoder's layer kinds in execution order (none unless the
    config is an encoder-decoder)."""
    return _unrolled(cfg.encoder_stages) if cfg.is_encoder_decoder else []


def _unrolled(stages):
    return [kind for kinds, reps in stages for _ in range(reps)
            for kind in kinds]


def check_supported(cfg):
    kinds = layer_kinds(cfg) + enc_layer_kinds(cfg)
    missing = sorted(set(kinds) - set(KINDS))
    if cfg.frontend not in FRONTENDS:
        missing.append(f"frontend={cfg.frontend}")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not known (the port runs "
            f"layer kinds {KINDS} and frontends {FRONTENDS})")


def _check_kind(kind):
    if kind not in KINDS:
        raise NotImplementedError(f"layer kind {kind!r} is not known "
                                  f"(the port runs {KINDS})")


def _rms(p, x, cfg):
    """The layer norm on ``x`` (under sequence parallelism the rank's S
    rows: the gain's gradient summed over them, ``common.sp_param``)."""
    return cm.rmsnorm_apply(cm.sp_param(p), x, cfg.norm_eps,
                            gemma_style=cfg.gemma_norm)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_layer(gen: torch.Generator, kind: str, cfg, dtype=torch.bfloat16,
               experts=None):
    """One layer's params, JAX's ``init_layer`` tree: an ``ssd`` layer is
    mixer-only (no ``ln2``/FFN); a MoE kind has ``moe`` (and ``shared``, a
    GLU of width ``d_expert · n_shared``, where the config has shared
    experts) in place of ``mlp``; a ``dec`` layer adds ``lnx`` and
    ``cross``."""
    _check_kind(kind)
    dev = gen.device
    p = {"ln1": cm.rmsnorm_init(cfg.d_model, dev)}
    if kind == "ssd":
        p["ssd"] = ssm_lib.ssd_init(gen, cfg, dtype)
        if cfg.sandwich_norm:
            p["pn1"] = cm.rmsnorm_init(cfg.d_model, dev)
        return p
    if kind == "rec":
        p["rec"] = rglru_lib.rglru_init(gen, cfg, dtype)
    elif kind in MLA_KINDS:
        p["attn"] = attn.mla_init(gen, cfg, dtype)
    else:
        p["attn"] = attn.gqa_init(gen, cfg, dtype)
    if kind == "dec":
        p["lnx"] = cm.rmsnorm_init(cfg.d_model, dev)
        p["cross"] = attn.cross_init(gen, cfg, dtype)
    p["ln2"] = cm.rmsnorm_init(cfg.d_model, dev)
    if kind in MOE_KINDS:
        p["moe"] = moe_lib.moe_init(gen, cfg, dtype, keep=experts)
        if cfg.n_shared:
            p["shared"] = mlp_lib.glu_init(gen, cfg.d_model,
                                           cfg.d_expert * cfg.n_shared,
                                           dtype)
    else:
        p["mlp"] = mlp_lib.glu_init(gen, cfg.d_model, cfg.d_ff, dtype)
    if cfg.sandwich_norm:
        p["pn1"] = cm.rmsnorm_init(cfg.d_model, dev)
        p["pn2"] = cm.rmsnorm_init(cfg.d_model, dev)
    return p


def init(cfg, *, seed=0, device="cuda", dtype=torch.bfloat16, dist=None):
    """Random params from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (JAX's shapes and scales, not its numbers).  With ``dist``
    on a mesh: this rank's blocks of the same params (``specs``), each
    leaf cut as it is drawn."""
    check_supported(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    mesh = dist is not None and dist.mesh is not None

    def put(p, sp):
        if not mesh:
            return p
        # a block that is a view of the whole draw is copied out, so the
        # whole storage goes
        return _map(lambda t: t.clone() if t.untyped_storage().nbytes()
                    > t.numel() * t.element_size() else t,
                    dist.shard_params(p, sp))

    def layer(kind):
        keep, sp = None, layer_specs(kind, cfg)
        if mesh and kind in MOE_KINDS:
            i, n = dist.shard_of(dist.rules["expert"], cfg.n_experts)
            keep = (i * cfg.n_experts // n, (i + 1) * cfg.n_experts // n)
            for k in ("wi", "wg", "wo"):        # the rank's experts already
                sp["moe"][k] = cm.spec(None, *sp["moe"][k][1:])
        return put(init_layer(gen, kind, cfg, dtype, experts=keep), sp)

    params = {"embed": put(cm.embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                         dtype), cm.embed_specs())}
    params["layers"] = [layer(kind) for kind in layer_kinds(cfg)]
    if cfg.is_encoder_decoder:
        params["enc_layers"] = [layer(kind)
                                for kind in enc_layer_kinds(cfg)]
        params["enc_norm"] = cm.rmsnorm_init(cfg.d_model, gen.device)
    params["final_norm"] = cm.rmsnorm_init(cfg.d_model, gen.device)
    if not cfg.tie_embeddings:
        params["head"] = put(cm.dense_init(gen, cfg.d_model,
                                           cfg.padded_vocab, dtype),
                             cm.dense_specs(None, "vocab"))
    return params


def layer_specs(kind: str, cfg) -> dict:
    """JAX's ``init_layer`` specs for one layer."""
    _check_kind(kind)
    s = {"ln1": cm.rmsnorm_specs()}
    if kind == "ssd":
        s["ssd"] = ssm_lib.ssd_specs()
        if cfg.sandwich_norm:
            s["pn1"] = cm.rmsnorm_specs()
        return s
    if kind == "rec":
        s["rec"] = rglru_lib.rglru_specs()
    elif kind in MLA_KINDS:
        s["attn"] = attn.mla_specs(cfg)
    else:
        s["attn"] = attn.gqa_specs(cfg)
    if kind == "dec":
        s["lnx"] = cm.rmsnorm_specs()
        s["cross"] = attn.cross_specs(cfg)
    s["ln2"] = cm.rmsnorm_specs()
    if kind in MOE_KINDS:
        s["moe"] = moe_lib.moe_specs()
        if cfg.n_shared:
            s["shared"] = mlp_lib.glu_specs()
    else:
        s["mlp"] = mlp_lib.glu_specs()
    if cfg.sandwich_norm:
        s["pn1"] = cm.rmsnorm_specs()
        s["pn2"] = cm.rmsnorm_specs()
    return s


def block_specs(kinds, cfg) -> dict:
    """Specs for one block (JAX's ``block_specs``, no leading dim)."""
    return {f"l{i}": layer_specs(kind, cfg) for i, kind in enumerate(kinds)}


def specs(cfg) -> dict:
    """The logical spec tree of ``init``'s params, layer by layer."""
    check_supported(cfg)
    s = {"embed": cm.embed_specs(),
         "layers": [layer_specs(k, cfg) for k in layer_kinds(cfg)]}
    if cfg.is_encoder_decoder:
        s["enc_layers"] = [layer_specs(k, cfg) for k in enc_layer_kinds(cfg)]
        s["enc_norm"] = cm.rmsnorm_specs()
    s["final_norm"] = cm.rmsnorm_specs()
    if not cfg.tie_embeddings:
        s["head"] = cm.dense_specs(None, "vocab")
    return s


@functools.lru_cache(maxsize=16)
def param_shapes(cfg):
    """``init``'s whole params as meta tensors (shapes and dtypes, no
    storage): what the optimisers and ``launch.steps.train_state_specs``
    read as the leaves' whole shapes on a mesh."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        fake = init(cfg, device="cpu")
    return _map_tree(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                           device="meta"), fake)


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tree(fn, v) for v in tree]
    return fn(tree)


def param_stacks(cfg, params) -> list[list[str]]:
    """The leaf paths (``train.tree.tree_paths`` of ``params``) that JAX
    stacks into one leaf: for each stage and each layer of its block, the
    same leaf of every repeat, in repeat order (``stages`` into
    ``layers``, ``enc_stages`` into ``enc_layers``).  What the optimisers
    read as JAX's stacked shapes."""
    out = []
    for key, stages in (("layers", cfg.stages),
                        ("enc_layers", cfg.encoder_stages
                         if cfg.is_encoder_decoder else ())):
        base = 0
        for kinds, reps in stages:
            for i in range(len(kinds)):
                rows = [base + r * len(kinds) + i for r in range(reps)]
                subs = [k for k, _ in tree_paths(params[key][rows[0]])]
                out += [[f"{key}/{j}/{sub}" for j in rows] for sub in subs]
            base += len(kinds) * reps
    return out


def _tensor(arr, device):
    """A numpy array (JAX's bf16 as ``ml_dtypes.bfloat16``) as a tensor on
    ``device``, bit for bit: bf16 goes across as its uint16 bits."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16)
                             .copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr).copy())
    return t.to(device)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _unstacked(stage_defs, stages, device):
    layers = []
    for (kinds, reps), stage in zip(stage_defs, stages):
        for r in range(reps):
            for i in range(len(kinds)):
                layers.append(_map(lambda a, r=r: _tensor(np.asarray(a)[r],
                                                          device),
                                   stage[f"l{i}"]))
    return layers


def params_from_jax(np_params, cfg, device="cuda"):
    """JAX's params (``jax.tree.map(np.asarray, params)``) as the port's:
    each stage's stacked blocks unstacked into ``params["layers"]`` (the
    encoder's ``enc_stages`` into ``params["enc_layers"]``)."""
    check_supported(cfg)
    out = {"embed": _map(lambda a: _tensor(a, device), np_params["embed"])}
    out["layers"] = _unstacked(cfg.stages, np_params["stages"], device)
    if cfg.is_encoder_decoder:
        out["enc_layers"] = _unstacked(cfg.encoder_stages,
                                       np_params["enc_stages"], device)
    for name in ("enc_norm", "final_norm", "head"):
        if name in np_params:
            out[name] = _map(lambda a: _tensor(a, device), np_params[name])
    return out


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _sandwich(p, key, h, cfg):
    """The sandwich norm ``key`` (``pn1`` after the mixer, ``pn2`` after
    the FFN) where the config has them."""
    return _rms(p[key], h, cfg) if cfg.sandwich_norm else h


def _whole_seq(fn, h, sp):
    """``fn(h)`` where the block needs the whole sequence and does not take
    part in sequence parallelism itself (the MoE, MLA, SSD): under ``sp``
    the rank's S rows are gathered, ``fn`` runs as without it (its own
    collectives make its input's gradient whole on every rank, so the
    gather's backward keeps the rank's rows) and the rank keeps its rows
    of the output."""
    if sp is None:
        return fn(h)
    with cm.seq_parallel(None):
        y = fn(comm.gather_from(h, sp, dim=1, kind="sp_gather"))
    return comm.split_to(y, sp, dim=1, kind="sp_split")


def apply_layer(p, x, kind, cfg, *, positions, memory=None, kv_chunk=1024,
                dist=None, sp=None):
    """One layer on the residual stream ``x``; ``sp``: the group its S is
    split over (sequence parallelism, ``x`` the rank's rows: the norms and
    residual adds on them, each block gathering S on entry and keeping
    its rows of the output, ``common.seq_parallel``)."""
    _check_kind(kind)
    with cm.seq_parallel(sp):
        h = _rms(p["ln1"], x, cfg)
        if kind == "ssd":
            h = _whole_seq(lambda t: ssm_lib.ssd_apply(p["ssd"], t, cfg,
                                                       dist), h, sp)
            return x + _sandwich(p, "pn1", h, cfg)
        if kind == "rec":
            h = rglru_lib.rglru_apply(p["rec"], h, cfg, dist)
        elif kind in MLA_KINDS:
            h = _whole_seq(lambda t: attn.mla_apply(
                p["attn"], t, cfg, positions=positions, kv_chunk=kv_chunk,
                dist=dist), h, sp)
        else:
            h = attn.gqa_apply(p["attn"], h, cfg, positions=positions,
                               layer_kind=_attn_kind(kind),
                               kv_chunk=kv_chunk, causal=kind != "enc",
                               dist=dist)
        x = x + _sandwich(p, "pn1", h, cfg)
        if kind == "dec":
            x = x + attn.cross_apply(p["cross"], _rms(p["lnx"], x, cfg),
                                     memory, cfg, kv_chunk=kv_chunk,
                                     dist=dist)
        h = _rms(p["ln2"], x, cfg)
        if kind in MOE_KINDS:
            h = _whole_seq(lambda t: _ffn(p, t, kind, cfg, moe_lib.moe_apply,
                                          dist), h, sp)
        else:
            h = _ffn(p, h, kind, cfg, moe_lib.moe_apply, dist)
        return x + _sandwich(p, "pn2", h, cfg)


def _ffn(p, h, kind, cfg, moe_fn, dist=None):
    """The FFN sublayer on the normed ``h``: the dense GLU, or the MoE
    (``moe_fn``: the prefill's or the decode's form) plus the shared
    expert."""
    if kind not in MOE_KINDS:
        return mlp_lib.glu_apply(p["mlp"], h, cfg.act, dist, cfg.d_ff)
    y = moe_fn(p["moe"], h, cfg) if dist is None else \
        moe_fn(p["moe"], h, cfg, dist)
    if cfg.n_shared:
        y = y + mlp_lib.glu_apply(p["shared"], h, cfg.act, dist,
                                  cfg.d_expert * cfg.n_shared)
    return y


def _attn_kind(kind):
    return "local" if kind == "local" else "global"


def _positions_for(cfg, b, s, device):
    pos = torch.arange(s, device=device)[None].expand(b, s)
    return pos[None].expand(3, b, s) if cfg.mrope_sections else pos


def _embed_scale(x, cfg):
    """The gemma norm's sqrt(d_model) embedding scale: an f32 product, one
    rounding to ``x``'s dtype."""
    if cfg.gemma_norm:
        return (x.float() * cfg.d_model ** 0.5).to(x.dtype)
    return x


def _embed_lookup(p, ids, cfg, dist=None, sp=None):
    """The embedding rows of ``ids``; vocab-parallel where ``dist``
    splits 'vocab': the rank's rows of the ids in its block, zeros
    elsewhere, summed over the group (in f32: one nonzero term a row,
    exact).  ``sp``: the rank's S rows only (over the vocab's own group
    the sum is a reduce-scatter over S)."""
    group, i, n = cm.tp(dist, "vocab", cfg.padded_vocab)
    if group is None:
        return _split_seq(cm.embed_apply(p, ids), sp)
    v = cfg.padded_vocab // n
    local = ids - i * v
    hit = (local >= 0) & (local < v)
    x = p["w"][local.clamp(0, v - 1)].float().masked_fill(~hit[..., None],
                                                          0.0)
    if sp is group:
        return comm.reduce_scatter_to(x, group, dim=1,
                                      kind="vocab_reduce_scatter") \
            .to(p["w"].dtype)
    return _split_seq(comm.reduce_from(x, group, kind="vocab_all_reduce")
                      .to(p["w"].dtype), sp)


def _split_seq(x, sp):
    """The rank's S rows of ``x`` (B, S, ...) under sequence parallelism
    over ``sp`` (``x`` itself for None)."""
    return x if sp is None else comm.split_to(x, sp, dim=1,
                                              kind="sp_split")


def _seq_group(dist, s: int):
    """The group the residual stream's S rows split over: the 'seq' rule's
    axes (``make_dist(..., seq_parallel=True)``: 'model'); None off a
    mesh, without the rule, or where its extent does not divide ``s``
    (decode, S = 1: ``shard_params``' best-effort rule)."""
    if dist is None or dist.mesh is None or dist.rules.get("seq") is None:
        return None
    return cm.tp(dist, "seq", s)[0]


def _embed_in(params, batch, cfg, dist=None, sp=None):
    if cfg.frontend != "none" and "embeds" in batch:
        x = _split_seq(batch["embeds"], sp)
    else:
        x = _embed_lookup(params["embed"], batch["inputs"], cfg, dist, sp)
    return _embed_scale(x, cfg)


def local_batch(batch, dist):
    """This rank's rows of every entry of ``batch`` (whole on every rank)
    over the batch axes; ``batch`` itself off a mesh."""
    if dist is None or dist.mesh is None:
        return batch
    _, n = dist.batch_ranks()
    out = {}
    for k, v in batch.items():
        if n > 1 and v.shape[0] % n:
            raise ValueError(f"batch {k} of {v.shape[0]} rows over {n} "
                             f"ranks (make_dist replicates such a batch)")
        out[k] = dist.split_batch(v)[0]
    return out


def _run_layers(layers, kinds, x, cfg, *, positions, memory=None,
                kv_chunk=1024, remat=False, dist=None, sp=None):
    """The layers in order over ``x``; with ``remat`` (and grad on) each
    layer under ``torch.utils.checkpoint`` (non-reentrant): its
    activations are recomputed in the backward, not kept."""
    remat = remat and torch.is_grad_enabled()
    for p, kind in zip(layers, kinds):
        def layer(x, p=p, kind=kind):
            return apply_layer(p, x, kind, cfg, positions=positions,
                               memory=memory, kv_chunk=kv_chunk, dist=dist,
                               sp=sp)
        x = checkpoint(layer, x, use_reentrant=False) if remat else layer(x)
    return x


def encode(params, src_embeds, cfg, *, kv_chunk=1024, remat=True,
           dist=None):
    """The encoder over the stub frontend's source frames ``src_embeds``
    (B, S_src, D), cast to the params' dtype: the ``enc`` layers
    (non-causal self-attention) and ``enc_norm``.  Returns the memory the
    ``dec`` layers attend to, (B, S_src, D) (this rank's rows on a
    mesh, whose batch split ``hidden`` made; under sequence parallelism
    the encoder's stream is split on its S too, and gathered whole before
    ``enc_norm``)."""
    b, s = src_embeds.shape[0], src_embeds.shape[1]
    sp = _seq_group(dist, s)
    x = _embed_scale(_split_seq(src_embeds.to(params["embed"]["w"].dtype),
                                sp), cfg)
    positions = _positions_for(cfg, b, s, x.device)
    x = _run_layers(params["enc_layers"], enc_layer_kinds(cfg), x, cfg,
                    positions=positions, kv_chunk=kv_chunk, remat=remat,
                    dist=dist, sp=sp)
    if sp is not None:
        x = comm.gather_from(x, sp, dim=1, kind="sp_gather")
    return cm.rmsnorm_apply(params["enc_norm"], x, cfg.norm_eps)


def hidden(params, batch, cfg, dist=None, *, kv_chunk=1024, remat=True):
    """The residual stream after the last layer, before the final norm:
    (B, S, D) in the params' dtype.  ``batch["embeds"]`` (B, S, D), where
    the frontend is a stub and the batch has them, takes the place of the
    token embeddings; an encoder-decoder encodes ``batch["src_embeds"]``
    first.  On a mesh (``dist``) the batch is whole on every rank and the
    result is this rank's rows.  Under sequence parallelism (the 'seq'
    rule) the stream between layers holds the rank's S / extent rows
    (``apply_layer``) and is gathered whole at the end."""
    check_supported(cfg)
    batch = local_batch(batch, dist)
    s = batch["inputs"].shape[1] if "inputs" in batch \
        else batch["embeds"].shape[1]
    sp = _seq_group(dist, s)
    x = _embed_in(params, batch, cfg, dist, sp)
    positions = _positions_for(cfg, x.shape[0], s, x.device)
    memory = None
    if cfg.is_encoder_decoder:
        memory = encode(params, batch["src_embeds"], cfg, kv_chunk=kv_chunk,
                        remat=remat, dist=dist)
    x = _run_layers(params["layers"], layer_kinds(cfg), x, cfg,
                    positions=positions, memory=memory, kv_chunk=kv_chunk,
                    remat=remat, dist=dist, sp=sp)
    if sp is not None:
        x = comm.gather_from(x, sp, dim=1, kind="sp_gather")
    return x


def forward(params, batch, cfg, dist=None, *, kv_chunk=1024, remat=True):
    """Teacher-forced logits: (B, S, V) float32; on a mesh this rank's
    rows and vocab block (``gather_logits`` makes them whole)."""
    x = hidden(params, batch, cfg, dist, kv_chunk=kv_chunk, remat=remat)
    x = cm.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps,
                         gemma_style=cfg.gemma_norm)
    return _readout(params, x, cfg, dist)


def gather_logits(logits, cfg, dist):
    """A rank's block of the logits (rows over the batch axes, vocab over
    'vocab') gathered whole on every rank."""
    if dist is None or dist.mesh is None:
        return logits
    group, _, _ = cm.tp(dist, "vocab", cfg.padded_vocab)
    logits = comm.gather_from(logits, group, dim=-1, kind="logits_gather")
    axes, _ = dist.batch_ranks()
    return comm.gather_from(logits, dist.group(axes), dim=0,
                            kind="logits_gather")


def loss_fn(params, batch, cfg, dist=None, *, kv_chunk=1024, remat=True):
    """The mean next-token cross entropy over the positions whose target
    is ``>= 0``: ``logsumexp(logits) - logits[target]`` in f32.  On a mesh
    (``dist``; the batch whole on every rank) the mean over the global
    batch, the same on every rank: the rank's rows and vocab block of the
    logits go through ``VocabParallelCE``, the masked sum and the count
    are each summed over the batch axes before the divide (not a mean of
    the ranks' means: with ragged ``targets < 0`` those differ).  Its
    gradient on each rank is that rank's rows' share: the train step sums
    it over the batch axes."""
    logits = forward(params, batch, cfg, dist, kv_chunk=kv_chunk,
                     remat=remat)
    if dist is not None and dist.mesh is not None:
        tgt = local_batch({"targets": batch["targets"]}, dist)["targets"]
        group, i, n = cm.tp(dist, "vocab", cfg.padded_vocab)
        tgt = tgt.long()
        nll = VocabParallelCE.apply(logits, tgt - i * (cfg.padded_vocab // n),
                                    group)
        mask = (tgt >= 0).float()
        axes, _ = dist.batch_ranks()
        bgroup = dist.group(axes) if axes is not None else None
        num = comm.reduce_from((nll * mask).sum(), bgroup,
                               kind="loss_all_reduce")
        count = comm.all_reduce(mask.sum(), bgroup, kind="loss_all_reduce")
        return num / torch.clamp_min(count, 1.0)
    tgt = batch["targets"].long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, tgt.clamp_min(0)[..., None])[..., 0]
    mask = (tgt >= 0).float()
    return ((lse - gold) * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


class VocabParallelCE(torch.autograd.Function):
    """Cross entropy over logits split on the vocab: ``logits`` (..., V_l)
    f32, this rank's block of the columns; ``local`` the targets minus
    the block's first column (in the block where ``0 <= local < V_l``).
    Forward: the row max and the sum of ``exp`` all-reduced over
    ``group`` (max, then sum), the gold logit from the rank whose block
    holds the target (summed: one nonzero term), ``log-sum-exp - gold``
    per position, (...,) f32.  The padded columns, -1e30, add exp(-1e30 -
    max) = 0.  Backward: ``(softmax - one-hot) * g`` on the block, no
    collective (the cotangent is the same on every rank of the group).
    Saves the logits and the log-sum-exp, not the (..., V_l) softmax."""

    @staticmethod
    def forward(ctx, logits, local, group):
        v = logits.shape[-1]
        hit = (local >= 0) & (local < v)
        m = comm.all_reduce(logits.amax(-1), group, kind="lse_max",
                            op="max")
        se = torch.exp(logits - m[..., None]).sum(-1)
        se = comm.all_reduce(se, group, kind="lse_all_reduce")
        lse = m + torch.log(se)
        gold = torch.gather(logits, -1, local.clamp(0, v - 1)[..., None])
        gold = torch.where(hit, gold[..., 0], 0.0)
        gold = comm.all_reduce(gold, group, kind="gold_all_reduce")
        ctx.save_for_backward(logits, lse, local, hit)
        return lse - gold

    @staticmethod
    def backward(ctx, g):
        logits, lse, local, hit = ctx.saved_tensors
        v = logits.shape[-1]
        grad = torch.exp(logits - lse[..., None]) * g[..., None]
        grad.scatter_add_(-1, local.clamp(0, v - 1)[..., None],
                          torch.where(hit, -g, 0.0)[..., None])
        return grad, None, None


def _readout(params, x, cfg, dist=None):
    """LM head over the padded vocab; padding columns masked to -1e30.  On
    a mesh that splits 'vocab', the rank's block of the columns."""
    group, i, n = cm.tp(dist, "vocab", cfg.padded_vocab)
    x = comm.copy_to(x, group)
    if cfg.tie_embeddings:
        logits = cm.embed_logits(params["embed"], x)
    else:
        logits = cm.dense_apply(params["head"], x).float()
    if cfg.padded_vocab != cfg.vocab_size:
        col = torch.arange(logits.shape[-1], device=logits.device) \
            + i * (cfg.padded_vocab // n)
        logits = logits.masked_fill(col >= cfg.vocab_size, -1e30)
    return logits


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def cache_layer_specs(kind, cfg) -> dict:
    """JAX's ``init_cache_layer`` specs for one layer's cache: k/v
    ``("batch", "kv_seq", "kv_heads", None)``, MLA's ``ckv``/``kr``
    ``("batch", "kv_seq", None)``, the recurrent states on "heads"."""
    _check_kind(kind)
    if kind == "ssd":
        return {"h": cm.spec("batch", "heads", None, None),
                "conv": cm.spec("batch", None, "heads")}
    if kind == "rec":
        return {"h": cm.spec("batch", "heads"),
                "conv": cm.spec("batch", None, "heads")}
    if kind in MLA_KINDS:
        return {"ckv": cm.spec("batch", "kv_seq", None),
                "kr": cm.spec("batch", "kv_seq", None)}
    kv = cm.spec("batch", "kv_seq", "kv_heads", None)
    return {"k": kv, "v": kv}


def cache_specs_only(cfg) -> list:
    """The decode cache's logical specs, one dict a layer in execution
    order (JAX's ``cache_specs_only`` unstacked, as ``specs`` is); no
    tensor is made."""
    check_supported(cfg)
    return [cache_layer_specs(kind, cfg) for kind in layer_kinds(cfg)]


def _cache_shapes(kind, cfg, batch, max_len, dtype):
    """{leaf: (whole shape, dtype)} of one layer's cache."""
    if kind == "ssd":
        di, h, n = cfg.d_inner, cfg.ssm_heads, cfg.ssm_state
        return {"h": ((batch, h, n, di // h), torch.float32),
                "conv": ((batch, cfg.ssm_conv - 1,
                          di + 2 * cfg.ssm_groups * n), dtype)}
    if kind == "rec":
        return {"h": ((batch, cfg.lru_width), torch.float32),
                "conv": ((batch, cfg.conv_width - 1, cfg.lru_width), dtype)}
    if kind in MLA_KINDS:
        return {"ckv": ((batch, max_len, cfg.kv_lora_rank), dtype),
                "kr": ((batch, max_len, cfg.qk_rope_dim), dtype)}
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": (shape, dtype), "v": (shape, dtype)}


def init_cache_layer(kind, cfg, batch, max_len, dtype=torch.bfloat16,
                     device="cuda", dist=None):
    """JAX's cache for one layer: {"k", "v"} (B, max_len, Kh, Dh) for GQA
    attention; MLA's compressed {"ckv": (B, max_len, kv_lora_rank), "kr":
    (B, max_len, qk_rope_dim)}; the recurrent state {"h" f32, "conv" (B,
    K-1, width)} for ``rec`` and ``ssd``.  With ``dist`` on a mesh: this
    rank's block of each leaf under ``cache_layer_specs``, as
    ``NamedSharding`` lays it out (``DistContext.block_shape``)."""
    _check_kind(kind)
    specs = cache_layer_specs(kind, cfg)
    out = {}
    for name, (shape, dt) in _cache_shapes(kind, cfg, batch, max_len,
                                           dtype).items():
        if dist is not None:
            shape = dist.block_shape(shape, specs[name])
        out[name] = torch.zeros(shape, dtype=dt, device=device)
    return out


def init_cache(cfg, batch, max_len, dtype=torch.bfloat16, device="cuda",
               dist=None):
    """One cache per layer, in execution order (bf16 by default, as JAX's;
    the recurrent states ``h`` in f32).  With ``dist`` on a mesh: each
    rank's blocks (``init_cache_layer``); ``max_len`` must divide over the
    'kv_seq' axes, so a block's length says where it starts."""
    check_supported(cfg)
    if dist is not None and dist.mesh is None:
        dist = None
    if dist is not None:
        n = dist.extent(dist.resolve(("kv_seq",))[0])
        if max_len % n:
            raise ValueError(f"a cache of {max_len} positions over the "
                             f"'kv_seq' axes' {n} ranks")
    return [init_cache_layer(kind, cfg, batch, max_len, dtype, device, dist)
            for kind in layer_kinds(cfg)]


def decode_layer(p, x, kind, cfg, cache, idx, memory=None, dist=None):
    """One layer of ``decode_step``; ``dist`` on a mesh: ``x``, ``cache``
    and ``memory`` are this rank's rows (and the cache its blocks), the
    attention, RG-LRU, cross attention and FFN tensor-parallel, the MoE on
    its mesh path (``moe_apply``, as JAX's ``decode_layer``)."""
    _check_kind(kind)
    h = _rms(p["ln1"], x, cfg)
    if kind == "ssd":
        h, nc = ssm_lib.ssd_decode(p["ssd"], h, cache, cfg, dist)
        return x + _sandwich(p, "pn1", h, cfg), nc
    if kind == "rec":
        h, nc = rglru_lib.rglru_decode(p["rec"], h, cache, cfg, dist)
    elif kind in MLA_KINDS:
        h, nc = attn.mla_decode(p["attn"], h, cache, idx, cfg, dist)
    else:
        h, nc = attn.gqa_decode(p["attn"], h, cache, idx, cfg,
                                layer_kind=_attn_kind(kind), dist=dist)
    x = x + _sandwich(p, "pn1", h, cfg)
    if kind == "dec":
        x = x + attn.cross_apply(p["cross"], _rms(p["lnx"], x, cfg), memory,
                                 cfg, dist=dist)
    moe_fn = moe_lib.moe_decode if dist is None else moe_lib.moe_apply
    h = _ffn(p, _rms(p["ln2"], x, cfg), kind, cfg, moe_fn, dist)
    return x + _sandwich(p, "pn2", h, cfg), nc


def decode_step(params, cache, tokens, idx, cfg, memory=None, dist=None):
    """One decode step.  tokens: (B, 1) int, or (B, 1, D) embeddings for
    a stub frontend; ``idx`` a Python int or a 0-d int64 tensor on the
    tokens' device (a captured graph's position); ``memory`` (B, S_src, D)
    the encoder's output for an encoder-decoder, whose ``dec`` layers
    attend to it anew every step (no cross K/V cache, as JAX).  Returns
    (logits (B, 1, V), cache), the cache written in place: the KV (or
    MLA's compressed) rows at ``idx``, the recurrent states whole.  The
    MoE kinds run ``moe_decode``, whose static shapes a CUDA graph
    captures.

    On a (data, model) mesh (``dist``; ``params`` and ``cache`` each
    rank's blocks, from ``init``/``init_cache`` with ``dist``): ``tokens``
    and ``memory`` are whole on every rank, as JAX's jit takes global
    arrays, and each rank takes its rows (``local_batch``); the layers run
    as ``decode_layer`` says and the logits come back whole on every rank
    (``gather_logits``)."""
    check_supported(cfg)
    if dist is not None and dist.mesh is None:
        dist = None
    rows = local_batch({"tokens": tokens, **({} if memory is None else
                                             {"memory": memory})}, dist)
    tokens, memory = rows["tokens"], rows.get("memory")
    if cfg.frontend != "none" and tokens.dim() == 3:
        x = tokens
    else:
        x = _embed_lookup(params["embed"], tokens, cfg, dist)
    x = _embed_scale(x, cfg)
    idx = torch.as_tensor(idx, dtype=torch.int64, device=x.device)
    new_cache = []
    for p, c, kind in zip(params["layers"], cache, layer_kinds(cfg)):
        x, nc = decode_layer(p, x, kind, cfg, c, idx, memory, dist)
        new_cache.append(nc)
    x = cm.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps,
                         gemma_style=cfg.gemma_norm)
    return gather_logits(_readout(params, x, cfg, dist), cfg, dist), \
        new_cache
