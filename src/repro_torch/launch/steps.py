"""The train, prefill and greedy serve steps, and the mesh's rules.

Counterpart of ``repro.launch.steps``' ``make_dist``, ``dp_total``,
``make_train_step``, ``train_state_specs``, ``make_prefill_step``,
``make_serve_step``, ``opt_config_for`` and ``default_grad_accum``, for
every layer kind the port runs.  ``make_train_step``,
``make_prefill_step`` and ``make_serve_step`` run on a (data, model) mesh
(``dist``: explicit SPMD, every rank the same code on its blocks, the
batch whole on every rank); ``make_dist``'s decode rules place the cache
(heads over 'model', or the sequence over 'model' or 'data':
context-parallel decode)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.layers import common as cm
from repro_torch.models import transformer as tfm
from repro_torch.core import comm
from repro_torch.sharding import DEFAULT_RULES, DistContext, Spec, _axes
from repro_torch.train import optim as opt_lib
from repro_torch.train.tree import tree_leaves, tree_unflatten

# elements a gradient bucket all-reduces at a time (256 MB of f32)
BUCKET = 1 << 26


def _mesh_sizes(mesh) -> dict[str, int]:
    """{axis: extent} of a ``DeviceMesh`` or of a duck-typed mesh with
    JAX's ``axis_names`` and ``shape`` mapping."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def make_dist(mesh, cfg, shape, *, seq_parallel: bool = False,
              parallelism: str = "auto") -> DistContext:
    """JAX's rules per (mesh, shape): the batch over ('pod', 'data'),
    replicated where it does not divide (the long KV-cache sequence then
    over 'data'); TP on 'model' (heads, ffn, vocab, experts); the decode
    cache's sequence over 'model' where its heads cannot split; mamba2 with
    no TP; the huge MoEs' experts over data·model where they divide, else
    dbrx's expert hidden dim over 'data'.  ``seq_parallel``: the residual
    stream's S over 'model' between layers (``rules['seq']``).
    ``parallelism='dp_only'``: the batch over every mesh axis and no TP
    (TP's rules where the batch does not cover the mesh)."""
    rules = dict(DEFAULT_RULES)
    sizes = _mesh_sizes(mesh)
    if parallelism == "dp_only":
        batch_axes = tuple(a for a in ("pod", "data", "model") if a in sizes)
        dp = 1
        for a in batch_axes:
            dp *= sizes[a]
        if shape.global_batch % max(dp, 1) != 0 or shape.global_batch < dp:
            return make_dist(mesh, cfg, shape, seq_parallel=seq_parallel,
                             parallelism="auto")
        rules.update(heads=None, ffn=None, vocab=None, kv_heads=None,
                     batch=batch_axes)
        return DistContext(mesh=mesh, rules=rules)
    batch_axes = tuple(a for a in ("pod", "data") if a in sizes)
    dp = 1
    for a in batch_axes:
        dp *= sizes[a]
    if shape.global_batch % max(dp, 1) != 0 or shape.global_batch < dp:
        rules["batch"] = None
        rules["kv_seq"] = "data"
    else:
        rules["batch"] = batch_axes if len(batch_axes) > 1 else batch_axes[0]
    if shape.kind == "decode" and shape.seq_len >= 2 ** 18:
        rules["kv_seq"] = "data"
    if shape.kind == "decode" and (cfg.num_kv_heads % sizes["model"]
                                   or cfg.use_mla):
        rules["kv_heads"] = None
        if rules["kv_seq"] is None:
            rules["kv_seq"] = "model"
    if seq_parallel:
        rules["seq"] = "model"
    if cfg.family == "ssm":
        rules["heads"] = None
        rules["ffn"] = None
    if cfg.n_experts and cfg.n_experts % (dp_total(mesh)
                                          * sizes["model"]) == 0:
        rules["expert"] = tuple(a for a in ("data", "model") if a in sizes)
    elif cfg.n_experts and cfg.d_expert % 128 == 0 and \
            (cfg.n_experts * cfg.d_expert * cfg.d_model * 3
             * cfg.num_layers * 2) > 64e9:      # total expert bytes (bf16)
        rules["expert_ffn"] = "data"
    return DistContext(mesh=mesh, rules=rules)


def dp_total(mesh) -> int:
    """The extent of the 'data' axis (1 where the mesh has none)."""
    return _mesh_sizes(mesh).get("data", 1)


def opt_config_for(cfg) -> opt_lib.OptConfig:
    """Adafactor for the huge MoE configs (Adam's state would not fit),
    AdamW otherwise."""
    if cfg.name in ("deepseek-v3-671b", "dbrx-132b"):
        return opt_lib.OptConfig(name="adafactor", lr=1e-4)
    return opt_lib.OptConfig(name="adamw", lr=3e-4)


def default_grad_accum(cfg, shape) -> int:
    """JAX's microbatch count by model width for a train shape (1
    otherwise)."""
    if shape.kind != "train":
        return 1
    if cfg.d_model >= 4000:
        return 8
    if cfg.d_model >= 3000:
        return 4
    return 2


def batch_to(batch, device) -> dict:
    """A batch of numpy arrays (or tensors) as tensors on ``device``:
    token ids as int64, embeddings as they are."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v) else v
        if not t.is_floating_point():
            t = t.long()
        out[k] = t.to(device)
    return out


def _batch_axes(dist) -> tuple:
    axes, _ = dist.batch_ranks()
    return () if axes is None else _axes(axes)


def _leaf_specs(cfg, dist) -> list:
    """Every param leaf's resolved spec, in ``tree_leaves`` order."""
    return [dist.resolve(sp) for sp in opt_lib.spec_leaves(tfm.specs(cfg))]


def sum_over_batch(leaves, specs, dist, kind="grad_all_reduce") -> list:
    """Each gradient summed over the batch axes its spec does not name
    (a leaf split over 'data', as experts over ('data', 'model'), holds
    its whole gradient already), in buckets of one dtype and at most
    ``BUCKET`` elements a collective.  The sum runs in the gradients' own
    dtype, as JAX's all-reduce of a bf16 gradient does: over two data
    ranks that is one rounding, the f32 sum's."""
    baxes = _batch_axes(dist)
    buckets: dict = {}
    for i, (t, sp) in enumerate(zip(leaves, specs)):
        used = {a for e in sp for a in _axes(e)}
        red = tuple(a for a in baxes if a not in used)
        if red:
            buckets.setdefault((red, str(t.dtype)), []).append(i)
    out = list(leaves)
    for red, dt in sorted(buckets):
        group = dist.group(red)
        run: list = []

        def flush(run):
            if not run:
                return
            flat = torch.cat([leaves[i].reshape(-1) for i in run])
            flat = comm.all_reduce(flat, group, kind=kind)
            o = 0
            for i in run:
                n = leaves[i].numel()
                out[i] = flat[o:o + n].view(leaves[i].shape)
                o += n
        size = 0
        for i in buckets[(red, dt)]:
            if run and size + leaves[i].numel() > BUCKET:
                flush(run)
                run, size = [], 0
            run.append(i)
            size += leaves[i].numel()
        flush(run)
    return out


def loss_and_grads(cfg, params, batch, *, kv_chunk=1024, remat=True,
                   dist=None, reduce=True):
    """(``loss_fn``'s value, the gradient of every param in the params'
    tree and dtype), as ``jax.value_and_grad`` gives them: a leaf the loss
    does not reach gets zeros.  On a mesh (``dist``: ``params`` each
    rank's blocks, ``batch`` whole on every rank) the loss is the global
    batch's mean on every rank and each rank's gradient its rows' share
    (the loss divides by the global count), summed over the batch axes
    (``sum_over_batch``; ``reduce=False`` leaves them unsummed)."""
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    p = tree_unflatten(params, leaves)
    with torch.enable_grad():
        loss = tfm.loss_fn(p, batch, cfg, dist, kv_chunk=kv_chunk,
                           remat=remat)
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    gs = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, gs)]
    if dist is not None and dist.mesh is not None and reduce:
        gs = sum_over_batch(gs, _leaf_specs(cfg, dist), dist)
    return loss.detach(), tree_unflatten(params, gs)


def _zero2_parts(gs, groups, specs, dist):
    """One microbatch's f32 gradients (unsummed) -> the accumulator's
    leaves: a group with a ZeRO-2 dim reduce-scattered over 'data' on it
    (each leaf's share, ``optim.part_of``'s layout) and summed over the
    other batch axes its spec leaves out; the rest as they are (summed
    once, after the last microbatch)."""
    gs = list(gs)
    done = set()
    for g in groups:
        if g.gzero is None:
            continue
        stacked = (torch.stack([gs[i] for i in g.idx]) if g.stacked
                   else gs[g.idx[0]])
        part = comm.reduce_scatter(stacked, dist.group("data"), g.gzero,
                                   kind="grad_reduce_scatter")
        used = {a for e in specs[g.idx[0]] for a in _axes(e)}
        rest = tuple(a for a in _batch_axes(dist)
                     if a != "data" and a not in used)
        part = comm.all_reduce(part, dist.group(rest),
                               kind="grad_all_reduce")
        shares = opt_lib.unstack_part(part, g, dist, g.gzero, part)
        for k, i in enumerate(g.idx):
            gs[i] = shares[k]
            done.add(i)
    return gs, done


def make_train_step(cfg, opt_cfg: opt_lib.OptConfig, grad_accum: int = 1,
                    kv_chunk: int = 1024, remat: bool = True, *, dist=None,
                    grad_shardings=None, accum_dtype=torch.float32):
    """``train_step(state, batch) -> (state, {"loss", "gnorm"})``:
    ``loss_and_grads`` (``grad_accum`` microbatches: the batch split along
    its rows, the gradients summed in ``accum_dtype``, f32 by default,
    and averaged, as JAX's scan does), then the optimiser of ``opt_cfg``
    over JAX's stacked shapes (``tfm.param_stacks``), under the profiler
    range "optimizer".
    ``state`` is {"params", "opt", "step"}; the returned state holds new
    tensors.

    On a mesh (``dist``; ``state`` each rank's blocks, from
    ``launch.train.build_state(..., dist=)``, the batch whole on every
    rank): microbatch i is the global rows ``[i·B/a, (i+1)·B/a)``, then
    split over the batch axes (JAX's resplit keeps the batch sharding on
    the microbatch dim); the summed gradients are summed over the batch
    axes once; the loss and gnorm are the same on every rank.
    ``grad_shardings`` (ZeRO-2, ``train_state_specs``' third tree: only
    whether it is given matters, its dims are ``optim.mesh_groups``'):
    each microbatch's gradients are reduce-scattered over 'data' into an
    ``accum_dtype`` accumulator kept at 1/data."""
    _, opt_update = opt_lib.OPTIMIZERS[opt_cfg.name]
    mesh = dist is not None and dist.mesh is not None
    zero2 = mesh and grad_shardings is not None
    if mesh:
        shapes, specs = tfm.param_shapes(cfg), tfm.specs(cfg)
        leaf_specs = _leaf_specs(cfg, dist)
    else:
        shapes = specs = None

    def micro(params, mb, groups):
        """One microbatch: (loss, the gradients as a list: unsummed over
        the batch axes on a mesh, ZeRO-2's groups reduce-scattered, the
        leaves they cover)."""
        loss, g = loss_and_grads(cfg, params, mb, kv_chunk=kv_chunk,
                                 remat=remat, dist=dist, reduce=False)
        gs = tree_leaves(g)
        if grad_accum > 1 or zero2:
            gs = [t.to(accum_dtype) for t in gs]
        if zero2:
            return (loss,) + _zero2_parts(gs, groups, leaf_specs, dist)
        return loss, gs, set()

    def train_step(state, batch):
        params = state["params"]
        dev = params["embed"]["w"].device
        batch = batch_to(batch, dev)
        stacks = tfm.param_stacks(cfg, params)
        groups = (opt_lib.mesh_groups(params, opt_cfg, stacks, specs, dist,
                                      shapes) if zero2 else None)
        n = next(iter(batch.values())).shape[0] // grad_accum
        loss, gs, done = micro(params, {k: v[:n] for k, v in batch.items()}
                               if grad_accum > 1 else batch, groups)
        for i in range(1, grad_accum):
            l_i, g_i, _ = micro(params, {k: v[i * n:(i + 1) * n]
                                         for k, v in batch.items()}, groups)
            loss = loss + l_i
            gs = [a + g for a, g in zip(gs, g_i)]
        if mesh:
            rest = [i for i in range(len(gs)) if i not in done]
            summed = sum_over_batch([gs[i] for i in rest],
                                    [leaf_specs[i] for i in rest], dist)
            for i, t in zip(rest, summed):
                gs[i] = t
        if grad_accum > 1:
            loss = loss / grad_accum
            gs = [g / grad_accum for g in gs]
        grads = tree_unflatten(params, gs)
        with torch.no_grad(), torch.profiler.record_function("optimizer"):
            mkw = (dict(specs=specs, dist=dist, shapes=shapes, sliced=zero2)
                   if mesh else {})
            new_params, new_opt, gnorm = opt_update(
                grads, state["opt"], params, opt_cfg, stacks=stacks, **mkw)
        return ({"params": new_params, "opt": new_opt,
                 "step": state["step"] + 1},
                {"loss": loss, "gnorm": gnorm})

    return train_step


def train_state_specs(cfg, dist, opt_cfg: opt_lib.OptConfig):
    """(state shapes, state placements, grad placements) without
    allocating: the state's whole shapes as meta tensors ({"params",
    "opt", "step"}), each leaf's ``sharding.Placement`` on ``dist`` (its
    ``spec`` JAX's resolved spec: a stacked group's leaves carry the
    group's stacked spec, with the stack dim's entry first) and the
    gradient accumulator's ZeRO-2 placements (``_zero1_spec`` of each
    param's resolved spec).  The opt state's shapes are the whole state's
    (a ZeRO-1 part gathered whole)."""
    p_shapes = tfm.param_shapes(cfg)
    specs = tfm.specs(cfg)
    stacks = tfm.param_stacks(cfg, p_shapes)
    opt_init, _ = opt_lib.OPTIMIZERS[opt_cfg.name]
    o_shapes = opt_init(p_shapes, opt_cfg, stacks=stacks)
    o_specs = opt_lib.state_specs(p_shapes, opt_cfg, stacks, specs, dist)
    groups = opt_lib.mesh_groups(p_shapes, opt_cfg, stacks, specs, dist,
                                 p_shapes)
    n = len(tree_leaves(p_shapes))
    p_pl, g_pl = [None] * n, [None] * n
    for g in groups:
        for k, i in enumerate(g.idx):
            p_pl[i] = dist.placement(g.spec, g.shape, k if g.stacked
                                     else None)
            gz = (g.spec if g.gzero is None else
                  opt_lib._zero1_spec(g.spec, g.shape, "data"))
            g_pl[i] = dist.placement(gz, g.shape, k if g.stacked else None)
    o_pl = _state_placements(o_shapes, o_specs, groups, dist, p_shapes)
    shapes = {"params": p_shapes, "opt": o_shapes,
              "step": torch.empty((), dtype=torch.int32, device="meta")}
    placements = {"params": tree_unflatten(p_shapes, p_pl), "opt": o_pl,
                  "step": dist.placement(Spec(), ())}
    return shapes, placements, tree_unflatten(p_shapes, g_pl)


def _state_placements(o_shapes, o_specs, groups, dist, p_shapes):
    """The optimiser state's placements: AdamW's m and v per leaf
    (``optim.part_of``'s layout where ZeRO-1 splits them), Adafactor's
    one state a group."""
    if "f" in o_shapes:
        f = {}
        for g in groups:
            f[g.name] = {k: dist.placement(o_specs["f"][g.name][k],
                                           tuple(o_shapes["f"][g.name][k]
                                                 .shape))
                         for k in o_shapes["f"][g.name]}
        return {"f": f, "step": dist.placement(Spec(), ())}
    n = len(tree_leaves(p_shapes))
    pl = [None] * n
    spec_l = opt_lib.spec_leaves(o_specs["m"])
    for g in groups:
        for k, i in enumerate(g.idx):
            pl[i] = dist.placement(spec_l[i], g.shape,
                                   k if g.stacked else None)
    tree = tree_unflatten(p_shapes, pl)
    return {"m": tree, "v": tree, "step": dist.placement(Spec(), ())}


def make_prefill_step(cfg, dist=None, kv_chunk: int = 1024):
    """``prefill_step(params, batch) -> (B, V)`` float32: the next-token
    logits of the last position (an encoder-decoder encodes
    ``batch["src_embeds"]`` first).  The final norm and the readout work
    per position, so they run on the last position only: the same numbers
    as JAX's ``forward(...)[:, -1, :]`` without the (B, S, V) logits (2.1
    GB in f32 at llama3.2-1b, B = 1, S = 4096).  On a mesh (``dist``:
    ``params`` each rank's blocks, ``batch`` whole on every rank) the
    sharded forward runs and the last position's logits come back whole
    on every rank."""
    def prefill_step(params, batch):
        with torch.no_grad():
            x = tfm.hidden(params, batch, cfg, dist,
                           kv_chunk=kv_chunk)[:, -1:]
            x = cm.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps,
                                 gemma_style=cfg.gemma_norm)
            logits = tfm._readout(params, x, cfg, dist)[:, -1, :]
            return tfm.gather_logits(logits, cfg, dist)

    return prefill_step


def make_serve_step(cfg, dist=None):
    """``serve_step(params, cache, tokens, idx, memory=None) -> (next
    (B, 1), cache)``: one greedy decode step (``memory``: the encoder's
    output, for an encoder-decoder).  On a mesh (``dist``: ``params`` and
    ``cache`` each rank's blocks, from ``tfm.init``/``tfm.init_cache``
    with ``dist``; ``tokens`` and ``memory`` whole on every rank) the
    next tokens come back whole on every rank."""
    def serve_step(params, cache, tokens, idx, memory=None):
        with torch.no_grad():
            logits, cache = tfm.decode_step(params, cache, tokens, idx, cfg,
                                            memory=memory, dist=dist)
            return torch.argmax(logits[:, -1, :], dim=-1)[:, None], cache

    return serve_step
