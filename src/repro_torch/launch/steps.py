"""The train, prefill and greedy serve steps, and the mesh's rules.

Counterpart of ``repro.launch.steps``' ``make_dist``, ``dp_total``,
``make_train_step``, ``make_prefill_step``, ``make_serve_step``,
``opt_config_for`` and ``default_grad_accum``, for every layer kind the
port runs.  ``make_prefill_step`` runs the forward on a (data, model)
mesh (``dist``); training and decode take no mesh yet (the train step on
a mesh, ``train_state_specs`` and the decode cache's rules are ROADMAP
Queue 1 item 13c)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.layers import common as cm
from repro_torch.models import transformer as tfm
from repro_torch.sharding import DEFAULT_RULES, DistContext
from repro_torch.train import optim as opt_lib
from repro_torch.train.tree import tree_leaves, tree_map, tree_unflatten


def _mesh_sizes(mesh) -> dict[str, int]:
    """{axis: extent} of a ``DeviceMesh`` or of a duck-typed mesh with
    JAX's ``axis_names`` and ``shape`` mapping."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def make_dist(mesh, cfg, shape, *, parallelism: str = "auto") -> DistContext:
    """JAX's rules per (mesh, shape): the batch over ('pod', 'data'),
    replicated where it does not divide (the long KV-cache sequence then
    over 'data'); TP on 'model' (heads, ffn, vocab, experts); the decode
    cache's sequence over 'model' where its heads cannot split; mamba2 with
    no TP; the huge MoEs' experts over data·model where they divide, else
    dbrx's expert hidden dim over 'data'.  ``parallelism='dp_only'``: the
    batch over every mesh axis and no TP (TP's rules where the batch does
    not cover the mesh)."""
    rules = dict(DEFAULT_RULES)
    sizes = _mesh_sizes(mesh)
    if parallelism == "dp_only":
        batch_axes = tuple(a for a in ("pod", "data", "model") if a in sizes)
        dp = 1
        for a in batch_axes:
            dp *= sizes[a]
        if shape.global_batch % max(dp, 1) != 0 or shape.global_batch < dp:
            return make_dist(mesh, cfg, shape, parallelism="auto")
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


def loss_and_grads(cfg, params, batch, *, kv_chunk=1024, remat=True):
    """(``loss_fn``'s value, the gradient of every param in the params'
    tree and dtype), as ``jax.value_and_grad`` gives them: a leaf the loss
    does not reach gets zeros."""
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    p = tree_unflatten(params, leaves)
    with torch.enable_grad():
        loss = tfm.loss_fn(p, batch, cfg, kv_chunk=kv_chunk, remat=remat)
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), tree_unflatten(params, [
        torch.zeros_like(x) if g is None else g for x, g in zip(leaves, gs)])


def make_train_step(cfg, opt_cfg: opt_lib.OptConfig, grad_accum: int = 1,
                    kv_chunk: int = 1024, remat: bool = True):
    """``train_step(state, batch) -> (state, {"loss", "gnorm"})``:
    ``loss_and_grads`` (``grad_accum`` microbatches: the batch split along
    its rows, the gradients summed in f32 and averaged, as JAX's scan
    does), then the optimiser of ``opt_cfg`` over JAX's stacked shapes
    (``tfm.param_stacks``), under the profiler range "optimizer".
    ``state`` is {"params", "opt", "step"}; the returned state holds new
    tensors."""
    _, opt_update = opt_lib.OPTIMIZERS[opt_cfg.name]

    def train_step(state, batch):
        params = state["params"]
        dev = params["embed"]["w"].device
        batch = batch_to(batch, dev)
        if grad_accum > 1:
            n = next(iter(batch.values())).shape[0] // grad_accum
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            grads = tree_map(lambda t: torch.zeros(
                t.shape, dtype=torch.float32, device=dev), params)
            for i in range(grad_accum):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                l_i, g_i = loss_and_grads(cfg, params, mb, kv_chunk=kv_chunk,
                                          remat=remat)
                loss = loss + l_i
                grads = tree_map(lambda a, g: a + g.float(), grads, g_i)
            loss = loss / grad_accum
            grads = tree_map(lambda g: g / grad_accum, grads)
        else:
            loss, grads = loss_and_grads(cfg, params, batch,
                                         kv_chunk=kv_chunk, remat=remat)
        with torch.no_grad(), torch.profiler.record_function("optimizer"):
            new_params, new_opt, gnorm = opt_update(
                grads, state["opt"], params, opt_cfg,
                stacks=tfm.param_stacks(cfg, params))
        return ({"params": new_params, "opt": new_opt,
                 "step": state["step"] + 1},
                {"loss": loss, "gnorm": gnorm})

    return train_step


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


def make_serve_step(cfg):
    """``serve_step(params, cache, tokens, idx, memory=None) -> (next
    (B, 1), cache)``: one greedy decode step (``memory``: the encoder's
    output, for an encoder-decoder)."""
    def serve_step(params, cache, tokens, idx, memory=None):
        with torch.no_grad():
            logits, cache = tfm.decode_step(params, cache, tokens, idx, cfg,
                                            memory=memory)
            return torch.argmax(logits[:, -1, :], dim=-1)[:, None], cache

    return serve_step
