"""The port's LM training on a (data, model) mesh across gloo processes on
the CPU, held to the JAX package's mesh train step and runtime.

The JAX references come from one subprocess with four forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``) and reach one
launch of four ranks (``launch.mesh.run_spmd``) through one pickle file,
as ``tests/test_torch_mesh_forward.py`` does:

- reduced llama3.2-1b in f32 on (2, 2) under ``make_dist``, AdamW with
  ZeRO-1, against JAX's ``jax.jit(make_train_step(cfg, dist, opt_cfg))``
  on its own 2x2 mesh at ``grad_accum`` 1 and 2: the loss, the gnorm, every
  gradient, update and moment gathered whole; the batch has ragged
  ``targets < 0`` on one data rank's rows only, where the mean of the
  ranks' means is not the global mean;
- reduced dbrx-132b with ``moe_impl="ep"`` (experts over ('data',
  'model'): the all-to-all path, tokens dropped at capacity) and
  Adafactor, held the same way, its factored state too;
- the port's mesh step against its one-rank step (no drop, so the same
  function): llama at (2, 2) with ZeRO-2 and at (1, 4) (a k/v block cuts a
  kv head: the gathered projection's gradient is reduce-scattered back),
  a kv-replicated llama at (1, 4) (the k/v weight's gradient summed over
  the heads' group), deepseek-v3-671b (MLA's compressions and the dense
  MoE's split experts), a 16-layer llama whose ZeRO-1 dim is the stack of
  layers, and dbrx's all-to-all path at a capacity that drops nothing;
- ``_zero1_spec`` on JAX's cases and ``train_state_specs``' specs equal to
  JAX's resolved ones for every leaf (llama, its 16-layer cut, dbrx);
- the smoke's planted faults, each read past its tolerance: one rank
  skips the gradient mean over 'data', the norm taken over the rank's own
  blocks, Adafactor's row means left local, the log-sum-exp's sum left
  unreduced;
- the runtime: ``train(data=2, model=2, fail_at=[6])`` against JAX's run
  of the same call; a checkpoint written on (2, 2) restored through
  ``restore_on_mesh`` on ``shrink_mesh(2, model=2)`` and on one rank, bit
  for bit, its arrays those JAX's ``CheckpointManager`` writes; a whole
  ZeRO-1 train state saved on (2, 2) and restored on (1, 2);
  ``crosspod_allreduce_compressed`` on (pod 2, data 2, model 1).
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import run_spmd

WORLD = 4
TOL_GRAD = 1e-3      # f32 gradients, updates, moments: relative to a
                     # leaf's max (tests/test_torch_lm_train.py)
TOL_LOSS = 1e-5      # f32 loss, relative
TOL_GNORM = 1e-4     # tests/test_torch_train_runtime.py's
B, S, KV_CHUNK = 4, 16, 4
TRAIN_KW = dict(steps=12, batch=8, seq=32, ckpt_every=4, fail_at=[6],
                data=2, model=2)
ADAMW = dict(name="adamw", lr=3e-4, eps=1e-3)     # eps: a conditioned step
ADAFACTOR = dict(name="adafactor", lr=1e-4)
# JAX's _zero1_spec cases (tests/test_optim.py) and the rule's edges
ZERO1_CASES = [((None, "model"), (64, 32)), ((None,), (3,)),
               (("data", None), (64, 32)), ((("data", "model"), None),
                                            (16, 64)),
               ((None, None), (8, 32)), ((), (2, 16, 64)),
               (("model",), (64,)), ((None, None), (15, 17))]
# the port's mesh step against its one-rank step:
# (name, mesh, grad_accum, ZeRO-2)
ONE_RANK_CASES = [("llama3.2-1b", (2, 2), 1, False),
                  ("llama3.2-1b", (2, 2), 2, True),
                  ("llama3.2-1b", (1, 4), 1, False),
                  ("llama_kv1", (1, 4), 1, False),
                  ("deepseek-v3-671b", (2, 2), 1, False),
                  ("llama_16", (2, 2), 1, True),
                  ("dbrx_nodrop", (2, 2), 1, False)]
SPEC_CASES = ("llama3.2-1b", "llama_16", "dbrx-132b")


def cfg_of(name, registry):
    """The configs by name (``registry``: JAX's or the port's)."""
    if name == "llama_kv1":
        return dataclasses.replace(registry.get_reduced("llama3.2-1b"),
                                   num_kv_heads=1, head_dim=18)
    if name == "llama_16":
        cfg = registry.get_reduced("llama3.2-1b")
        return dataclasses.replace(cfg, num_layers=16, stages=(
            (cfg.stages[0][0], 16),))
    if name == "dbrx-132b":
        return dataclasses.replace(registry.get_reduced(name), moe_impl="ep")
    if name == "dbrx_nodrop":
        cfg = registry.get_reduced("dbrx-132b")
        return dataclasses.replace(cfg, moe_impl="ep", capacity_factor=(
            cfg.n_experts / cfg.top_k))
    return registry.get_reduced(name)


JAX_REFS = r"""
import dataclasses, os, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import registry
from repro.configs.base import ShapeConfig
from repro.launch import steps as jsteps
from repro.launch.mesh import make_host_mesh
from repro.launch.train import train
from repro.models import transformer as tfm
from repro.runtime import compress
from repro.sharding import shard_map_compat
from repro.train import optim as jopt
from repro.train.checkpoint import CheckpointManager
from jax.sharding import PartitionSpec as P

with open(sys.argv[1], "rb") as f:
    conf = pickle.load(f)
sys.path.insert(0, conf["tests_dir"])
from test_torch_mesh_train import cfg_of

def np_tree(t):
    return jax.tree.map(np.asarray, t)

def spec_tuple(sp):
    t = tuple(sp)
    while t and t[-1] is None:
        t = t[:-1]
    return t

def keyed(tree, is_leaf=None):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=is_leaf)[0]:
        out["/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path)] = leaf
    return out

mesh = make_host_mesh(data=2, model=2)
batch = {k: jnp.asarray(v) for k, v in conf["batch"].items()}
out = {"step": {}, "specs": {}}
for arch, opt_kw, accums in (("llama3.2-1b", conf["adamw"], (1, 2)),
                             ("dbrx-132b", conf["adafactor"], (1,))):
    cfg = cfg_of(arch, registry)
    p = jax.jit(lambda k: jax.tree.map(lambda a: a.astype(jnp.float32),
                                       tfm.init(k, cfg)[0]))(
        jax.random.PRNGKey(0))
    dist = jsteps.make_dist(mesh, cfg, ShapeConfig("t", "train", conf["S"],
                                                   conf["B"]))
    ocfg = jopt.OptConfig(**opt_kw)
    init, _ = jopt.OPTIMIZERS[ocfg.name]
    st = {"params": p, "opt": init(p, None, None, ocfg)[0],
          "step": jnp.zeros((), jnp.int32)}
    with mesh:
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, b: tfm.loss_fn(p, b, cfg, dist,
                                     kv_chunk=conf["kv_chunk"])))(p, batch)
        for accum in accums:
            new, m = jax.jit(jsteps.make_train_step(
                cfg, dist, ocfg, grad_accum=accum,
                kv_chunk=conf["kv_chunk"]))(st, batch)
            out["step"][(arch, accum)] = {
                "params": np_tree(p), "loss": float(m["loss"]),
                "gnorm": float(m["gnorm"]), "grads": np_tree(grads),
                "grad_loss": float(loss), "new": np_tree(new["params"]),
                "opt": np_tree(new["opt"]), "rules": dict(dist.rules)}
for name in conf["spec_cases"]:
    cfg = cfg_of(name, registry)
    dist = jsteps.make_dist(mesh, cfg, ShapeConfig("t", "train", conf["S"],
                                                   conf["B"]))
    _, shd, gshd = jsteps.train_state_specs(cfg, dist,
                                            jsteps.opt_config_for(cfg))
    is_shd = lambda x: hasattr(x, "spec")
    out["specs"][name] = (
        {k: spec_tuple(v.spec) for k, v in keyed(shd, is_shd).items()},
        {k: spec_tuple(v.spec) for k, v in keyed(gshd, is_shd).items()})
out["zero1"] = [spec_tuple(jopt._zero1_spec(P(*sp), shape, "data"))
                for sp, shape in conf["zero1_cases"]]
# the runtime: JAX's train() on f32 params (its init's dtype set here, in
# this process), so the f32 tolerance applies
import types
import repro.launch.train as jtrain
jtrain.tfm = types.SimpleNamespace(
    init=lambda key, cfg: tfm.init(key, cfg, dtype=jnp.float32))
cfg = registry.get_reduced("llama3.2-1b")
out["train_params"] = np_tree(tfm.init(jax.random.PRNGKey(0), cfg,
                                       dtype=jnp.float32)[0])
out["train_losses"], out["train_final"] = train(
    "llama3.2-1b", reduced=True, ckpt_dir=os.path.join(conf["tmp"], "jck"),
    **conf["train_kw"])
state = {"w": jnp.arange(64, dtype=jnp.float32).reshape(8, 8)}
ck = CheckpointManager(os.path.join(conf["tmp"], "jax_ckpt"),
                       async_save=False)
ck.save(3, state)
with np.load(os.path.join(conf["tmp"], "jax_ckpt", "step_00000003",
                          "arrays.npz")) as z:
    out["ckpt"] = {k: z[k] for k in z.files}
pmesh = make_host_mesh(data=2, model=1, pod=2)
fm = shard_map_compat(
    lambda g, e: compress.crosspod_allreduce_compressed(g, e, "pod"), pmesh,
    in_specs=({"w": P("pod", None)},) * 2,
    out_specs=({"w": P("pod", None)},) * 2)
out["crosspod"] = {}
for case, (a, b) in (("agree", (0.0, 1.0)), ("differ", (0.5, 1.0))):
    grads = {"w": jnp.stack([jnp.full((4,), a), jnp.full((4,), b)])}
    with pmesh:
        mean, new_e = fm(grads, {"w": jnp.zeros((2, 4))})
    out["crosspod"][case] = (np.asarray(mean["w"]), np.asarray(new_e["w"]))
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f, protocol=5)
"""


def rel(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _skip(kinds, ranks):
    """Patch ``comm.all_reduce`` so that the ranks in ``ranks`` leave the
    collectives of ``kinds`` unreduced (the collective still runs, so no
    rank waits); returns the undo."""
    import torch.distributed as tdist
    from repro_torch.core import comm
    orig = comm.all_reduce

    def all_reduce(t, group, kind="all_reduce", op="sum"):
        y = orig(t, group, kind, op)
        return t if kind in kinds and tdist.get_rank() in ranks else y
    comm.all_reduce = all_reduce
    return lambda: setattr(comm, "all_reduce", orig)


def _whole(tree, placements):
    """Every leaf of a rank's tree gathered whole (a collective)."""
    from repro_torch.train.checkpoint import _placement_leaves
    from repro_torch.train.tree import tree_leaves, tree_unflatten
    return tree_unflatten(tree, [pl.gather(t) for t, pl in zip(
        tree_leaves(tree), _placement_leaves(placements))])


def _worst(got, want) -> float:
    from repro_torch.train.tree import tree_leaves
    return max(rel(w.float().numpy(), g.float().numpy())
               for g, w in zip(tree_leaves(got), tree_leaves(want)))


def _setup(name, mesh_shape, opt_kw, whole, grad_accum=1):
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.train import optim
    cfg = cfg_of(name, registry)
    dist = steps.make_dist(make_host_mesh(*mesh_shape), cfg,
                           ShapeConfig("t", "train", S, B))
    ocfg = optim.OptConfig(**opt_kw)
    params = dist.shard_params(whole, tfm.specs(cfg))
    init, _ = optim.OPTIMIZERS[ocfg.name]
    opt = init(params, ocfg, stacks=tfm.param_stacks(cfg, params),
               specs=tfm.specs(cfg), dist=dist,
               shapes=tfm.param_shapes(cfg))
    state = {"params": params, "opt": opt,
             "step": torch.zeros((), dtype=torch.int32)}
    _, pl, gpl = steps.train_state_specs(cfg, dist, ocfg)
    return cfg, dist, ocfg, state, pl, gpl


def _adafactor_ref(jopt_state, cfg):
    """JAX's Adafactor state keyed by the port's group names."""
    from repro_torch.train.tree import tree_paths
    flat = dict(tree_paths(jopt_state["f"]))
    out = {}
    for key, a in flat.items():
        parts = key.split("/")
        leaf = parts[-1]
        path = "/".join(parts[:-1])
        if path.startswith("stages/"):
            sub = path.split("/", 3)[3]
            name = f"layers.0.{sub.replace('/', '.')}*{cfg.num_layers}"
        else:
            name = path.replace("/", ".")
        out.setdefault(name, {})[leaf] = torch.from_numpy(
            np.asarray(a, np.float32))
    return out


def _jax_case(arch, ref, batch, accum, opt_kw):
    from repro_torch.configs import registry
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tfm
    from repro_torch.train.tree import tree_leaves
    whole = tfm.params_from_jax(ref["params"], cfg_of(arch, registry),
                                device="cpu")
    cfg, dist, ocfg, state, pl, _ = _setup(arch, (2, 2), opt_kw, whole)
    rec = {"rules": dict(dist.rules)}

    def port(tree):
        return tfm.params_from_jax(tree, cfg, device="cpu")
    if accum == 1:
        loss, grads = steps.loss_and_grads(cfg, state["params"], batch,
                                           kv_chunk=KV_CHUNK, dist=dist)
        rec["grad_loss"] = rel(ref["grad_loss"], float(loss))
        rec["grads"] = _worst(_whole(grads, pl["params"]),
                              port(ref["grads"]))
    step = steps.make_train_step(cfg, ocfg, grad_accum=accum,
                                 kv_chunk=KV_CHUNK, dist=dist)
    new, m = step(state, batch)
    rec["loss"] = rel(ref["loss"], float(m["loss"]))
    rec["gnorm"] = rel(ref["gnorm"], float(m["gnorm"]))
    got = _whole(new["params"], pl["params"])
    want = port(ref["new"])
    rec["update"] = max(rel((w - p0).numpy(), (g - p0).numpy())
                        for g, w, p0 in zip(tree_leaves(got),
                                            tree_leaves(want),
                                            tree_leaves(whole)))
    if ocfg.name == "adamw":
        rec["moments"] = max(_worst(_whole(new["opt"][k], pl["opt"][k]),
                                    port(ref["opt"][k])) for k in "mv")
        rec["zero1_bytes"] = sum(t.numel() for t in tree_leaves(
            new["opt"]["m"]))
        rec["param_elems"] = sum(t.numel() for t in tree_leaves(whole))
    else:
        want_f = _adafactor_ref(ref["opt"], cfg)
        got_f = _whole(new["opt"]["f"], pl["opt"]["f"])
        assert sorted(got_f) == sorted(want_f), (sorted(got_f),
                                                 sorted(want_f))
        rec["moments"] = max(rel(want_f[n][k].numpy(), got_f[n][k].numpy())
                             for n in want_f for k in want_f[n])
    return rec, (cfg, dist, ocfg, state, pl, whole, want)


def _planted(case, batch, kinds, ranks):
    """The step of ``case`` with ``kinds`` left unreduced on ``ranks``:
    (loss, gnorm, update) errors against the reference."""
    from repro_torch.launch import steps
    from repro_torch.train.tree import tree_leaves
    cfg, dist, ocfg, state, pl, whole, want = case["ctx"]
    ref = case["ref"]
    undo = _skip(kinds, ranks)
    try:
        new, m = steps.make_train_step(cfg, ocfg, kv_chunk=KV_CHUNK,
                                       dist=dist)(state, batch)
    finally:
        undo()
    got = _whole(new["params"], pl["params"])
    upd = max(rel((w - p0).numpy(), (g - p0).numpy())
              for g, w, p0 in zip(tree_leaves(got), tree_leaves(want),
                                  tree_leaves(whole)))
    return {"loss": rel(ref["loss"], float(m["loss"])),
            "gnorm": rel(ref["gnorm"], float(m["gnorm"])), "update": upd}


def _one_rank_case(name, mesh_shape, accum, zero2, batch):
    """The mesh step against the one-rank step on the same seeded f32
    params: loss, gnorm, updates."""
    from repro_torch.configs import registry
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tfm
    from repro_torch.train import optim
    from repro_torch.train.tree import tree_leaves
    cfg = cfg_of(name, registry)
    whole = tfm.init(cfg, seed=1, device="cpu", dtype=torch.float32)
    ocfg = optim.OptConfig(**ADAMW)
    init, _ = optim.OPTIMIZERS[ocfg.name]
    one = {"params": whole, "opt": init(whole, ocfg, tfm.param_stacks(
        cfg, whole)), "step": torch.zeros((), dtype=torch.int32)}
    new1, m1 = steps.make_train_step(cfg, ocfg, grad_accum=accum,
                                     kv_chunk=KV_CHUNK)(one, batch)
    cfg, dist, ocfg, state, pl, gpl = _setup(name, mesh_shape, ADAMW, whole)
    new, m = steps.make_train_step(
        cfg, ocfg, grad_accum=accum, kv_chunk=KV_CHUNK, dist=dist,
        grad_shardings=gpl if zero2 else None)(state, batch)
    got = _whole(new["params"], pl["params"])
    upd = max(rel((w - p0).numpy(), (g - p0).numpy())
              for g, w, p0 in zip(tree_leaves(got),
                                  tree_leaves(new1["params"]),
                                  tree_leaves(whole)))
    moments = max(_worst(_whole(new["opt"][k], pl["opt"][k]),
                         new1["opt"][k]) for k in "mv")
    return {"loss": rel(float(m1["loss"]), float(m["loss"])),
            "gnorm": rel(float(m1["gnorm"]), float(m["gnorm"])),
            "update": upd, "moments": moments,
            "groups_zero": sorted({g.zero for g in optim.mesh_groups(
                state["params"], ocfg, tfm.param_stacks(cfg, whole),
                tfm.specs(cfg), dist, tfm.param_shapes(cfg))},
                key=lambda z: -1 if z is None else z)}


def _specs(name):
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.checkpoint import _placement_leaves
    from repro_torch.train.tree import tree_paths
    cfg = cfg_of(name, registry)
    dist = steps.make_dist(make_host_mesh(2, 2), cfg,
                           ShapeConfig("t", "train", S, B))
    _, pl, gpl = steps.train_state_specs(cfg, dist,
                                         steps.opt_config_for(cfg))

    def flat(tree):
        keys = [k for k, _ in tree_paths(tree_map_none(tree))]
        return {k: _strip(p.spec) for k, p in zip(
            keys, _placement_leaves(tree))}
    return flat(pl), flat(gpl)


def tree_map_none(tree):
    """A placement tree with None leaves (so ``tree_paths`` sees its
    structure, not the dataclasses)."""
    if isinstance(tree, dict):
        return {k: tree_map_none(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_none(v) for v in tree]
    return None


def _strip(sp):
    t = tuple(sp)
    while t and t[-1] is None:
        t = t[:-1]
    return t


def _train_twin(np_params, tmp):
    from repro_torch.configs import registry
    from repro_torch.launch.train import train
    from repro_torch.models import transformer as tfm
    cfg = registry.get_reduced("llama3.2-1b")
    whole = tfm.params_from_jax(np_params, cfg, device="cpu")
    losses, final = train("llama3.2-1b", reduced=True, device="cpu",
                          params=whole, log_every=100,
                          ckpt_dir=os.path.join(tmp, "port_ckpt"),
                          **TRAIN_KW)
    return {"losses": losses, "final": final}


def _elastic(tmp):
    """A state saved on (2, 2), restored on ``shrink_mesh(2, model=2)`` and
    on one rank; a ZeRO-1 train state saved on (2, 2), restored on (1,
    2)."""
    import torch.distributed as tdist
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import build_state
    from repro_torch.runtime.elastic import restore_on_mesh, shrink_mesh
    from repro_torch.sharding import DEFAULT_RULES, DistContext, Spec
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.tree import tree_leaves
    out = {}
    whole = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8)}
    specs = {"w": Spec(None, "model")}
    big = DistContext(make_host_mesh(2, 2), dict(DEFAULT_RULES))
    ck = CheckpointManager(os.path.join(tmp, "el"), async_save=False,
                           dist=big)
    blk = {"w": big.shard_params(whole, specs)["w"]}
    pl = {"w": big.placement(big.resolve(specs["w"]), (8, 8))}
    ck.save(3, blk, placements=pl)
    ck.wait()
    small = shrink_mesh(2, model=2)
    out["small_shape"] = dict(zip(small.mesh_dim_names, small.shape))
    sd = DistContext(small, dict(DEFAULT_RULES))
    got = restore_on_mesh(ck, whole, specs, sd)
    if got is None:
        out["restored_small"] = None
    else:
        m = sd.shard_of("model", 8)[0]
        out["restored_small"] = bool(torch.equal(
            got["w"], whole["w"][:, 4 * m:4 * m + 4]))
    one = CheckpointManager(os.path.join(tmp, "el")).restore(whole)
    out["restored_one"] = bool(torch.equal(one["w"], whole["w"]))
    if tdist.get_rank() == 0:
        with np.load(os.path.join(tmp, "el", "step_00000003",
                                  "arrays.npz")) as z:
            out["npz"] = {k: z[k] for k in z.files}
    # a whole train state: ZeRO-1 on (2, 2) -> (1, 2)
    cfg = registry.get_reduced("llama3.2-1b")
    shape = ShapeConfig("t", "train", S, B)
    d22 = steps.make_dist(make_host_mesh(2, 2), cfg, shape)
    state, ocfg = build_state(cfg, seed=3, device="cpu", dist=d22)
    state, _ = steps.make_train_step(cfg, ocfg, kv_chunk=KV_CHUNK,
                                     dist=d22)(state, _batch())
    pl22 = steps.train_state_specs(cfg, d22, ocfg)[1]
    ck2 = CheckpointManager(os.path.join(tmp, "st"), dist=d22)
    ck2.save(1, state, placements=pl22)
    ck2.wait()
    before = _whole(state, pl22)
    d12 = steps.make_dist(shrink_mesh(2, model=2), cfg, shape)
    if d12.mesh.get_coordinate() is None:
        out["state_small"] = None
        restore_on_mesh(ck2, state, None, d12)
    else:
        pl12 = steps.train_state_specs(cfg, d12, ocfg)[1]
        tmpl, _ = build_state(cfg, seed=4, device="cpu", dist=d12)
        got = restore_on_mesh(ck2, tmpl, pl12, d12)
        after = _whole(got, pl12)
        out["state_small"] = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(before), tree_leaves(after)))
    return out


def _crosspod():
    """JAX's case (pods at 0 and 1) and the 0.5/1.0 case on (pod 2, data
    2, model 1): (mean, residual) of each rank's pod."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime import compress
    from repro_torch.sharding import DistContext
    dist = DistContext(make_host_mesh(data=2, model=1, pod=2))
    pod = dist.shard_of("pod", 2)[0]
    out = {}
    for case, vals in (("agree", (0.0, 1.0)), ("differ", (0.5, 1.0))):
        g = {"w": torch.full((4,), vals[pod])}
        e = compress.init_error_state(g)
        mean, ne = compress.crosspod_allreduce_compressed(g, e, dist)
        out[case] = (pod, mean["w"].numpy(), ne["w"].numpy())
    return out


def _batch():
    return {k: torch.from_numpy(v) for k, v in _BATCH[0].items()}


_BATCH = [None]


def _rank(rank, world, dev, path):
    torch.set_num_threads(1)
    with open(path, "rb") as f:
        refs = pickle.load(f)
    _BATCH[0] = refs["batch"]
    batch = _batch()
    out = {"step": {}, "planted": {}, "one_rank": {}, "specs": {}}
    cases = {}
    for (arch, accum), ref in sorted(refs["step"].items()):
        opt_kw = ADAMW if arch == "llama3.2-1b" else ADAFACTOR
        rec, ctx = _jax_case(arch, ref, batch, accum, opt_kw)
        out["step"][(arch, accum)] = rec
        cases[(arch, accum)] = {"ctx": ctx, "ref": ref}
    llama, dbrx = cases[("llama3.2-1b", 1)], cases[("dbrx-132b", 1)]
    out["planted"]["skipped_data_mean"] = _planted(
        llama, batch, ("grad_all_reduce",), (1,))
    out["planted"]["rank_local_norm"] = _planted(
        llama, batch, ("norm_all_reduce",), range(world))
    out["planted"]["local_row_mean"] = _planted(
        dbrx, batch, ("adafactor_all_reduce",), range(world))
    out["planted"]["unsummed_lse"] = _planted(
        llama, batch, ("lse_all_reduce",), range(world))
    for case in ONE_RANK_CASES:
        out["one_rank"][case] = _one_rank_case(*case, batch)
    for name in SPEC_CASES:
        out["specs"][name] = _specs(name)
    from repro_torch.train import optim
    out["zero1"] = [_strip(optim._zero1_spec(optim.Spec(*sp), shape))
                    for sp, shape in ZERO1_CASES]
    out["train"] = _train_twin(refs["train_params"], refs["tmp"])
    out["elastic"] = _elastic(refs["tmp"])
    out["crosspod"] = _crosspod()
    return out


# ---------------------------------------------------------------------------
# the JAX side and the launch (here)
# ---------------------------------------------------------------------------

def _make_batch():
    """JAX's token pipeline's batch, with ``targets < 0`` from position 5
    of row 0 on: ragged on data rank 0's rows only."""
    from repro.configs import registry as jregistry
    from repro.train.data import TokenPipeline
    b = TokenPipeline(jregistry.get_reduced("llama3.2-1b"), B, S,
                      seed=0).batch_at(3)
    b = {k: np.asarray(v).astype(np.int64) for k, v in b.items()}
    b["targets"][0, 5:] = -1
    return b


@pytest.fixture(scope="module")
def launch(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_train")
    batch = _make_batch()
    with open(tmp / "conf.pkl", "wb") as f:
        pickle.dump({"batch": batch, "B": B, "S": S, "kv_chunk": KV_CHUNK,
                     "adamw": ADAMW, "adafactor": ADAFACTOR,
                     "spec_cases": SPEC_CASES, "zero1_cases": ZERO1_CASES,
                     "train_kw": TRAIN_KW, "tmp": str(tmp),
                     "tests_dir": os.path.dirname(__file__)}, f)
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..",
                                       "src"))
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(JAX_REFS),
                        str(tmp / "conf.pkl"), str(tmp / "refs.pkl")],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    with open(tmp / "refs.pkl", "rb") as f:
        refs = pickle.load(f)
    refs["batch"] = batch
    refs["tmp"] = str(tmp)
    with open(tmp / "refs.pkl", "wb") as f:
        pickle.dump(refs, f, protocol=5)
    ranks = run_spmd(_rank, WORLD, str(tmp / "refs.pkl"), device="cpu",
                     timeout=300)
    return {"ranks": ranks, "refs": refs}


@pytest.mark.parametrize("arch,accum", [("llama3.2-1b", 1),
                                        ("llama3.2-1b", 2),
                                        ("dbrx-132b", 1)])
def test_train_step_on_2x2_matches_jax(launch, arch, accum):
    """Loss, gnorm, every gradient, update and moment gathered whole,
    against JAX's mesh train step; the rules are JAX's."""
    ref = launch["refs"]["step"][(arch, accum)]
    for res in launch["ranks"]:
        rec = res["step"][(arch, accum)]
        assert rec["rules"] == ref["rules"]
        assert rec["loss"] <= TOL_LOSS and rec["gnorm"] <= TOL_GNORM, rec
        assert rec["update"] <= TOL_GRAD and rec["moments"] <= TOL_GRAD, rec
        if accum == 1:
            assert rec["grad_loss"] <= TOL_LOSS, rec
            assert rec["grads"] <= TOL_GRAD, rec


def test_dbrx_trains_on_the_all_to_all_path(launch):
    ref = launch["refs"]["step"][("dbrx-132b", 1)]
    assert ref["rules"]["expert"] == ("data", "model")


def test_zero1_holds_a_quarter_of_adams_state(launch):
    """AdamW's m on a rank: its model block's data part, ~1/4 of the
    whole (the norms, replicated and too small for ZeRO-1, whole)."""
    for res in launch["ranks"]:
        rec = res["step"][("llama3.2-1b", 1)]
        assert rec["zero1_bytes"] < 0.27 * rec["param_elems"], rec


def test_ragged_targets_take_the_global_mean(launch):
    """Row 0's masked tail sits on data rank 0 only: the mean of the two
    data ranks' means differs from the global mean, which the loss
    matched above."""
    t = launch["refs"]["batch"]["targets"]
    half = t.shape[0] // 2
    counts = [(t[:half] >= 0).sum(), (t[half:] >= 0).sum()]
    assert counts[0] != counts[1]


@pytest.mark.parametrize("fault,what,limit", [
    ("skipped_data_mean", "update", TOL_GRAD),
    ("rank_local_norm", "gnorm", TOL_GNORM),
    ("local_row_mean", "update", TOL_GRAD),
    ("unsummed_lse", "loss", TOL_LOSS)])
def test_planted_faults_exceed_the_tolerances(launch, fault, what, limit):
    for res in launch["ranks"]:
        assert res["planted"][fault][what] > limit, res["planted"][fault]


@pytest.mark.parametrize("case", ONE_RANK_CASES,
                         ids=[f"{c[0]}-{c[1][0]}x{c[1][1]}-a{c[2]}"
                              f"{'-zero2' if c[3] else ''}"
                              for c in ONE_RANK_CASES])
def test_mesh_step_matches_the_one_rank_step(launch, case):
    for res in launch["ranks"]:
        rec = res["one_rank"][case]
        assert rec["loss"] <= TOL_LOSS and rec["gnorm"] <= TOL_GNORM, rec
        assert rec["update"] <= TOL_GRAD and rec["moments"] <= TOL_GRAD, rec
    if case[0] == "llama_16":
        # ZeRO-1 splits the stack of layers (dim 0) and the embedding
        assert 0 in rec["groups_zero"], rec


def test_zero1_spec_matches_jax(launch):
    for res in launch["ranks"]:
        assert res["zero1"] == launch["refs"]["zero1"]


def _jax_key(port_key, cfg):
    """A port leaf path's key in JAX's stacked tree (one-kind stages)."""
    parts = port_key.split("/")
    if parts[0] in ("params", "opt") and "layers" in parts:
        i = parts.index("layers")
        return "/".join(parts[:i] + ["stages", "0", "l0"] + parts[i + 2:])
    return port_key


@pytest.mark.parametrize("name", SPEC_CASES)
def test_train_state_specs_match_jax(launch, name):
    """Every leaf's placement spec (state and ZeRO-2 gradients) equal to
    JAX's resolved one; a port leaf of a stack carries the stacked spec."""
    from repro_torch.configs import registry
    cfg = cfg_of(name, registry)
    jstate, jgrad = launch["refs"]["specs"][name]
    for res in launch["ranks"]:
        pstate, pgrad = res["specs"][name]
        for k, sp in pstate.items():
            if k.startswith("opt/f/"):
                continue
            assert jstate[_jax_key(k, cfg)] == sp, (k, sp)
        for k, sp in pgrad.items():
            assert jgrad[_jax_key("params/" + k, cfg)[7:]] == sp, (k, sp)
        # Adafactor's state: one a group, keyed by the group's name
        fk = {k for k in pstate if k.startswith("opt/f/")}
        jf = {k for k in jstate if k.startswith("opt/f/")}
        assert len(fk) == len(jf)
        for k in fk:
            name_, leaf = k.split("/")[2], k.split("/")[3]
            path = name_.split("*")[0].replace(".", "/")
            assert jstate[_jax_key("opt/f/" + path + "/" + leaf, cfg)] == \
                pstate[k], k


def test_train_with_failure_restart_matches_jax(launch):
    """JAX's test_sharded_train_with_failure_restart twin: the port's
    train(data=2, model=2, fail_at=[6]) from JAX's initial params reaches
    step 12 with JAX's losses, the same on every rank.  Both sides train
    f32 params (JAX's init cast in its subprocess): in bf16 the two
    packages' forwards round in other orders, 1.2e-4 of the loss apart at
    the first step."""
    want = launch["refs"]["train_losses"]
    assert launch["refs"]["train_final"] == 12
    for res in launch["ranks"]:
        got = res["train"]
        assert got["final"] == 12 and len(got["losses"]) == len(want)
        assert got["losses"] == launch["ranks"][0]["train"]["losses"]
        assert rel(want, got["losses"]) <= TOL_LOSS, (want, got["losses"])


def test_elastic_restore_on_smaller_mesh(launch):
    """Saved on (2, 2), restored through restore_on_mesh on shrink_mesh(2,
    model=2) (ranks 2, 3 left out) and on one rank, bit for bit; the npz
    arrays those JAX's CheckpointManager writes for the same state."""
    for r, res in enumerate(launch["ranks"]):
        el = res["elastic"]
        assert el["small_shape"] == {"data": 1, "model": 2}
        assert el["restored_small"] is (True if r < 2 else None)
        assert el["restored_one"]
        assert el["state_small"] is (True if r < 2 else None)
    got, want = launch["ranks"][0]["elastic"]["npz"], launch["refs"]["ckpt"]
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes()


def test_crosspod_compressed_allreduce(launch):
    """Pods at 0 and 1 (JAX's own case, where the zero pod's codes do not
    depend on its scale): equal to JAX's, mean and residual.  Pods at 0.5
    and 1.0: within half a step of the shared grid (scale 1/127) of the
    true mean 0.75, where JAX's, quantizing each pod on its own scale and
    multiplying the summed codes by the largest, gives 1.0."""
    jax_agree, jax_differ = (launch["refs"]["crosspod"][c]
                             for c in ("agree", "differ"))
    np.testing.assert_allclose(jax_differ[0], 1.0)
    for res in launch["ranks"]:
        pod, mean, err = res["crosspod"]["agree"]
        assert np.array_equal(mean, jax_agree[0][pod])
        assert np.array_equal(err, jax_agree[1][pod])
        pod, mean, err = res["crosspod"]["differ"]
        assert np.abs(mean - 0.75).max() <= 0.5 / 127
        assert mean.dtype == np.float32


def test_quantize_int8_and_error_state_bit_equal_to_jax():
    import jax.numpy as jnp
    from repro.runtime import compress as jcompress
    from repro_torch.runtime import compress
    rng = np.random.default_rng(3)
    for shape in ((17,), (8, 33), (3, 4, 5)):
        g = rng.standard_normal(shape).astype(np.float32)
        e = (rng.standard_normal(shape) * 1e-3).astype(np.float32)
        jq, js, je = jcompress.quantize_int8(jnp.asarray(g), jnp.asarray(e))
        q, s, ne = compress.quantize_int8(torch.from_numpy(g),
                                          torch.from_numpy(e))
        assert np.array_equal(np.asarray(jq), q.numpy())
        assert np.asarray(js).tobytes() == s.numpy().tobytes()
        assert np.asarray(je).tobytes() == ne.numpy().tobytes()
    params = {"a": torch.ones(3, 2, dtype=torch.bfloat16),
              "b": [torch.ones(4)]}
    z = compress.init_error_state(params)
    jz = jcompress.init_error_state({"a": jnp.ones((3, 2), jnp.bfloat16),
                                     "b": [jnp.ones(4)]})
    for t, j in ((z["a"], jz["a"]), (z["b"][0], jz["b"][0])):
        assert t.dtype == torch.float32 and np.asarray(j).dtype == np.float32
        assert np.array_equal(t.numpy(), np.asarray(j))


def test_lm_train_and_the_cli_on_a_2x2_mesh(capsys):
    """``python -m repro_torch.lm_train`` (the JAX example's 2x2 mesh, the
    failure at step 12) and ``python -m repro_torch.launch.train --data 2
    --model 2``: each launches its four ranks and prints the first rank's
    lines."""
    from repro_torch import lm_train
    from repro_torch.launch import train as ttrain
    losses, final = lm_train.main(["--device", "cpu", "--steps", "14",
                                   "--batch", "4", "--seq", "16"])
    # steps 0-11, the failure at 12, steps 10-13 again from step 10
    assert final == 14 and len(losses) == 16 and all(np.isfinite(losses))
    losses, final = ttrain.main(["--device", "cpu", "--steps", "3",
                                 "--batch", "4", "--seq", "16", "--data",
                                 "2", "--model", "2"])
    assert final == 3 and len(losses) == 3
    out = capsys.readouterr().out
    assert "resumed from checkpoint" in out and "done at step 3" in out


def test_production_mesh_needs_its_world_and_pod_names_the_axis():
    """``make_production_mesh`` asks for (16, 16) or (2, 16, 16) ranks and
    raises ``ValueError`` in a smaller world, as the mesh constructors
    do; the 'pod' axis leads ``make_host_mesh``'s names (checked in the
    launch above on (pod 2, data 2, model 1))."""
    from repro_torch.launch import mesh as tmesh
    try:
        with pytest.raises(ValueError, match="needs 256 ranks"):
            tmesh.make_production_mesh()
        with pytest.raises(ValueError, match="needs 512 ranks"):
            tmesh.make_production_mesh(multi_pod=True)
        m = tmesh.make_host_mesh(1, 1, pod=1)
        assert tuple(m.mesh_dim_names) == ("pod", "data", "model")
    finally:
        tmesh.one_rank_world_end()


# ---------------------------------------------------------------------------
# training the ``rec`` and ``dec`` kinds on the mesh (recurrentgemma-2b on
# (1, 4), where a q head is cut, is in tests/test_torch_mesh_cuts.py)
# ---------------------------------------------------------------------------

REC_DEC_CASES = [("rg_2x2", "recurrentgemma-2b", (2, 2)),
                 ("seamless_2x2", "seamless-m4t-large-v2", (2, 2))]
SRC = 8

JAX_REC_DEC = r"""
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import registry
from repro.configs.base import ShapeConfig
from repro.launch import steps as jsteps
from repro.launch.mesh import make_host_mesh
from repro.models import transformer as tfm
from repro.train import optim as jopt

with open(sys.argv[1], "rb") as f:
    conf = pickle.load(f)
B, S, SRC, KV = conf["B"], conf["S"], conf["src"], conf["kv_chunk"]
np_tree = lambda t: jax.tree.map(np.asarray, t)
out = {}
for name, arch, mesh_shape in conf["cases"]:
    cfg = registry.get_reduced(arch)
    rng = np.random.default_rng(len(name))
    shapes = jax.eval_shape(lambda k: tfm.init(k, cfg, dtype=jnp.float32)[0],
                            jax.random.PRNGKey(0))
    p = jax.tree.map(lambda s: jnp.asarray(
        rng.standard_normal(s.shape).astype(np.float32)
        * (0.5 if len(s.shape) < 3 else 0.1)), shapes)
    batch = {"inputs": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "targets": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.is_encoder_decoder:
        batch["src_embeds"] = rng.standard_normal(
            (B, SRC, cfg.d_model)).astype(np.float32)
    mesh = make_host_mesh(*mesh_shape)
    dist = jsteps.make_dist(mesh, cfg, ShapeConfig("t", "train", S, B))
    ocfg = jopt.OptConfig(**conf["adamw"])
    st = {"params": p, "opt": jopt.OPTIMIZERS["adamw"][0](p, None, None,
                                                          ocfg)[0],
          "step": jnp.zeros((), jnp.int32)}
    with mesh:
        new, m = jax.jit(jsteps.make_train_step(cfg, dist, ocfg,
                                                kv_chunk=KV))(
            st, {k: jnp.asarray(v) for k, v in batch.items()})
    out[name] = {"params": np_tree(p), "batch": batch,
                 "loss": float(m["loss"]), "gnorm": float(m["gnorm"]),
                 "new": np_tree(new["params"]), "rules": dict(dist.rules)}
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f, protocol=5)
"""


def _rec_dec_rank(rank, world, dev, path):
    import warnings
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tfm
    from test_torch_mesh_cuts import _train
    torch.set_num_threads(1)
    warnings.simplefilter("ignore", RuntimeWarning)
    with open(path, "rb") as f:
        refs = pickle.load(f)
    out = {}
    for name, arch, mesh_shape in REC_DEC_CASES:
        ref = refs[name]
        cfg = registry.get_reduced(arch)
        dist = steps.make_dist(make_host_mesh(*mesh_shape), cfg,
                               ShapeConfig("t", "train", S, B))
        batch = {k: torch.from_numpy(v if v.dtype == np.float32
                                     else v.astype(np.int64))
                 for k, v in ref["batch"].items()}
        whole = tfm.params_from_jax(ref["params"], cfg, device="cpu")
        out[name] = dict(_train(cfg, dist, whole, batch, ADAMW, ref),
                         rules=dict(dist.rules))
    return out


@pytest.fixture(scope="module")
def rec_dec(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rec_dec")
    with open(tmp / "conf.pkl", "wb") as f:
        pickle.dump({"cases": REC_DEC_CASES, "B": B, "S": S, "src": SRC,
                     "kv_chunk": KV_CHUNK, "adamw": ADAMW}, f)
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..",
                                       "src"))
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(JAX_REC_DEC),
                        str(tmp / "conf.pkl"), str(tmp / "refs.pkl")],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    with open(tmp / "refs.pkl", "rb") as f:
        refs = pickle.load(f)
    return {"ranks": run_spmd(_rec_dec_rank, WORLD, str(tmp / "refs.pkl"),
                              device="cpu", timeout=300), "refs": refs}


@pytest.mark.parametrize("name", [c[0] for c in REC_DEC_CASES])
def test_rec_and_dec_train_on_the_mesh(rec_dec, name):
    """recurrentgemma-2b (the RG-LRU's channel block, its local layers'
    heads) and seamless-m4t-large-v2 (the encoder, the cross attention on
    local heads) train on (2, 2) under ``make_dist``: the loss, the gnorm
    and every AdamW update against JAX's mesh train step."""
    for res in rec_dec["ranks"]:
        rec = res[name]
        assert rec["rules"] == rec_dec["refs"][name]["rules"]
        assert rec["loss"] < TOL_LOSS and rec["gnorm"] < TOL_GNORM, rec
        assert rec["update"] < TOL_GRAD, rec
