"""The mesh rules that cut a model's blocks where its layers' natural units
do not fall, across four gloo processes on the CPU, held to the JAX
package on the same numpy weights and batches:

- a block that cuts a head: gemma3-1b and recurrentgemma-2b reduced on
  (1, 4) under ``make_dist`` (2 heads of 32 over 4 ranks: half a head a
  rank; the one kv head cut too), for the prefill's logits, greedy decode
  (every step's logits, the tokens, each rank's cache blocks) and an
  AdamW train step (loss, gnorm, every update) against JAX's
  ``make_train_step`` on its own (1, 4) mesh; deepseek-v3-671b reduced to
  2 heads on (1, 4) (MLA's ``uq``, ``uk``, ``uv`` and ``o`` each cut a
  head) for the prefill and decode;
- the expert hidden dim: dbrx-132b reduced on (2, 2) with
  ``expert='model', expert_ffn='data'`` (JAX's rule for dbrx on the
  production mesh) for the prefill, decode and an Adafactor train step
  against JAX's on the same rules, its factored statistics too: on the
  reduced config's dense MoE and on dbrx's own ``moe_impl="ep"`` at a
  capacity that drops tokens (EP_CF);
- tensor parallelism for ``ssd``: mamba2-130m reduced on (2, 2) under
  ``DEFAULT_RULES`` (the 290-wide in-projection split at 145, across its
  segments) for the prefill and decode.

JAX's prefill and train step run on its own mesh with the same rules
(``DistContext``, or its ``make_dist``); its decode is single-device (its
decode does not depend on the mesh), but for the EP MoE, whose capacity
follows each data rank's token count: that decode runs on JAX's mesh.  Each case also reads a planted fault
past its tolerance: the head's gathered q without its cotangent sum, the
expert hidden blocks left ungathered, the in-projection's gather skipped.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
import warnings

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import run_spmd

WORLD = 4
TOL_F32 = 2e-5       # f32 logits and caches, relative to max|ref|
                     # (tests/test_torch_mesh_serve.py's)
TOL_GRAD = 1e-3      # f32 updates and factored statistics, relative to a
                     # leaf's max (tests/test_torch_mesh_train.py's)
TOL_LOSS = 1e-5
TOL_GNORM = 1e-4
B, S, KV_CHUNK = 4, 16, 4
PROMPT, GEN = 8, 8
ADAMW = dict(name="adamw", lr=3e-4, eps=1e-3)
ADAFACTOR = dict(name="adafactor", lr=1e-4)
# the EP case's capacity factor: a data rank's 32 prefill tokens give each
# of the 4 experts 8 slots for their 64 choices, so tokens are dropped
EP_CF = 0.5
# (name, arch, (data, model), rules, optimizer or None, config changes)
CASES = [
    ("gemma3_cut", "gemma3-1b", (1, 4), "make_dist", ADAMW, {}),
    ("rg_cut", "recurrentgemma-2b", (1, 4), "make_dist", ADAMW, {}),
    # MLA at 2 heads over 4 ranks: uq, uk, uv and o each cut a head
    ("mla_cut", "deepseek-v3-671b", (1, 4), "make_dist", None,
     {"num_heads": 2, "num_kv_heads": 2}),
    ("dbrx_effn", "dbrx-132b", (2, 2), "expert_ffn", ADAFACTOR, {}),
    ("dbrx_effn_ep", "dbrx-132b", (2, 2), "expert_ffn", ADAFACTOR,
     {"moe_impl": "ep", "capacity_factor": EP_CF}),
    ("mamba_tp", "mamba2-130m", (2, 2), "default", None, {}),
]


def rules_of(kind, sharding):
    """The hand rules of a case (``sharding``: JAX's or the port's
    module); None for ``make_dist``'s."""
    if kind == "expert_ffn":
        return dict(sharding.DEFAULT_RULES, batch="data", expert="model",
                    expert_ffn="data")
    if kind == "default":
        return dict(sharding.DEFAULT_RULES)
    return None


JAX_REFS = r"""
import contextlib, dataclasses, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro import sharding
from repro.configs import registry
from repro.configs.base import ShapeConfig
from repro.launch import steps as jsteps
from repro.launch.mesh import make_host_mesh
from repro.models import transformer as tfm
from repro.train import optim as jopt

with open(sys.argv[1], "rb") as f:
    conf = pickle.load(f)
sys.path.insert(0, conf["tests_dir"])
from test_torch_mesh_cuts import rules_of
B, S, KV, P_LEN, GEN = conf["B"], conf["S"], conf["kv"], conf["prompt"], \
    conf["gen"]
np_tree = lambda t: jax.tree.map(np.asarray, t)
out = {}

def dist_of(mesh, cfg, kind, shape):
    rules = rules_of(kind, sharding)
    if rules is None:
        return jsteps.make_dist(mesh, cfg, shape)
    return sharding.DistContext(mesh=mesh, rules=rules)

def unstack(cfg, stages):
    return [{k: np.asarray(v[r]) for k, v in st[f"l{i}"].items()}
            for (kinds, reps), st in zip(cfg.stages, stages)
            for r in range(reps) for i in range(len(kinds))]

for name, arch, mesh_shape, kind, opt, over in conf["cases"]:
    cfg = dataclasses.replace(registry.get_reduced(arch), **over)
    rng = np.random.default_rng(len(name))
    shapes = jax.eval_shape(lambda k: tfm.init(k, cfg, dtype=jnp.float32)[0],
                            jax.random.PRNGKey(0))
    p = jax.tree.map(lambda s: jnp.asarray(
        rng.standard_normal(s.shape).astype(np.float32)
        * (0.5 if len(s.shape) < 3 else 0.1)), shapes)
    batch = {"inputs": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "targets": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    mesh = make_host_mesh(*mesh_shape)
    dist = dist_of(mesh, cfg, kind, ShapeConfig("t", "train", S, B))
    rec = {"params": np_tree(p), "batch": batch, "rules": dict(dist.rules)}
    with mesh:
        rec["logits"] = np.asarray(jax.jit(lambda p, b: tfm.forward(
            p, b, cfg, dist, kv_chunk=KV))(p, {"inputs": jb["inputs"]}))
        if opt is not None:
            ocfg = jopt.OptConfig(**opt)
            init, _ = jopt.OPTIMIZERS[ocfg.name]
            st = {"params": p, "opt": init(p, None, None, ocfg)[0],
                  "step": jnp.zeros((), jnp.int32)}
            new, m = jax.jit(jsteps.make_train_step(cfg, dist, ocfg,
                                                    kv_chunk=KV))(st, jb)
            rec.update(loss=float(m["loss"]), gnorm=float(m["gnorm"]),
                       new=np_tree(new["params"]), opt=np_tree(new["opt"]))
    prompt = batch["inputs"][:, :P_LEN]
    cache, _ = tfm.init_cache(cfg, B, P_LEN + GEN, dtype=jnp.float32)
    ddist = None
    if cfg.moe_impl == "ep":
        ddist = dist_of(mesh, cfg, kind, ShapeConfig("d", "decode",
                                                     P_LEN + GEN, B))

    @jax.jit
    def step(p, c, t, i):
        logits, c = tfm.decode_step(p, c, t, i, cfg, ddist)
        return logits, jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None], c
    logits, toks, tok = [], [], None
    with mesh if ddist is not None else contextlib.nullcontext():
        for i in range(P_LEN + GEN - 1):
            t = jnp.asarray(prompt[:, i:i + 1]) if i < P_LEN else tok
            lg, tok, cache = step(p, cache, t, i)
            logits.append(np.asarray(lg))
            if i >= P_LEN - 1:
                toks.append(np.asarray(tok)[:, 0])
    rec.update(dec_logits=np.stack(logits), tokens=np.stack(toks, 1),
               cache=unstack(cfg, cache))
    out[name] = rec
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

def _patch(obj, name, wrap):
    orig = getattr(obj, name)
    setattr(obj, name, wrap(orig))
    return lambda: setattr(obj, name, orig)


def fault_gather(kinds, n, unsummed=False):
    """``gather_from`` of ``kinds`` wrong: the rank's own block standing
    in for every rank's, or (``unsummed``) the right forward with the
    rank's own slice of the cotangent as its backward (no reduce-scatter)."""
    def wrap(orig):
        def gather(x, group, dim=-1, kind="all_gather", reduce_bwd=False):
            if kind not in kinds:
                return orig(x, group, dim, kind, reduce_bwd)
            if unsummed:
                return orig(x, group, dim, kind, False)
            orig(x, group, dim, kind, reduce_bwd)       # every rank joins
            return torch.cat([x] * n, dim)
        return gather
    return wrap


def _dist(mesh_shape, cfg, kind, shape):
    from repro_torch import sharding
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_dist
    rules = rules_of(kind, sharding)
    mesh = make_host_mesh(*mesh_shape)
    if rules is None:
        return make_dist(mesh, cfg, shape)
    return sharding.DistContext(mesh, rules)


def _serve(cfg, dist, params, prompt):
    """JAX's serve loop through ``make_serve_step``: (every step's whole
    logits, the greedy tokens, the cache blocks)."""
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import transformer as tfm
    logits = []
    orig = tfm.decode_step

    def keep(*a, **kw):
        out = orig(*a, **kw)
        logits.append(out[0])
        return out
    cache = tfm.init_cache(cfg, B, PROMPT + GEN, dtype=torch.float32,
                           device="cpu", dist=dist)
    step = make_serve_step(cfg, dist)
    toks, tok = [], None
    tfm.decode_step = keep
    try:
        for i in range(PROMPT + GEN - 1):
            tok, cache = step(params, cache, prompt[:, i:i + 1]
                              if i < PROMPT else tok, i)
            if i >= PROMPT - 1:
                toks.append(tok[:, 0])
    finally:
        tfm.decode_step = orig
    return (torch.stack(logits).numpy(), torch.stack(toks, 1).numpy(),
            cache)


def _cache_rel(cfg, dist, cache, want):
    from repro_torch.models import transformer as tfm
    worst = 0.0
    for kind, blocks, whole in zip(tfm.layer_kinds(cfg), cache, want):
        specs = tfm.cache_layer_specs(kind, cfg)
        for k, w in whole.items():
            ref = dist.placement(dist.resolve(specs[k]), w.shape).block(
                torch.tensor(w))
            assert tuple(blocks[k].shape) == tuple(ref.shape), k
            worst = max(worst, rel(ref.numpy(), blocks[k].numpy()))
    return worst


def _train(cfg, dist, whole, batch, opt_kw, ref):
    """The port's train step on the mesh against JAX's: (loss, gnorm,
    update, factored statistics) errors."""
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tfm
    from repro_torch.train import optim
    from repro_torch.train.tree import tree_leaves
    from test_torch_mesh_train import _adafactor_ref, _whole
    ocfg = optim.OptConfig(**opt_kw)
    params = dist.shard_params(whole, tfm.specs(cfg))
    init, _ = optim.OPTIMIZERS[ocfg.name]
    state = {"params": params, "opt": init(
        params, ocfg, stacks=tfm.param_stacks(cfg, params),
        specs=tfm.specs(cfg), dist=dist, shapes=tfm.param_shapes(cfg)),
        "step": torch.zeros((), dtype=torch.int32)}
    _, pl, _ = steps.train_state_specs(cfg, dist, ocfg)
    new, m = steps.make_train_step(cfg, ocfg, kv_chunk=KV_CHUNK,
                                   dist=dist)(state, batch)
    got = _whole(new["params"], pl["params"])
    want = tfm.params_from_jax(ref["new"], cfg, device="cpu")
    out = {"loss": rel(ref["loss"], float(m["loss"])),
           "gnorm": rel(ref["gnorm"], float(m["gnorm"])),
           "update": max(rel((w - p0).numpy(), (g - p0).numpy())
                         for g, w, p0 in zip(tree_leaves(got),
                                             tree_leaves(want),
                                             tree_leaves(whole)))}
    if ocfg.name == "adafactor":
        want_f = _adafactor_ref(ref["opt"], cfg)
        got_f = _whole(new["opt"]["f"], pl["opt"]["f"])
        out["factored"] = max(rel(want_f[n][k].numpy(), got_f[n][k].numpy())
                              for n in want_f for k in want_f[n])
    return out


def _case(rank, case, ref):
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import comm
    from repro_torch.models import transformer as tfm
    name, arch, mesh_shape, kind, opt_kw, over = case
    cfg = dataclasses.replace(registry.get_reduced(arch), **over)
    whole = tfm.params_from_jax(ref["params"], cfg, device="cpu")
    batch = {k: torch.from_numpy(v.astype(np.int64))
             for k, v in ref["batch"].items()}
    dist = _dist(mesh_shape, cfg, kind, ShapeConfig("t", "train", S, B))
    ddist = _dist(mesh_shape, cfg, kind, ShapeConfig("d", "decode",
                                                      PROMPT + GEN, B))
    params = dist.shard_params(whole, tfm.specs(cfg))

    def prefill():
        return tfm.gather_logits(tfm.forward(
            params, {"inputs": batch["inputs"]}, cfg, dist,
            kv_chunk=KV_CHUNK, remat=False), cfg, dist).numpy()
    comm.traffic_reset()
    out = {"rules": dict(dist.rules), "prefill": rel(ref["logits"],
                                                     prefill()),
           "traffic": sorted(comm.traffic())}
    logits, toks, cache = _serve(cfg, ddist, ddist.shard_params(
        whole, tfm.specs(cfg)), batch["inputs"][:, :PROMPT])
    out.update(decode=rel(ref["dec_logits"], logits),
               tokens=bool(np.array_equal(toks, ref["tokens"])),
               cache=_cache_rel(cfg, ddist, cache, ref["cache"]))
    if opt_kw is not None:
        out["train"] = _train(cfg, dist, whole, batch, opt_kw, ref)
    # ---- the planted faults ----------------------------------------------
    n = mesh_shape[1]
    if name == "gemma3_cut":
        undo = _patch(comm, "gather_from",
                      fault_gather({"q_head_gather"}, n, unsummed=True))
        try:
            out["planted"] = _train(cfg, dist, whole, batch, opt_kw,
                                    ref)["update"]
        finally:
            undo()
    planted = {"dbrx_effn": ("expert_ffn_gather", mesh_shape[0]),
               "dbrx_effn_ep": ("expert_ffn_gather", mesh_shape[0]),
               "mamba_tp": ("ssd_in_gather", n)}.get(name)
    if planted is not None:
        undo = _patch(comm, "gather_from", fault_gather({planted[0]},
                                                        planted[1]))
        try:
            out["planted"] = rel(ref["logits"], prefill())
        finally:
            undo()
    return out


def _rank(rank, world, dev, path):
    torch.set_num_threads(1)
    warnings.simplefilter("ignore", RuntimeWarning)
    with open(path, "rb") as f:
        refs = pickle.load(f)
    return {case[0]: _case(rank, case, refs[case[0]]) for case in CASES}


# ---------------------------------------------------------------------------
# the JAX side and the launch
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def launch(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cuts")
    here = os.path.dirname(os.path.abspath(__file__))
    with open(tmp / "conf.pkl", "wb") as f:
        pickle.dump({"cases": CASES, "B": B, "S": S, "kv": KV_CHUNK,
                     "prompt": PROMPT, "gen": GEN, "tests_dir": here}, f)
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(here, "..", "src"))
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(JAX_REFS),
                        str(tmp / "conf.pkl"), str(tmp / "refs.pkl")],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    with open(tmp / "refs.pkl", "rb") as f:
        refs = pickle.load(f)
    ranks = run_spmd(_rank, WORLD, str(tmp / "refs.pkl"), device="cpu",
                     timeout=600)
    return {"ranks": ranks, "refs": refs}


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_prefill_and_decode_match_jax(launch, case):
    """The prefill's logits, every decode step's logits and each rank's
    cache blocks within TOL_F32 of JAX's; the greedy tokens equal; the
    rules JAX's own."""
    for res in launch["ranks"]:
        rec = res[case]
        assert rec["rules"] == launch["refs"][case]["rules"]
        assert rec["prefill"] < TOL_F32, rec
        assert rec["decode"] < TOL_F32 and rec["cache"] < TOL_F32, rec
        assert rec["tokens"], rec


@pytest.mark.parametrize("case", [c[0] for c in CASES if c[4]])
def test_train_step_matches_jax(launch, case):
    """The loss, the gnorm and every update (and Adafactor's factored
    statistics over a leaf split on 'expert_ffn') against JAX's mesh train
    step."""
    for res in launch["ranks"]:
        tr = res[case]["train"]
        assert tr["loss"] < TOL_LOSS and tr["gnorm"] < TOL_GNORM, tr
        assert tr["update"] < TOL_GRAD, tr
        assert tr.get("factored", 0.0) < TOL_GRAD, tr


def test_the_cuts_take_their_collectives(launch):
    """A cut head gathers q (and the k/v projection), the hidden blocks
    are gathered over 'data', the SSD's in-projection and weights over
    the heads' group."""
    for res in launch["ranks"]:
        for case in ("gemma3_cut", "rg_cut"):
            assert {"q_head_gather", "kv_gather"} <= set(
                res[case]["traffic"]), case
        assert "expert_ffn_gather" in res["dbrx_effn"]["traffic"]
        assert {"expert_ffn_gather", "ep_psum"} <= set(
            res["dbrx_effn_ep"]["traffic"])
        assert {"ssd_in_gather", "ssd_weight_gather",
                "ssd_all_reduce"} <= set(res["mamba_tp"]["traffic"])


@pytest.mark.parametrize("case,limit", [("gemma3_cut", TOL_GRAD),
                                        ("dbrx_effn", TOL_F32),
                                        ("dbrx_effn_ep", TOL_F32),
                                        ("mamba_tp", TOL_F32)])
def test_planted_faults_exceed_the_tolerance(launch, case, limit):
    """The cut head's gather with its rank's own cotangent slice as the
    backward (gemma3's update), the hidden blocks left ungathered (dbrx's
    logits), the in-projection's gather skipped (mamba2's logits)."""
    assert max(r[case]["planted"] for r in launch["ranks"]) > limit


def test_rules_that_cut():
    """The cuts these cases take, on a duck-typed mesh's last rank: half
    a head of gemma3 on (1, 4), mamba2's in-projection split inside its x
    segment, half of dbrx's expert hidden dim a rank."""
    from repro_torch import sharding
    from repro_torch.configs import registry
    from repro_torch.layers import attention, moe

    class Mesh:
        mesh_dim_names = ("data", "model")

        def __init__(self, shape):
            self.shape = shape

        def get_coordinate(self):
            return [n - 1 for n in self.shape]

        def get_group(self, axis):
            return axis
    cfg = registry.get_reduced("gemma3-1b")
    dist = sharding.DistContext(Mesh((1, 4)))
    hd = attention._local_heads(dist, cfg.num_heads, cfg.num_kv_heads,
                                cfg.head_dim)
    assert hd.cut and hd.kv_gather
    assert hd.cols == (48, 64) and hd.heads == (1, 2) and hd.kv == (0, 1)
    m = registry.get_reduced("mamba2-130m")
    dist = sharding.DistContext(Mesh((2, 2)))
    width = 2 * m.d_inner + 2 * m.ssm_groups * m.ssm_state + m.ssm_heads
    assert width == 290 and dist.span("model", width) == (145, 290)
    d = registry.get_reduced("dbrx-132b")
    dist = sharding.DistContext(Mesh((2, 2)), rules_of("expert_ffn",
                                                       sharding))
    assert dist.block_shape((d.n_experts, d.d_model, d.d_expert),
                            sharding.Spec("expert", None, "expert_ffn")) \
        == (d.n_experts // 2, d.d_model, d.d_expert // 2)
    # the EP case drops tokens: a data rank's prefill tokens choose more
    # expert slots than the experts' capacities hold
    ep = dataclasses.replace(d, moe_impl="ep", capacity_factor=EP_CF)
    t_l = B // 2 * S
    assert moe._capacity(t_l, ep) * ep.n_experts < t_l * ep.top_k
