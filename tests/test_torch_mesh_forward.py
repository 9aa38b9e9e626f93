"""The port's forward on a (data, model) mesh across gloo processes on the
CPU, held to the JAX package on the same numpy weights and inputs.

The JAX references are computed once, in one subprocess with four forced
host devices (``XLA_FLAGS=--xla_force_host_platform_device_count=4``, as
``tests/test_distributed.py`` runs JAX's mesh tests), and handed to one
launch of four ranks (``launch.mesh.run_spmd``) through one pickle file:

- reduced llama3.2-1b, dbrx-132b and deepseek-v3-671b in f32 on (2, 2)
  under ``make_dist``'s rules (llama also on (1, 4), where a k/v block cuts
  a kv head) against JAX's single-device ``forward``; dbrx with
  ``moe_impl="ep"`` and a ``capacity_factor`` that drops tokens against
  JAX's ``forward`` on its own 2x2 mesh (the all-to-all path); the
  prefill step's logits whole on every rank;
- both expert-parallel paths against JAX's ``moe_apply_ep`` and
  ``moe_apply_ep_a2a`` (bf16 as JAX's own tests run them, and f32), at a
  ``capacity_factor`` that drops tokens and one that does not, and the
  padded (2, 3) batch: a token dropped on one side and not the other is
  an O(1) error, far past the tolerance;
- the CGAN generator and the tiny SegNet served DP x TP through the
  image batcher against JAX's single-device forward, f32 and int8;
- the bytes every collective kind moves in a forward against the
  geometry's count;
- one gradient through each collective autograd Function against the
  single-rank gradient;
- the planted faults of the smoke's phase 3o, each read past its
  tolerance: one rank skips the row-parallel all-reduce, the all-to-all's
  return goes to the rotated rank, the psum-EP output stays unsummed on
  one rank, the channel gather comes back in reversed rank order.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
import types
import warnings

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import run_spmd

WORLD = 4
# f32 forwards: relative to max|ref| (f32 sums in another order, and the
# f32 all-reduce of the row-parallel partials)
TOL_F32 = 2e-5
# bf16 expert products (JAX's EP arithmetic): a few bf16 roundings
TOL_BF16 = 2e-2
# image serving: JAX's own DP x TP tolerance (tests/test_sharded_serving.py)
TOL_IMG = 2e-4
LM_ARCHS = ("llama3.2-1b", "dbrx-132b", "deepseek-v3-671b")
LM_BATCH = (4, 8)
# (name, path, (B, S), capacity factor: None = E/k, dtype)
EP_CASES = [
    ("psum_nodrop_bf16", "ep", (4, 8), None, "bfloat16"),
    ("psum_drop_f32", "ep", (4, 8), 1.0, "float32"),
    ("a2a_nodrop_bf16", "a2a", (4, 8), None, "bfloat16"),
    ("a2a_padded_nodrop_bf16", "a2a", (2, 3), None, "bfloat16"),
    ("a2a_padded_drop_f32", "a2a", (2, 3), 1.0, "float32"),
    ("a2a_drop_f32", "a2a", (4, 8), 1.0, "float32"),
]
IMG_CASES = [("cgan", "float32"), ("cgan", "int8"), ("segnet", "float32"),
             ("segnet", "int8")]
IMG_BATCH = 8

JAX_REFS = r"""
import dataclasses, pickle, sys, types
import jax, jax.numpy as jnp, numpy as np
from repro.configs import registry
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import make_dist
from repro.configs.base import ShapeConfig
from repro.layers import moe as moe_lib
from repro.models import gan, segnet, transformer as tfm
from repro.sharding import DEFAULT_RULES, DistContext

with open(sys.argv[1], "rb") as f:
    conf = pickle.load(f)

def np_tree(t):
    if hasattr(t, "q") and hasattr(t, "scale"):
        return types.SimpleNamespace(q=np.asarray(t.q),
                                     scale=np.asarray(t.scale))
    if isinstance(t, dict):
        return {k: np_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [np_tree(v) for v in t]
    return np.asarray(t)

out = {"lm": {}, "ep": {}, "img": {}}
mesh = make_host_mesh(data=2, model=2)
toks = conf["tokens"]
rng = np.random.default_rng(0)

def draw(cfg):
    # seeded normal weights in the shapes of JAX's f32 init (traced only:
    # drawing them with numpy skips init's compile)
    shapes = jax.eval_shape(lambda k: tfm.init(k, cfg, dtype=jnp.float32)[0],
                            jax.random.PRNGKey(0))
    return jax.tree.map(lambda s: jnp.asarray(
        rng.standard_normal(s.shape).astype(np.float32)
        * (0.5 if len(s.shape) < 3 else 0.1)), shapes)

for arch in conf["lm_archs"]:
    cfg = registry.get_reduced(arch)
    p = draw(cfg)
    logits = jax.jit(lambda p, b: tfm.forward(p, b, cfg, kv_chunk=4))(
        p, {"inputs": jnp.asarray(toks)})
    out["lm"][arch] = (np_tree(p), np.asarray(logits))
cfg = dataclasses.replace(registry.get_reduced("dbrx-132b"), moe_impl="ep",
                          capacity_factor=1.0)
p = draw(cfg)
dist = make_dist(mesh, cfg, ShapeConfig("p", "prefill", toks.shape[1],
                                        toks.shape[0]))
with mesh:
    logits = jax.jit(lambda p, b: tfm.forward(p, b, cfg, dist, kv_chunk=4))(
        p, {"inputs": jnp.asarray(toks)})
out["lm_ep"] = (np_tree(p), np.asarray(logits), dict(dist.rules))
for name, path, (b, s), cf, dt in conf["ep_cases"]:
    cfg = registry.get_reduced("dbrx-132b")
    cfg = dataclasses.replace(
        cfg, moe_impl="ep",
        capacity_factor=cfg.n_experts / cfg.top_k if cf is None else cf)
    p, _ = moe_lib.moe_init(jax.random.PRNGKey(2), cfg, dtype=jnp.dtype(dt))
    x = jax.random.normal(jax.random.PRNGKey(b * 10 + s), (b, s, cfg.d_model),
                          jnp.dtype(dt))
    rules = dict(DEFAULT_RULES); rules["batch"] = "data"
    if path == "a2a":
        rules["expert"] = ("data", "model")
    d = DistContext(mesh=mesh, rules=rules)
    fn = moe_lib.moe_apply_ep_a2a if path == "a2a" else moe_lib.moe_apply_ep
    with mesh:
        y = jax.jit(lambda p, x: fn(p, x, cfg, d))(p, x)
    out["ep"][name] = (np_tree(p), np.asarray(x.astype(jnp.float32)),
                       np.asarray(y.astype(jnp.float32)), cfg.capacity_factor)
from repro.core.plan import QuantizedSuperpack
for (model, wd), (np_p, x) in conf["img"].items():
    p = {k: QuantizedSuperpack(jnp.asarray(v.q), jnp.asarray(v.scale))
         if isinstance(v, types.SimpleNamespace) else jnp.asarray(v)
         for k, v in np_p.items()}
    if model == "cgan":
        cfg = dataclasses.replace(gan.CGAN, wdtype=wd)
        fn = lambda p, x: gan.generator_apply(p, x, cfg)
    else:
        cfg = dataclasses.replace(segnet.SEGNET_TINY, wdtype=wd)
        fn = lambda p, x: segnet.segnet_apply(p, x, cfg)
    out["img"][(model, wd)] = (np_p, x, np.asarray(jax.jit(fn)(
        p, jnp.asarray(x))))
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


def fault_unsummed(rank, planted):
    """Rank 1 keeps its own partial of the ``planted`` all-reduce (the
    collective still runs, so no rank waits)."""
    def wrap(orig):
        def reduce_from(x, group, kind="all_reduce"):
            y = orig(x, group, kind)
            return x if rank == 1 and kind == planted else y
        return reduce_from
    return wrap


def fault_rotated_return():
    """The second all-to-all of each MoE layer (the results' return)
    sends every block to the next rank's slot."""
    calls = [0]

    def wrap(orig):
        def a2a(x, group, kind="all_to_all"):
            calls[0] += 1
            if calls[0] % 2 == 0:
                x = torch.roll(x, x.shape[0] // torch.distributed
                               .get_world_size(group), dims=0)
            return orig(x, group, kind)
        return a2a
    return wrap


def fault_reversed_gather(n):
    """The channel gather's parts come back in reversed rank order."""
    def wrap(orig):
        def gather(x, group, dim=-1, kind="all_gather"):
            y = orig(x, group, dim, kind)
            if kind != "channel_gather":
                return y
            return torch.cat(list(reversed(torch.chunk(y, n, dim))), dim)
        return gather
    return wrap


def _lm_case(arch, mesh_shape, np_params, toks, ref, cfg=None):
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import comm
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_dist, make_prefill_step
    from repro_torch.models import transformer as tfm
    cfg = cfg or registry.get_reduced(arch)
    mesh = make_host_mesh(*mesh_shape)
    dist = make_dist(mesh, cfg, ShapeConfig("p", "prefill", toks.shape[1],
                                            toks.shape[0]))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        params = dist.shard_params(
            tfm.params_from_jax(np_params, cfg, device="cpu"),
            tfm.specs(cfg))
    batch = {"inputs": torch.from_numpy(toks)}
    comm.traffic_reset()
    with torch.no_grad():
        local = tfm.forward(params, batch, cfg, dist, kv_chunk=4)
    traffic = comm.traffic()
    whole = tfm.gather_logits(local, cfg, dist)
    pre = make_prefill_step(cfg, dist, kv_chunk=4)(params, batch)
    rec = {"sound": rel(ref, whole.numpy()),
           "prefill": rel(ref[:, -1], pre.numpy()),
           "local_shape": tuple(local.shape), "traffic": traffic,
           "rules": dict(dist.rules)}
    if arch == "llama3.2-1b" and mesh_shape == (2, 2):
        rank = torch.distributed.get_rank()
        undo = _patch(comm, "reduce_from",
                      fault_unsummed(rank, "row_parallel_all_reduce"))
        try:
            with torch.no_grad():
                bad = tfm.gather_logits(
                    tfm.forward(params, batch, cfg, dist, kv_chunk=4), cfg,
                    dist)
        finally:
            undo()
        rec["planted"] = rel(ref, bad.numpy())
    return rec


def _ep_case(case, np_p, x, ref, cf, planted):
    import torch.distributed as tdist
    from repro_torch.configs import registry
    from repro_torch.core import comm
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.layers import moe
    from repro_torch.sharding import DEFAULT_RULES, DistContext
    name, path, (b, s), _, dt = case
    dtype = getattr(torch, dt)
    cfg = dataclasses.replace(registry.get_reduced("dbrx-132b"),
                              moe_impl="ep", capacity_factor=cf)
    rules = dict(DEFAULT_RULES, batch="data")
    if path == "a2a":
        rules["expert"] = ("data", "model")
    dist = DistContext(make_host_mesh(2, 2), rules=rules)
    from repro_torch.models.transformer import _tensor
    p = dist.shard_params({k: _tensor(v, "cpu") for k, v in np_p.items()},
                          moe.moe_specs())
    xl, _ = dist.split_batch(torch.from_numpy(x).to(dtype))
    fn = moe.moe_apply_ep_a2a if path == "a2a" else moe.moe_apply_ep
    comm.traffic_reset()
    with torch.no_grad():
        y = fn(p, xl, cfg, dist)
    traffic = comm.traffic()
    i = dist.shard_of("data", b)[0]
    want = ref[i * b // 2:(i + 1) * b // 2]
    rec = {"sound": rel(want, y.float().numpy()), "traffic": traffic,
           "e_l": p["wi"].shape[0], "t_l": xl.shape[0] * s}
    if planted:
        rank = tdist.get_rank()
        undo = (_patch(comm, "all_to_all_fn", fault_rotated_return())
                if path == "a2a" else
                _patch(comm, "reduce_from", fault_unsummed(rank, "ep_psum")))
        try:
            with torch.no_grad():
                bad = fn(p, xl, cfg, dist)
        finally:
            undo()
        rec["planted"] = rel(want, bad.float().numpy())
    return rec


def _img_case(model, wd, np_p, x, ref):
    from repro_torch.core import comm
    from repro_torch.core.plan import TPSuperpack
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import gan, segnet
    from repro_torch.serving.image_batcher import (DynamicImageBatcher,
                                                   ImageRequest)
    from repro_torch.sharding import DistContext
    dist = DistContext(make_host_mesh(2, 2))
    if model == "cgan":
        cfg = dataclasses.replace(gan.CGAN, wdtype=wd)
        whole = gan.params_from_jax(np_p, cfg, device="cpu")
        specs = gan.generator_specs(cfg)

        def fn(p):
            return lambda z: gan.generator_apply(p, z, cfg, dist=dist)
    else:
        cfg = dataclasses.replace(segnet.SEGNET_TINY, wdtype=wd)
        whole = segnet.params_from_jax(np_p, cfg, device="cpu")
        specs = segnet.segnet_specs(cfg)

        def fn(p):
            return lambda xx: segnet.segnet_apply(p, xx, cfg)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        p = dist.shard_params(whole, specs)

    def serve(p):
        b = DynamicImageBatcher(fn(p), dist=dist, device="cpu")
        done = b.run([ImageRequest(rid=i, payload=x[i])
                      for i in range(len(x))])
        return np.stack([r.out for r in sorted(done, key=lambda r: r.rid)])

    comm.traffic_reset()
    got = serve(p)
    rec = {"sound": rel(ref, got), "traffic": comm.traffic(),
           "tp_sites": sorted(k for k, v in p.items()
                              if isinstance(v, TPSuperpack)),
           "graphed": False}
    undo = _patch(comm, "gather_from", fault_reversed_gather(2))
    try:
        rec["planted"] = rel(ref, serve(p))
    finally:
        undo()
    return rec


def _grad_case():
    """One gradient through each collective Function on the 'model'
    group of a (2, 2) mesh against the single-rank gradient."""
    import torch.distributed as tdist
    from repro_torch.core import comm
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import DistContext
    dist = DistContext(make_host_mesh(2, 2))
    group = dist.group("model")
    m = dist.shard_of("model", 2)[0]
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 4, generator=g)
    w1 = torch.randn(4, 6, generator=g)
    w2 = torch.randn(6, 5, generator=g)
    c = torch.randn(3, 5, generator=g)
    out = {}
    # copy_to + reduce_from: a column- then row-parallel MLP
    xs = x.clone().requires_grad_(True)
    loss = (xs @ w1 @ w2 * c).sum()
    (want,) = torch.autograd.grad(loss, xs)
    xt = x.clone().requires_grad_(True)
    h = comm.copy_to(xt, group) @ w1[:, 3 * m:3 * m + 3]
    y = comm.reduce_from(h @ w2[3 * m:3 * m + 3], group)
    (got,) = torch.autograd.grad((y * c).sum(), xt)
    out["copy_reduce"] = rel(want, got)
    # gather_from: every rank's columns, cotangent sliced back
    xt = x[:, 2 * m:2 * m + 2].clone().requires_grad_(True)
    cg = torch.randn(3, 4, generator=g)
    (got,) = torch.autograd.grad((comm.gather_from(xt, group, -1)
                                  * cg).sum(), xt)
    out["gather"] = rel(cg[:, 2 * m:2 * m + 2], got)
    # split_to: this rank's rows, the cotangent gathered back
    xt = x.clone().requires_grad_(True)
    cs = torch.randn(3, 4, generator=g)[:, 2 * m:2 * m + 2]
    (got,) = torch.autograd.grad((comm.split_to(xt, group, 1) * cs).sum(),
                                 xt)
    out["split"] = rel(comm.all_gather(cs, group, 1), got)
    # all_to_all: its own transpose
    world = tdist.get_world_size()
    wgroup = dist.group(("data", "model"))
    r = tdist.get_rank()
    xa = (torch.arange(8.0).reshape(4, 2) + 10 * r).requires_grad_(True)
    ca = torch.randn(4, 2, generator=torch.Generator().manual_seed(r))
    (got,) = torch.autograd.grad((comm.all_to_all_fn(xa, wgroup) * ca)
                                 .sum(), xa)
    want = comm.all_to_all(ca, wgroup)
    out["all_to_all"] = rel(want, got) if world == 4 else 0.0
    return out


def _rank(rank, world, dev, path):
    with open(path, "rb") as f:
        refs = pickle.load(f)
    toks = refs["tokens"]
    out = {"lm": {}, "ep": {}, "img": {}}
    for arch in LM_ARCHS:
        np_p, ref = refs["lm"][arch]
        out["lm"][(arch, (2, 2))] = _lm_case(arch, (2, 2), np_p, toks, ref)
    np_p, ref = refs["lm"]["llama3.2-1b"]
    out["lm"][("llama3.2-1b", (1, 4))] = _lm_case("llama3.2-1b", (1, 4),
                                                  np_p, toks, ref)
    from repro_torch.configs import registry
    np_p, ref, jrules = refs["lm_ep"]
    cfg = dataclasses.replace(registry.get_reduced("dbrx-132b"),
                              moe_impl="ep", capacity_factor=1.0)
    out["lm_ep"] = _lm_case("dbrx-132b", (2, 2), np_p, toks, ref, cfg=cfg)
    out["lm_ep"]["jax_rules"] = jrules
    for i, case in enumerate(EP_CASES):
        np_p, x, ref, cf = refs["ep"][case[0]]
        out["ep"][case[0]] = _ep_case(case, np_p, x, ref, cf,
                                      planted=case[0].endswith("drop_f32"))
    for model, wd in IMG_CASES:
        np_p, x, ref = refs["img"][(model, wd)]
        out["img"][(model, wd)] = _img_case(model, wd, np_p, x, ref)
    out["grad"] = _grad_case()
    return out


# ---------------------------------------------------------------------------
# the JAX side and the launch (here)
# ---------------------------------------------------------------------------

def _image_inputs():
    """The port's seeded image weights (numpy; int8 superpacks as their
    codes and scales) and inputs, handed to both packages (JAX's own
    init of the CGAN takes ~10 s on the CPU here)."""
    from repro_torch.core.plan import QuantizedSuperpack
    from repro_torch.models import gan, segnet
    rng = np.random.default_rng(7)
    out = {}
    for model, wd in IMG_CASES:
        if model == "cgan":
            cfg = dataclasses.replace(gan.CGAN, wdtype=wd)
            p = gan.generator_init(3, cfg, device="cpu")
            x = rng.standard_normal((IMG_BATCH, cfg.z_dim))
        else:
            cfg = dataclasses.replace(segnet.SEGNET_TINY, wdtype=wd)
            p = segnet.segnet_init(5, cfg, device="cpu")
            x = rng.standard_normal((IMG_BATCH, 32, 32, 3))
        out[(model, wd)] = ({k: types.SimpleNamespace(
            q=v.q.numpy(), scale=v.scale.numpy())
            if isinstance(v, QuantizedSuperpack) else v.numpy()
            for k, v in p.items()}, x.astype(np.float32))
    return out


@pytest.fixture(scope="module")
def launch(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 512, LM_BATCH).astype(np.int32)
    with open(tmp / "conf.pkl", "wb") as f:
        pickle.dump({"tokens": toks, "lm_archs": LM_ARCHS,
                     "ep_cases": EP_CASES, "img": _image_inputs()}, f)
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
    refs["tokens"] = toks.astype(np.int64)
    with open(tmp / "refs.pkl", "wb") as f:
        pickle.dump(refs, f, protocol=5)
    ranks = run_spmd(_rank, WORLD, str(tmp / "refs.pkl"), device="cpu",
                     timeout=240)
    return {"ranks": ranks, "refs": refs}


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_forward_on_2x2_matches_jax(launch, arch):
    """Every rank's whole logits and prefill logits within TOL_F32 of
    JAX's single-device forward; each rank held its rows and its vocab
    block of the logits (JAX's P(batch, None, 'vocab'))."""
    for res in launch["ranks"]:
        rec = res["lm"][(arch, (2, 2))]
        assert rec["sound"] < TOL_F32 and rec["prefill"] < TOL_F32, rec
        assert rec["local_shape"] == (LM_BATCH[0] // 2, LM_BATCH[1], 256)


def test_lm_forward_on_1x4_cuts_kv_heads(launch):
    """llama's k/v block of 8 columns (half a kv head) on (1, 4): the
    rank takes the kv head its q head reads from the gathered
    projection."""
    for res in launch["ranks"]:
        rec = res["lm"][("llama3.2-1b", (1, 4))]
        assert rec["sound"] < TOL_F32, rec
        assert rec["traffic"]["kv_gather"]["calls"] == 2 * 2


def test_lm_ep_forward_matches_jax_on_its_mesh(launch):
    """dbrx with moe_impl='ep' and capacity 1.0 (tokens dropped) under
    make_dist's rules (experts over ('data', 'model'): the all-to-all
    path) against JAX's forward on its own 2x2 mesh."""
    for res in launch["ranks"]:
        rec = res["lm_ep"]
        assert rec["rules"] == rec["jax_rules"]
        assert rec["rules"]["expert"] == ("data", "model")
        assert rec["sound"] < TOL_F32 and rec["prefill"] < TOL_F32, rec


@pytest.mark.parametrize("case", [c[0] for c in EP_CASES])
def test_ep_paths_match_jax(launch, case):
    tol = TOL_F32 if case.endswith("f32") else TOL_BF16
    for res in launch["ranks"]:
        rec = res["ep"][case]
        assert rec["sound"] < tol, (case, rec)


def test_ep_cases_drop_tokens(launch):
    """The dropping cases' capacity is below the tokens an expert gets:
    their match above is token for token."""
    from repro_torch.configs import registry
    cfg = registry.get_reduced("dbrx-132b")
    for name, path, (b, s), cf, _ in EP_CASES:
        t_l = b * s // (2 if path == "ep" else 4)
        if path == "a2a" and (b * s) % 4:
            t_l = -(-b * s // 4)
        cap = min(t_l, max(1, int(t_l * cfg.top_k
                                  * (cf or cfg.n_experts / cfg.top_k))
                           // cfg.n_experts))
        assert (cap < t_l) == (cf is not None), (name, cap, t_l)


@pytest.mark.parametrize("model,wd", IMG_CASES)
def test_image_serving_dp_tp_matches_jax(launch, model, wd):
    """Served over 'data' (each data rank's rows) with the superpacks
    split over 'model' (every site whose out-channels divide runs
    tensor-parallel) within JAX's DP x TP tolerance; a reversed channel
    gather is read past it."""
    want_tp = {"cgan": ["dc0"], "segnet": [f"w{i}" for i in range(9)]}
    for res in launch["ranks"]:
        rec = res["img"][(model, wd)]
        assert rec["sound"] < TOL_IMG, rec
        assert rec["planted"] > TOL_IMG, rec
        assert rec["tp_sites"] == want_tp[model]


def test_collective_bytes_match_the_geometry(launch):
    """Per rank and forward: the row-parallel all-reduce moves B_l·S·D f32
    a layer's attention and FFN, the vocab-parallel lookup B_l·S·D f32;
    the all-to-all EP moves (E, cap, D) twice a MoE layer; the image
    sites gather their local channels once a TP site."""
    from repro_torch.configs import registry
    b, s = LM_BATCH
    bl = b // 2
    for res in launch["ranks"]:
        cfg = registry.get_reduced("llama3.2-1b")
        tr = res["lm"][("llama3.2-1b", (2, 2))]["traffic"]
        act = bl * s * cfg.d_model * 4
        assert tr["row_parallel_all_reduce"] == {
            "calls": 2 * cfg.num_layers, "bytes": 2 * cfg.num_layers * act,
            "seconds": 0.0}
        assert tr["vocab_all_reduce"]["bytes"] == act
        assert set(tr) == {"row_parallel_all_reduce", "vocab_all_reduce"}
        for name, path, (b_, s_), cf, dt in EP_CASES:
            rec = res["ep"][name]
            cfg = registry.get_reduced("dbrx-132b")
            item = 4 if dt == "float32" else 2
            if path == "ep":
                assert rec["traffic"]["ep_psum"]["bytes"] == \
                    b_ // 2 * s_ * cfg.d_model * 4
                continue
            t_l = -(-b_ * s_ // 4)
            cfp = cfg.n_experts / cfg.top_k if cf is None else cf
            cap = min(t_l, max(1, int(t_l * cfg.top_k * cfp)
                               // cfg.n_experts))
            assert rec["traffic"]["ep_all_to_all"]["bytes"] == \
                2 * cfg.n_experts * cap * cfg.d_model * item
        rec = res["img"][("segnet", "float32")]
        from repro_torch.core.plan import BATCH_BUCKETS
        from repro_torch.models import segnet
        bucket = min(b for b in BATCH_BUCKETS if b >= IMG_BATCH)
        gathered = sum(
            (bucket // 2) * l.in_hw // l.stride * l.in_hw // l.stride
            * l.out_c // 2 * 4
            for l in segnet.SEGNET_TINY.layers if l.out_c % 2 == 0)
        assert rec["traffic"]["channel_gather"]["bytes"] == gathered


def test_collective_functions_carry_their_backward(launch):
    for res in launch["ranks"]:
        for name, err in res["grad"].items():
            assert err < 1e-6, (name, err)


def test_planted_faults_exceed_the_tolerances(launch):
    """One rank skipping the row-parallel all-reduce (every rank's
    logits: the vocab gather spreads it), the all-to-all's return sent to
    the rotated rank, the psum-EP output unsummed on rank 1."""
    for r, res in enumerate(launch["ranks"]):
        assert res["lm"][("llama3.2-1b", (2, 2))]["planted"] > TOL_F32
        assert res["ep"]["a2a_drop_f32"]["planted"] > TOL_BF16
        assert res["ep"]["a2a_padded_drop_f32"]["planted"] > TOL_BF16
        if r == 1:
            assert res["ep"]["psum_drop_f32"]["planted"] > TOL_BF16
