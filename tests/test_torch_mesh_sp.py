"""Sequence parallelism and row-parallel superpacks across four gloo
processes on the CPU, held to the JAX package on the same numpy weights:

- ``make_dist(..., seq_parallel=True)`` on (2, 2) (the residual stream's
  S over 'model' between layers) for llama3.2-1b, gemma3-1b, dbrx-132b
  and seamless-m4t-large-v2 reduced: the logits, the loss and every
  gradient against JAX's ``forward`` and ``value_and_grad(loss_fn)`` with
  the same rules on its own (2, 2) mesh;
- JAX's row-parallel rules (``conv_taps='model', conv_out=None``) on
  (2, 2) for the reduced DCGAN and cGAN generators (examples/
  train_gan.py's DCGAN widths, the cGAN's at a quarter) and the tiny
  SegNet, f32 and int8: the outputs and
  the superpack gradients (a quantized superpack's scale column) against
  JAX's on the same rules, and one row-parallel site of each model
  against the f64 oracle within ``ulp_bound`` (a sum split over the
  ranks stays inside γ_n, which holds for any summation order).

Planted faults, each read past its tolerance: a reduce-scatter of S
replaced by the rank's slice of its own partial, one rank's row-block
partial left out of the sum.
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
TOL_F32 = 2e-5       # f32 logits, loss and image outputs, relative to
                     # max|ref| (tests/test_torch_mesh_forward.py's)
TOL_GRAD = 1e-3      # f32 gradients, relative to a leaf's max
                     # (tests/test_torch_mesh_train.py's)
B, S, SRC, KV_CHUNK = 4, 16, 8, 4
SP_ARCHS = ("llama3.2-1b", "gemma3-1b", "dbrx-132b",
            "seamless-m4t-large-v2")
# the reduced generators (in_hw, in_c, out_c, k, s): examples/train_gan.py's
# DCGAN, and the cGAN's k4 s2 layers at a quarter of its widths
DCGAN_SMALL = ((4, 128, 64, 5, 2), (8, 64, 32, 5, 2), (16, 32, 3, 5, 2))
CGAN_SMALL = ((8, 64, 32, 4, 2), (16, 32, 3, 4, 2))
RP_CASES = [(m, wd) for m in ("dcgan", "cgan", "segnet")
            for wd in ("float32", "int8")]
IMG_BATCH = 2

JAX_REFS = r"""
import dataclasses, pickle, sys, types
import jax, jax.numpy as jnp, numpy as np
from repro.configs import registry
from repro.configs.base import ShapeConfig
from repro.core.plan import QuantizedSuperpack
from repro.launch import steps as jsteps
from repro.launch.mesh import make_host_mesh
from repro.models import gan, segnet, transformer as tfm
from repro.sharding import DEFAULT_RULES, DistContext

with open(sys.argv[1], "rb") as f:
    conf = pickle.load(f)
B, S, SRC, KV = conf["B"], conf["S"], conf["src"], conf["kv"]
np_tree = lambda t: jax.tree.map(np.asarray, t)
mesh = make_host_mesh(2, 2)
out = {"sp": {}, "rp": {}}
for arch in conf["sp_archs"]:
    cfg = registry.get_reduced(arch)
    rng = np.random.default_rng(len(arch))
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
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    dist = jsteps.make_dist(mesh, cfg, ShapeConfig("t", "train", S, B),
                            seq_parallel=True)
    def loss_fn(p, b):
        # tfm.loss_fn's arithmetic, its logits kept: one compile for both
        logits = tfm.forward(p, b, cfg, dist, kv_chunk=KV)
        lse = jax.nn.logsumexp(logits, axis=-1)
        gold = jnp.take_along_axis(logits, b["targets"][..., None],
                                   axis=-1)[..., 0]
        return (lse - gold).mean(), logits
    with mesh:
        (loss, logits), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(p, jb)
    out["sp"][arch] = {"params": np_tree(p), "batch": batch,
                       "logits": np.asarray(logits), "loss": float(loss),
                       "grads": np_tree(grads), "rules": dict(dist.rules)}

def model(name, wd):
    if name in ("dcgan", "cgan"):
        cfg = dataclasses.replace(gan.CGAN if name == "cgan" else gan.DCGAN,
                                  name=name + "-small", wdtype=wd,
                                  layers=tuple(gan.DeconvLayer(*l)
                                               for l in conf[name]))
    else:
        cfg = dataclasses.replace(segnet.SEGNET_TINY, wdtype=wd)
        return (lambda p, x: segnet.segnet_apply(p, x, cfg),
                segnet.segnet_init(jax.random.PRNGKey(0), cfg)[1])
    return (lambda p, x: gan.generator_apply(p, x, cfg),
            gan.generator_init(jax.random.PRNGKey(0), cfg)[1])

rp = DistContext(mesh, rules=dict(DEFAULT_RULES, conv_taps="model",
                                  conv_out=None))
for (name, wd), (np_p, x, cot) in conf["rp"].items():
    fn, specs = model(name, wd)
    ints = {k: jnp.asarray(v.q) for k, v in np_p.items()
            if isinstance(v, types.SimpleNamespace)}
    floats = {k: jnp.asarray(v.scale if isinstance(v, types.SimpleNamespace)
                             else v) for k, v in np_p.items()}

    def params(fl):
        return {k: QuantizedSuperpack(ints[k], fl[k]) if k in ints else fl[k]
                for k in fl}

    def loss(fl, x):
        y = fn(params(fl), x)
        return jnp.sum(y * cot), y
    placed = rp.shard_params(params(floats), specs)
    fl = {k: v.scale if k in ints else v for k, v in placed.items()}
    with mesh:
        (_, y), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            fl, jnp.asarray(x))
    out["rp"][(name, wd)] = (np.asarray(y), np_tree(g))
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f, protocol=5)
"""


def rel(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _patch(obj, name, wrap):
    orig = getattr(obj, name)
    setattr(obj, name, wrap(orig))
    return lambda: setattr(obj, name, orig)


# ---------------------------------------------------------------------------
# sequence parallelism
# ---------------------------------------------------------------------------

def fault_slice(rank):
    """Rank 1 keeps its slice of its own partial where S is
    reduce-scattered (the collective still runs)."""
    def wrap(orig):
        def rs(x, group, dim=1, kind="reduce_scatter_to"):
            y = orig(x, group, dim, kind)
            if rank != 1 or kind != "sp_reduce_scatter":
                return y
            i = torch.distributed.get_rank(group)
            return x.narrow(dim, i * y.shape[dim], y.shape[dim])
        return rs
    return wrap


def _sp_case(rank, arch, ref):
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import comm
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.train.checkpoint import _placement_leaves
    from repro_torch.train.tree import tree_leaves
    cfg = registry.get_reduced(arch)
    dist = steps.make_dist(make_host_mesh(2, 2), cfg,
                           ShapeConfig("t", "train", S, B),
                           seq_parallel=True)
    whole = tfm.params_from_jax(ref["params"], cfg, device="cpu")
    params = dist.shard_params(whole, tfm.specs(cfg))
    batch = {k: torch.from_numpy(v if v.dtype == np.float32
                                 else v.astype(np.int64))
             for k, v in ref["batch"].items()}

    def logits():
        return tfm.gather_logits(tfm.forward(params, batch, cfg, dist,
                                             kv_chunk=KV_CHUNK), cfg,
                                 dist).numpy()
    comm.traffic_reset()
    out = {"rules": dict(dist.rules), "logits": rel(ref["logits"],
                                                    logits()),
           "traffic": comm.traffic()}
    loss, grads = steps.loss_and_grads(cfg, params, batch,
                                       kv_chunk=KV_CHUNK, dist=dist)
    out["loss"] = rel(ref["loss"], float(loss))
    _, pl, _ = steps.train_state_specs(cfg, dist, steps.opt_config_for(cfg))
    got = [p.gather(t) for t, p in zip(tree_leaves(grads),
                                       _placement_leaves(pl["params"]))]
    want = tree_leaves(tfm.params_from_jax(ref["grads"], cfg, device="cpu"))
    out["grads"] = max(rel(w.numpy(), g.numpy()) for g, w in zip(got, want))
    # the residual stream a rank holds between layers
    seen = []
    orig = tfm.apply_layer

    def keep(p, x, *a, **kw):
        seen.append(tuple(x.shape))
        return orig(p, x, *a, **kw)
    tfm.apply_layer = keep
    try:
        with torch.no_grad():
            logits()
    finally:
        tfm.apply_layer = orig
    out["stream"] = seen[-1]                    # a decoder layer's
    undo = _patch(comm, "reduce_scatter_to", fault_slice(rank))
    try:
        out["planted"] = rel(ref["logits"], logits())
    finally:
        undo()
    return out


# ---------------------------------------------------------------------------
# row-parallel superpacks
# ---------------------------------------------------------------------------

def _rp_model(name, wd):
    """(apply(params, x, dist), specs, plans, whole params) of a model."""
    from repro_torch.models import gan, segnet
    if name == "segnet":
        cfg = dataclasses.replace(segnet.SEGNET_TINY, wdtype=wd)
        return ((lambda p, x, dist: segnet.segnet_apply(p, x, cfg)),
                segnet.segnet_specs(cfg), segnet.segnet_plans(cfg),
                lambda: segnet.segnet_init(5, cfg, device="cpu"))
    cfg = dataclasses.replace(
        gan.CGAN if name == "cgan" else gan.DCGAN, name=name + "-small",
        wdtype=wd, layers=tuple(gan.DeconvLayer(*l) for l in (
            CGAN_SMALL if name == "cgan" else DCGAN_SMALL)))
    return ((lambda p, x, dist: gan.generator_apply(p, x, cfg, dist=dist)),
            gan.generator_specs(cfg), gan.generator_plans(cfg),
            lambda: gan.generator_init(3, cfg, device="cpu"))


def fault_unsummed(rank):
    def wrap(orig):
        def reduce_from(x, group, kind="all_reduce"):
            y = orig(x, group, kind)
            return x if rank == 1 and kind == "rows_all_reduce" else y
        return reduce_from
    return wrap


def _rp_case(rank, name, wd, np_p, x, cot, ref):
    from repro_torch.core import comm
    from repro_torch.core import reference as tref
    from repro_torch.core.plan import QuantizedSuperpack, RowSuperpack
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import DEFAULT_RULES, DistContext
    apply, specs, plans, _ = _rp_model(name, wd)
    whole = {k: QuantizedSuperpack(torch.from_numpy(v.q),
                                   torch.from_numpy(v.scale))
             if isinstance(v, types.SimpleNamespace) else torch.from_numpy(v)
             for k, v in np_p.items()}
    dist = DistContext(make_host_mesh(2, 2), rules=dict(
        DEFAULT_RULES, conv_taps="model", conv_out=None))
    p = dist.shard_params(whole, specs)
    rows = sorted(k for k, v in p.items() if isinstance(v, RowSuperpack))
    leaves = {k: (p[k].block.scale if wd == "int8" else p[k].block)
              .requires_grad_() for k in rows}
    xt = torch.from_numpy(x)
    y = apply(p, xt, dist)
    (y * torch.from_numpy(cot)).sum().backward()
    want_y, want_g = ref
    out = {"rows": rows, "out": rel(want_y, y.detach().numpy()),
           "grads": max(rel(want_g[k][slice(*p[k].rows)],
                            leaves[k].grad.numpy()) for k in rows)}
    # the first row-parallel site against the f64 oracle
    k = rows[0]
    plan = plans[int(k.lstrip("dcw"))]
    spec = plan.spec
    g = torch.Generator().manual_seed(11)
    xs = torch.randn((IMG_BATCH, *spec.in_hw, spec.in_c), generator=g)
    with torch.no_grad():
        ys = plan.apply(xs, p[k])
    kern = plan.unpack(whole[k]).double()
    if spec.kind == "transposed":
        y64, amax = tref.conv_oracle_f64(tref.zero_insert(xs, spec.strides),
                                         kern, padding=spec.padding)
    else:
        y64, amax = tref.conv_oracle_f64(xs, kern, strides=spec.strides,
                                         padding=spec.padding)
    bound = tref.ulp_bound(y64, amax, kern.shape[0] * kern.shape[1]
                           * spec.in_c)
    out["ulp_excess"] = float((ys.double() - y64).abs().sub(bound).max())
    out["rows_of"] = (p[k].rows, p[k].total)
    undo = _patch(comm, "reduce_from", fault_unsummed(rank))
    try:
        with torch.no_grad():
            out["planted"] = rel(want_y, apply(p, xt, dist).numpy())
    finally:
        undo()
    return out


def _rank(rank, world, dev, path):
    torch.set_num_threads(1)
    warnings.simplefilter("ignore", RuntimeWarning)
    with open(path, "rb") as f:
        conf, refs = pickle.load(f)
    out = {arch: _sp_case(rank, arch, refs["sp"][arch]) for arch in SP_ARCHS}
    for (name, wd), (np_p, x, cot) in conf["rp"].items():
        out[(name, wd)] = _rp_case(rank, name, wd, np_p, x, cot,
                                   refs["rp"][(name, wd)])
    return out


def _rp_inputs():
    """The port's seeded image weights (numpy; int8 superpacks as codes and
    scales), inputs and output cotangents, handed to both packages."""
    from repro_torch.core.plan import QuantizedSuperpack
    rng = np.random.default_rng(9)
    out = {}
    for name, wd in RP_CASES:
        apply, _, plans, init = _rp_model(name, wd)
        p = init()
        if name == "segnet":
            x = rng.standard_normal((IMG_BATCH, 32, 32, 3))
        else:
            x = rng.standard_normal((IMG_BATCH, p["proj"].shape[0]))
        with torch.no_grad():
            y = apply(p, torch.from_numpy(x.astype(np.float32)), None)
        out[(name, wd)] = ({k: types.SimpleNamespace(
            q=v.q.numpy(), scale=v.scale.numpy())
            if isinstance(v, QuantizedSuperpack) else v.numpy()
            for k, v in p.items()}, x.astype(np.float32),
            rng.standard_normal(tuple(y.shape)).astype(np.float32))
    return out


@pytest.fixture(scope="module")
def launch(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp")
    conf = {"sp_archs": SP_ARCHS, "B": B, "S": S, "src": SRC,
            "kv": KV_CHUNK, "dcgan": DCGAN_SMALL, "cgan": CGAN_SMALL,
            "rp": _rp_inputs()}
    with open(tmp / "conf.pkl", "wb") as f:
        pickle.dump(conf, f)
    here = os.path.dirname(os.path.abspath(__file__))
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
    with open(tmp / "both.pkl", "wb") as f:
        pickle.dump((conf, refs), f)
    ranks = run_spmd(_rank, WORLD, str(tmp / "both.pkl"), device="cpu",
                     timeout=600)
    return {"ranks": ranks, "refs": refs}


@pytest.mark.parametrize("arch", SP_ARCHS)
def test_seq_parallel_matches_jax(launch, arch):
    """Logits within TOL_F32, the loss within TOL_F32 and every gradient
    within TOL_GRAD of JAX's under the same rules ('seq' on 'model'); the
    stream between layers holds S / 2 rows a rank; S is gathered on entry
    and reduce-scattered at the exit of the tensor-parallel blocks."""
    for res in launch["ranks"]:
        rec = res[arch]
        assert rec["rules"] == launch["refs"]["sp"][arch]["rules"]
        assert rec["rules"]["seq"] == "model"
        assert rec["logits"] < TOL_F32 and rec["loss"] < TOL_F32, rec
        assert rec["grads"] < TOL_GRAD, rec
        assert rec["stream"][1] == S // 2, rec
        assert {"sp_gather", "sp_reduce_scatter"} <= set(rec["traffic"])
        assert rec["planted"] > TOL_F32, rec


@pytest.mark.parametrize("name,wd", RP_CASES)
def test_row_parallel_superpacks_match_jax(launch, name, wd):
    """Every superpack row-parallel (a ``RowSuperpack`` of half its rows:
    'model' has 2 ranks); the output within TOL_F32 of
    JAX's, the superpack (scale) gradients within TOL_GRAD, one site within
    the f64 oracle's ULP bound, one rank's partial left out past
    TOL_F32."""
    for res in launch["ranks"]:
        rec = res[(name, wd)]
        assert rec["rows"], rec
        (r0, r1), total = rec["rows_of"]
        assert r1 - r0 == total // 2
        assert rec["out"] < TOL_F32 and rec["grads"] < TOL_GRAD, rec
        assert rec["ulp_excess"] <= 0.0, rec
    assert max(r[(name, wd)]["planted"] for r in launch["ranks"]) > TOL_F32


def test_row_parallel_tiled_site_runs_the_tiled_rows():
    """A row-parallel site whose plan picks the tiled kernel C runs each
    row block through C's rows entry (its tiled rows plain version on the
    CPU); the blocks' partials summed (a group of one rank per block here)
    equal the whole superpack's tiled plain version within the f64
    bound."""
    from repro_torch.core import reference as tref
    from repro_torch.core.plan import (ConvSpec, RowSuperpack, pad_or_crop,
                                       plan_conv)
    from repro_torch.kernels import untangled_conv as uc
    plan = plan_conv(ConvSpec(kind="conv", in_hw=(8, 8), in_c=4, out_c=4,
                              kernel_hw=(3, 3), strides=(1, 1),
                              padding=((1, 1), (1, 1)), backend="torch"))
    tiled = plan.with_routes(tuple(dataclasses.replace(
        r, path="cuda", sp_tiles=(4, 4)) for r in plan.routes))
    g = torch.Generator().manual_seed(3)
    x = torch.randn((1, 8, 8, 4), generator=g)
    w = torch.randn((36, 4), generator=g)
    seen = []
    orig = uc.untangled_conv2d_superpack_tiled_rows_ref

    def rows_ref(*a, **kw):
        seen.append(kw["rows"])
        return orig(*a, **kw)
    uc.untangled_conv2d_superpack_tiled_rows_ref = rows_ref
    try:
        with torch.no_grad():
            y = sum(tiled.apply(x, RowSuperpack(w[r0:r1], None, i, 2,
                                                (r0, r1), 36))
                    for i, (r0, r1) in enumerate(((0, 18), (18, 36))))
    finally:
        uc.untangled_conv2d_superpack_tiled_rows_ref = orig
    assert seen == [(0, 18), (18, 36)]
    whole = uc.untangled_conv2d_superpack_tiled_ref(
        pad_or_crop(x, plan.spec.padding), w, taps_hw=(3, 3),
        sp_tiles=(4, 4))
    y64, amax = tref.conv_oracle_f64(x, w.reshape(3, 3, 4, 4).double(),
                                     padding=plan.spec.padding)
    bound = tref.ulp_bound(y64, amax, 36)
    assert ((y.double() - y64).abs() <= bound).all()
    assert ((whole.double() - y64).abs() <= bound).all()


@pytest.mark.parametrize("sp_tiles", [None, (2, 2)],
                         ids=["whole_plane", "tiled"])
def test_row_block_plain_versions_sum_to_the_whole(sp_tiles):
    """The row-block entries' plain versions (kernels A and B on rows [r0,
    r1); with ``sp_tiles`` their tiled forms D and C), f32 and int8,
    summed over blocks that cut taps and span phases, equal the whole
    superpack's plain version within the f64 bound."""
    from repro_torch.core import reference as tref
    from repro_torch.core.plan import (ConvSpec, _global_plane, pad_or_crop,
                                       plan_conv)
    from repro_torch.kernels import untangled_conv as uc
    from repro_torch.runtime.compress import quantize_int8_rows
    g = torch.Generator().manual_seed(5)
    for kind in ("transposed", "conv"):
        pad = (2, 3) if kind == "transposed" else (2, 2)
        spec = ConvSpec(kind=kind, in_hw=(6, 6), in_c=12, out_c=8,
                        kernel_hw=(5, 5), strides=(2, 2),
                        padding=(pad, pad), backend="torch")
        plan = plan_conv(spec)
        x = torch.randn((2, 6, 6, 12), generator=g)
        kern = torch.randn((5, 5, 12, 8), generator=g)
        w = plan.pack(kern)
        total = w.shape[0]
        for int8 in (False, True):
            wq, sc = quantize_int8_rows(w) if int8 else (w, None)
            parts = []
            for r0, r1 in ((0, 7), (7, 150), (150, total)):
                kw = {} if sc is None else {"scales": sc[r0:r1]}
                if kind == "transposed":
                    parts.append(uc.untangled_deconv2d(
                        _global_plane(plan, x), wq[r0:r1],
                        phases=plan.phases, out_hw=plan.out_hw,
                        strides=spec.strides, sum_uv=plan.sum_uv,
                        rows=(r0, r1), sp_tiles=sp_tiles, **kw))
                else:
                    parts.append(uc.untangled_conv2d_superpack(
                        pad_or_crop(x, spec.padding), wq[r0:r1],
                        taps_hw=(5, 5), strides=(2, 2), rows=(r0, r1),
                        sp_tiles=sp_tiles, **kw))
            kd = plan.unpack(w if sc is None else
                             uc.dequantize_int8(wq, sc)).double()
            if kind == "transposed":
                y64, amax = tref.conv_oracle_f64(
                    tref.zero_insert(x, (2, 2)), kd, padding=spec.padding)
            else:
                y64, amax = tref.conv_oracle_f64(x, kd, strides=(2, 2),
                                                 padding=spec.padding)
            bound = tref.ulp_bound(y64, amax, 25 * 12)
            assert ((sum(parts).double() - y64).abs() <= bound).all()
