"""The last superpack splits across four gloo processes on the CPU, held to
the JAX package on the same numpy weights under the same rules on its own
mesh (JAX's answer is the whole conv's, as GSPMD's is):

- a weight split over the axis that carries the image batch ('conv_taps'
  or 'conv_out' on 'data', the batch split by ``DistContext.split_batch``)
  for the small DCGAN and cGAN generators of
  ``tests/test_torch_mesh_sp.py``, f32 and int8: each rank's rows of the
  output, and every block's gradient (summed over the batch axes its spec
  does not name, ``launch.steps.sum_over_batch``), against JAX's;
- rows and out-channels split together (a ``TPSuperpack`` of a
  ``RowSuperpack``): with one of the two axes carrying the batch, and with
  neither (``batch=()``: the local plan's row blocks);
- row blocks inside kernels C and D: a reduced U-Net (``UNET_TINY``'s
  widths at 32 px, the 'cuda' policy, whose plain versions run here, and
  the reference's tiled-verdict budget shrunk so that C and D tile the
  stem, down0, fuse0, the head and up0, as at 512 px) with 'conv_taps' on
  'model', f32 and int8, its sites requesting a (2, 2) device tiling with
  no spatial mesh bound (they run as ordinary row-parallel sites), and the
  2-D split on it;
- a split superpack at a plane-parallel site: the same U-Net on a bound
  (2, 2) spatial mesh (the plane-parallel floor lowered so that its sites
  split), the superpack rows on 'sp_h', then its out-channels on 'sp_w';
  the activations stay split between sites.

Planted faults, each read past its tolerance: the batch-axis gather
bypassed (the split sites run as before it: partial sums or channel
gathers over ranks that hold other rows), one rank's row-block partial
left out, the split weight's gather at a plane-parallel site with a
backward that keeps its own cotangent unsummed.
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
TOL_F32 = 2e-5       # f32 outputs, relative to max|ref|
                     # (tests/test_torch_mesh_forward.py's)
TOL_GRAD = 1e-3      # f32 gradients, relative to a leaf's max
                     # (tests/test_torch_mesh_train.py's)
DCGAN_SMALL = ((4, 128, 64, 5, 2), (8, 64, 32, 5, 2), (16, 32, 3, 5, 2))
CGAN_SMALL = ((8, 64, 32, 4, 2), (16, 32, 3, 4, 2))
GAN_B = 4
UNET_KW = dict(image_hw=32, base=8, time_dim=16)
UNET_B = 2
# the reference's tiled-verdict budget at which the 32 px U-Net tiles the
# five sites the 512 px one tiles (C: stem, down0, fuse0, head; D: up0)
TILED_BUDGET = 32 * 1024

GAN_RULES = {
    "taps_data": dict(conv_taps="data", conv_out=None),
    "out_data": dict(conv_taps=None, conv_out="data"),
    "taps_data_out_model": dict(conv_taps="data", conv_out="model"),
    "taps_model_out_data": dict(conv_taps="model", conv_out="data"),
    "both_no_batch": dict(conv_taps="data", conv_out="model", batch=()),
}
GAN_CASES = ([("dcgan", "float32", r) for r in GAN_RULES]
             + [("dcgan", "int8", r) for r in ("taps_data", "out_data",
                                               "taps_data_out_model")]
             + [("cgan", "float32", r) for r in ("taps_data", "out_data")])
# (mesh, rules, bound spatial mesh)
UNET_RULES = {
    "rows": ("host", dict(conv_taps="model", conv_out=None)),
    "both_no_batch": ("host", dict(conv_taps="data", conv_out="model",
                                   batch=())),
    "plane_rows": ("spatial", dict(conv_taps="sp_h", conv_out=None)),
    "plane_cols": ("spatial", dict(conv_taps=None, conv_out="sp_w")),
}
UNET_CASES = [("rows", "float32"), ("rows", "int8"),
              ("both_no_batch", "float32"), ("plane_rows", "float32"),
              ("plane_cols", "float32")]

JAX_REFS = r"""
import dataclasses, pickle, sys, types
import jax, jax.numpy as jnp, numpy as np
from repro.core import plan as jplan
from repro.core import spatial as jspatial
from repro.core.plan import QuantizedSuperpack
from repro.launch.mesh import make_host_mesh, make_spatial_mesh
from repro.models import gan, unet
from repro.sharding import DEFAULT_RULES, DistContext

with open(sys.argv[1], "rb") as f:
    conf = pickle.load(f)
# every plane clears the plane-parallel floor (the port's ranks lower
# theirs alike)
jplan._SPATIAL_MIN_BYTES = 0
np_tree = lambda t: jax.tree.map(np.asarray, t)


def placed_loss(fn, specs, np_p, mesh, rules):
    ints = {k: jnp.asarray(v.q) for k, v in np_p.items()
            if isinstance(v, types.SimpleNamespace)}
    floats = {k: jnp.asarray(v.scale if isinstance(v, types.SimpleNamespace)
                             else v) for k, v in np_p.items()}

    def params(fl):
        return {k: QuantizedSuperpack(ints[k], fl[k]) if k in ints else fl[k]
                for k in fl}
    dist = DistContext(mesh, rules=dict(DEFAULT_RULES, **rules))
    placed = dist.shard_params(params(floats), specs)
    fl = {k: v.scale if k in ints else v for k, v in placed.items()}

    def loss(fl, args, cot):
        y = fn(params(fl), *args)
        return jnp.sum(y * cot), y
    return fl, jax.jit(jax.value_and_grad(loss, has_aux=True))


out = {"gan": {}, "unet": {}}
host = make_host_mesh(2, 2)
SPECS = {}          # the spec trees do not depend on wdtype


def specs_of(init, cfg):
    # the spec tree init returns beside its params, traced only: no
    # weights drawn, nothing compiled
    box = {}

    def f(key):
        p, box["s"] = init(key, cfg)
        return p
    jax.eval_shape(f, jax.random.PRNGKey(0))
    return box["s"]


for (name, wd, rule), (np_p, z, cot) in conf["gan"].items():
    cfg = dataclasses.replace(gan.CGAN if name == "cgan" else gan.DCGAN,
                              name=name + "-small", wdtype=wd,
                              layers=tuple(gan.DeconvLayer(*l)
                                           for l in conf[name]))
    if name not in SPECS:
        SPECS[name] = specs_of(gan.generator_init, cfg)
    specs = SPECS[name]
    fl, step = placed_loss(lambda p, z: gan.generator_apply(p, z, cfg),
                           specs, np_p, host, conf["gan_rules"][rule])
    with host:
        (_, y), g = step(fl, (jnp.asarray(z),), jnp.asarray(cot))
    out["gan"][(name, wd, rule)] = (np.asarray(y), np_tree(g))
for (rule, wd), (np_p, x, t, cot) in conf["unet"].items():
    mesh_kind, rules = conf["unet_rules"][rule]
    cfg = unet.UNetConfig("unet-splits", wdtype=wd, spatial=(2, 2),
                          **conf["unet_kw"])
    if "unet" not in SPECS:
        SPECS["unet"] = specs_of(unet.unet_init, cfg)
    specs = SPECS["unet"]
    mesh = host if mesh_kind == "host" else make_spatial_mesh(2, 2)
    fl, step = placed_loss(lambda p, x, t: unet.unet_apply(p, x, t, cfg),
                           specs, np_p, mesh, rules)
    with mesh, jspatial.use_spatial_mesh(
            mesh if mesh_kind == "spatial" else None):
        (_, y), g = step(fl, (jnp.asarray(x), jnp.asarray(t)),
                         jnp.asarray(cot))
    out["unet"][(rule, wd)] = (np.asarray(y), np_tree(g))
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


def _gan_cfg(name, wd):
    from repro_torch.models import gan
    return dataclasses.replace(
        gan.CGAN if name == "cgan" else gan.DCGAN, name=name + "-small",
        wdtype=wd, layers=tuple(gan.DeconvLayer(*l) for l in (
            CGAN_SMALL if name == "cgan" else DCGAN_SMALL)))


def _unet_cfg(wd):
    from repro_torch.models import unet
    return unet.UNetConfig("unet-splits", backend="cuda", wdtype=wd,
                           spatial=(2, 2), **UNET_KW)


def _torch_params(np_p):
    from repro_torch.core.plan import QuantizedSuperpack
    return {k: QuantizedSuperpack(torch.from_numpy(v.q),
                                  torch.from_numpy(v.scale))
            if isinstance(v, types.SimpleNamespace) else torch.from_numpy(v)
            for k, v in np_p.items()}


def _leaves(p):
    """(params with every float leaf a fresh leaf tensor that requires
    grad: a block's dense buffer or its int8 scale rows, in place inside
    the split superpacks; {name: leaf})."""
    from repro_torch.core.plan import QuantizedSuperpack, map_block
    leaves = {}

    def fresh(name, v):
        if isinstance(v, QuantizedSuperpack):
            return QuantizedSuperpack(v.q, fresh(name, v.scale))
        leaves[name] = v.detach().clone().requires_grad_()
        return leaves[name]
    return {k: map_block(v, lambda b, k=k: fresh(k, b))
            for k, v in p.items()}, leaves


def _block_grads(dist, specs, leaves, want):
    """The worst leaf gradient against JAX's whole gradient's block (an
    int8 superpack: its scale column, split along the rows only), each
    rank's gradient summed over the batch axes its spec does not name."""
    from repro_torch.launch.steps import sum_over_batch
    from repro_torch.sharding import Spec
    names = sorted(leaves)
    resolved = []
    for k in names:
        r = tuple(dist.resolve(specs[k]))
        if want[k].ndim == 2 and want[k].shape[1] == 1 \
                and leaves[k].shape[-1] == 1:
            r = r[:1]                           # an int8 scale column
        # the axes that split the leaf: a dim they do not divide is whole
        resolved.append(Spec(*(e if d % dist.extent(e) == 0 else None
                               for d, e in zip(want[k].shape, r))))
    grads = sum_over_batch([leaves[k].grad for k in names], resolved, dist)
    return max(rel(dist._block(torch.from_numpy(want[k]), r).numpy(),
                   g.numpy()) for k, r, g in zip(names, resolved, grads))


def _gan_case(rank, name, wd, rule, np_p, z, cot, ref):
    from repro_torch import sharding
    from repro_torch.launch import faults
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import gan
    from repro_torch.sharding import DEFAULT_RULES, DistContext
    cfg = _gan_cfg(name, wd)
    specs = gan.generator_specs(cfg)
    dist = DistContext(make_host_mesh(2, 2),
                       rules=dict(DEFAULT_RULES, **GAN_RULES[rule]))
    whole = _torch_params(np_p)
    p, leaves = _leaves(dist.shard_params(whole, specs))
    zt, group = dist.split_batch(torch.from_numpy(z))
    lo = dist.span(dist.image_spec()[0], z.shape[0])[0] if group else 0
    rows = slice(lo, lo + zt.shape[0])
    y = gan.generator_apply(p, zt, cfg, dist=dist)
    (y * torch.from_numpy(cot[rows])).sum().backward()
    want_y, want_g = ref
    out = {"split": group is not None, "out": rel(want_y[rows],
                                                  y.detach().numpy()),
           "grads": _block_grads(dist, specs, leaves, want_g),
           "kinds": sorted(p[k].__class__.__name__ for k in p
                           if k.startswith("dc"))}
    undo = _patch(sharding.DistContext, "axes_of", faults.no_batch_axes)
    try:
        bad = dist.shard_params(whole, specs)
        with torch.no_grad():
            out["planted"] = rel(want_y[rows], gan.generator_apply(
                bad, zt, cfg, dist=dist).numpy())
    finally:
        undo()
    return out


def _unet_rank_setup():
    """The shrunk tiled-verdict budget and the lowered plane-parallel
    floor, on a fresh plan cache."""
    from repro_torch.core import plan as plan_mod
    plan_mod._REF_VMEM_BUDGET = TILED_BUDGET
    plan_mod._SPATIAL_MIN_BYTES = 0
    plan_mod.plan_cache_clear()


def _count_tiled_rows(seen):
    """The tiled rows plain versions (what kernels C and D's row-block
    entries run on the CPU) counted by kernel; returns the undo."""
    from repro_torch.kernels import untangled_conv as uc
    undos = []
    for attr, kern in (("untangled_conv2d_superpack_tiled_rows_ref", "C"),
                       ("untangled_deconv2d_tiled_rows_ref", "D")):
        def wrap(orig, kern=kern):
            def f(*a, **kw):
                seen[kern] = seen.get(kern, 0) + 1
                return orig(*a, **kw)
            return f
        undos.append(_patch(uc, attr, wrap))
    return lambda: [u() for u in undos]


def _partial_left_out(rank):
    """Planted fault: rank 1 keeps its own row-block partial (the
    all-reduce still runs, so no rank waits)."""
    def wrap(orig):
        def reduce_from(x, group, kind="all_reduce"):
            y = orig(x, group, kind)
            return x if rank == 1 and kind == "rows_all_reduce" else y
        return reduce_from
    return wrap


def _unet_case(rank, rule, wd, np_p, x, t, cot, ref):
    from repro_torch.core import comm, spatial
    from repro_torch.core import plan as plan_mod
    from repro_torch.launch import faults
    from repro_torch.launch.mesh import make_host_mesh, make_spatial_mesh
    from repro_torch.models import unet
    from repro_torch.sharding import DEFAULT_RULES, DistContext
    cfg = _unet_cfg(wd)
    specs = unet.unet_specs(cfg)
    mesh_kind, rules = UNET_RULES[rule]
    mesh = make_host_mesh(2, 2) if mesh_kind == "host" \
        else make_spatial_mesh(2, 2)
    dist = DistContext(mesh, rules=dict(DEFAULT_RULES, **rules))
    p, leaves = _leaves(dist.shard_params(_torch_params(np_p), specs))
    xt, group = dist.split_batch(torch.from_numpy(x))
    lo = dist.span(dist.image_spec()[0], x.shape[0])[0] if group else 0
    rows = slice(lo, lo + xt.shape[0])
    tt = torch.from_numpy(t)[rows]
    bound = mesh if mesh_kind == "spatial" else None
    seen, outs = {}, []
    undo = _count_tiled_rows(seen)
    orig_apply = plan_mod.ConvPlan.apply

    def keep(self, x_, packed, bias=None):
        y_ = orig_apply(self, x_, packed, bias=bias)
        outs.append(type(y_).__name__)
        return y_
    plan_mod.ConvPlan.apply = keep
    spatial.SPLIT_SITES[0] = 0
    try:
        with spatial.use_spatial_mesh(bound):
            y = unet.unet_apply(p, xt, tt, cfg, dist=dist)
    finally:
        plan_mod.ConvPlan.apply = orig_apply
        undo()
    (y * torch.from_numpy(cot[rows])).sum().backward()
    want_y, want_g = ref
    out = {"out": rel(want_y[rows], y.detach().numpy()),
           "grads": _block_grads(dist, specs, leaves, want_g),
           "tiled_rows": seen, "split_sites": spatial.SPLIT_SITES[0],
           "blocks_out": outs.count("PlaneBlocks"),
           "row_sites": sorted(k for k, v in p.items()
                               if type(v).__name__ == "RowSuperpack"),
           "tp_sites": sorted(k for k, v in p.items()
                              if type(v).__name__ == "TPSuperpack")}
    if mesh_kind == "spatial":
        fault = _patch(comm, "gather_from", faults.skip_gather_sum)
        p2, leaves2 = _leaves(dist.shard_params(_torch_params(np_p), specs))
        try:
            with spatial.use_spatial_mesh(bound):
                y2 = unet.unet_apply(p2, xt, tt, cfg, dist=dist)
            (y2 * torch.from_numpy(cot[rows])).sum().backward()
        finally:
            fault()
        out["planted"] = _block_grads(dist, specs, leaves2, want_g)
    else:
        fault = _patch(comm, "reduce_from", _partial_left_out(rank))
        try:
            with torch.no_grad():
                out["planted"] = rel(want_y[rows], unet.unet_apply(
                    p, xt, tt, cfg, dist=dist).numpy())
        finally:
            fault()
    return out


def _rank(rank, world, dev, path):
    torch.set_num_threads(1)
    warnings.simplefilter("ignore", RuntimeWarning)
    _unet_rank_setup()
    with open(path, "rb") as f:
        conf, refs = pickle.load(f)
    out = {}
    for key, (np_p, z, cot) in conf["gan"].items():
        out[key] = _gan_case(rank, *key, np_p, z, cot, refs["gan"][key])
    for key, (np_p, x, t, cot) in conf["unet"].items():
        out[key] = _unet_case(rank, *key, np_p, x, t, cot,
                              refs["unet"][key])
    return out


def _numpy(p):
    from repro_torch.core.plan import QuantizedSuperpack
    return {k: types.SimpleNamespace(q=v.q.numpy(), scale=v.scale.numpy())
            if isinstance(v, QuantizedSuperpack) else v.numpy()
            for k, v in p.items()}


def _inputs():
    """The port's seeded weights (numpy; int8 superpacks as codes and
    scales; biases drawn, not zero), inputs and output cotangents, handed
    to both packages."""
    from repro_torch.models import gan, unet
    rng = np.random.default_rng(32)
    out = {"gan": {}, "unet": {}}
    for name, wd, rule in GAN_CASES:
        cfg = _gan_cfg(name, wd)
        p = gan.generator_init(3, cfg, device="cpu")
        for k in p:
            if k.startswith("b"):
                p[k] = torch.from_numpy(rng.standard_normal(
                    tuple(p[k].shape)).astype(np.float32) * 0.1)
        z = rng.standard_normal((GAN_B, cfg.z_dim)).astype(np.float32)
        out["gan"][(name, wd, rule)] = (_numpy(p), z, rng.standard_normal(
            (GAN_B, *gan.generator_plans(cfg)[-1].out_hw, 3)).astype(
                np.float32))
    for rule, wd in UNET_CASES:
        cfg = _unet_cfg(wd)
        p = unet.unet_init(5, cfg, device="cpu")
        for k in p:
            if k.endswith("_b"):
                p[k] = torch.from_numpy(rng.standard_normal(
                    tuple(p[k].shape)).astype(np.float32) * 0.1)
        hw = cfg.image_hw
        out["unet"][(rule, wd)] = (
            _numpy(p), rng.standard_normal((UNET_B, hw, hw, 3)).astype(
                np.float32),
            rng.uniform(0.05, 0.95, (UNET_B,)).astype(np.float32),
            rng.standard_normal((UNET_B, hw, hw, 3)).astype(np.float32))
    return out


@pytest.fixture(scope="module")
def launch(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("splits")
    conf = {"dcgan": DCGAN_SMALL, "cgan": CGAN_SMALL,
            "gan_rules": GAN_RULES, "unet_rules": UNET_RULES,
            "unet_kw": UNET_KW, **_inputs()}
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


@pytest.mark.parametrize("name,wd,rule", GAN_CASES)
def test_split_generator_matches_jax(launch, name, wd, rule):
    """Each rank's rows of the generator's output within TOL_F32 of
    JAX's under the same rules, every block's gradient within TOL_GRAD;
    where a split axis carries the batch, the sites run as before the
    repair read past TOL_F32 (``both_no_batch``: nothing to repair, the
    planted run is the sound one)."""
    planted = []
    for res in launch["ranks"]:
        rec = res[(name, wd, rule)]
        assert rec["split"] == (rule != "both_no_batch"), rec
        assert rec["out"] < TOL_F32 and rec["grads"] < TOL_GRAD, rec
        planted.append(rec["planted"])
    if rule == "both_no_batch":
        assert max(planted) < TOL_F32
    else:
        assert max(planted) > TOL_F32, planted


def test_two_way_split_runs_a_row_block_of_a_column_block(launch):
    """Rows and out-channels split together: every generator site is a
    ``TPSuperpack`` of a ``RowSuperpack`` where its rows and columns
    divide."""
    for res in launch["ranks"]:
        kinds = res[("dcgan", "float32", "both_no_batch")]["kinds"]
        assert kinds.count("TPSuperpack") >= 2, kinds


@pytest.mark.parametrize("rule,wd", UNET_CASES)
def test_split_unet_matches_jax(launch, rule, wd):
    """The reduced U-Net's output within TOL_F32 of JAX's under the same
    rules on its mesh, every block's gradient within TOL_GRAD, and a
    planted fault past its tolerance: one rank's row-block partial left
    out (rows, both), the split weight's gather without its cotangent
    sum at the plane-parallel sites (plane_*)."""
    for res in launch["ranks"]:
        rec = res[(rule, wd)]
        assert rec["out"] < TOL_F32 and rec["grads"] < TOL_GRAD, rec
    tol = TOL_GRAD if rule.startswith("plane") else TOL_F32
    assert max(r[(rule, wd)]["planted"] for r in launch["ranks"]) > tol


def test_row_blocks_run_inside_kernels_c_and_d(launch):
    """With 'conv_taps' on 'model' every C and D site whose rows divide
    runs its row block through C's or D's rows entry (the stem's 27 rows
    do not divide: it stays whole, with JAX's warning), f32 and int8, and
    no site runs plane-parallel with no spatial mesh bound."""
    for res in launch["ranks"]:
        for wd in ("float32", "int8"):
            rec = res[("rows", wd)]
            assert rec["tiled_rows"] == {"C": 3, "D": 1}, rec
            assert set(rec["row_sites"]) >= {"down0", "fuse0", "head",
                                             "up0"}
            assert "stem" not in rec["row_sites"]
            assert rec["split_sites"] == 0 and rec["blocks_out"] == 0


def test_plane_parallel_sites_gather_the_split_weight(launch):
    """On the bound (2, 2) spatial mesh, sites with a device-tiling
    verdict run plane-parallel on the gathered superpack and return their
    output as blocks (the activations stay split); the superpack is split
    on its rows ('sp_h'), then on its out-channels ('sp_w')."""
    for res in launch["ranks"]:
        rows, cols = res[("plane_rows", "float32")], \
            res[("plane_cols", "float32")]
        assert rows["row_sites"] and cols["tp_sites"], (rows, cols)
        for rec in (rows, cols):
            assert rec["split_sites"] > 0 and rec["blocks_out"] > 0, rec
