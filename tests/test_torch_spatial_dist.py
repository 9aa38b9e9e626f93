"""Plane-parallel execution of the port (``repro_torch.core.spatial``) across
gloo processes on the CPU, held to the JAX package's single-device plans on
the same numpy inputs.

One launch of four ranks (``launch.mesh.run_spmd``, its own ``FileStore``,
so xdist workers cannot meet each other's ranks) runs every case; the JAX
references are computed here first and handed over:

- JAX's three parity geometries (``tests/test_spatial.py``) and a
  transposed site whose local low pad is negative (a crop): the forward
  and the x and superpack gradients of ``sum(y²)`` on every rank within
  JAX's own 2e-6 relative, and two planted faults read through the same
  gates past it: one inner halo delivered as zeros, the superpack
  gradient left unsummed on one rank;
- the exchange: inside ``spatial_apply``, forward and backward, no
  all-gather, all-to-all, gather, scatter or broadcast, and the bytes
  sent equal ``halo_bytes`` of the geometry each way;
- one int8 site (``QuantizedSuperpack``, JAX's codes and scales);
- a reduced U-Net (256 px, ``base=8``, B = 2, (2, 1) with data = 2)
  against JAX's forward on the same weights, with the sites that carry
  a verdict; its planes stay split between split sites (each output a
  block of the padded plane, all-gathers only before the bottleneck,
  which has no verdict, and at the output), and its parameter gradients
  equal the port's single-device ones;
- ``ControlPlane.degrade(4, spatial_tiles=(2, 1))`` (data = 2), its
  answers against JAX's single-device closure, and then the
  data-parallel ``degrade(4)``: each rank serves its row of a batch of
  four;
- autotune under the bound mesh: every rank picks the same winner;
- ``shrink_mesh``'s shapes against JAX's arithmetic.
"""
import dataclasses
import functools
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plan as jplan
from repro.models import unet as junet
from repro.runtime import elastic as jelastic
from repro_torch.launch.mesh import run_spmd
from repro_torch.models import unet as tunet

# JAX's own parity tolerance (tests/test_spatial.py), relative to max|ref|
TOL = 2e-6
WORLD = 4
BATCH = 2

PARITY = {
    "dilated385_4x1": (dict(kind="dilated", in_hw=(385, 385), in_c=4,
                            out_c=4, kernel_hw=(3, 3), strides=(1, 1),
                            padding=((2, 2), (2, 2)), dilation=(2, 2)),
                       (4, 1), 1),
    "decoder96_2x2": (dict(kind="transposed", in_hw=(96, 96), in_c=16,
                           out_c=16, kernel_hw=(4, 4), strides=(2, 2),
                           padding=((1, 3), (1, 3))), (2, 2), 1),
    "strided385_2x1_data2": (dict(kind="conv", in_hw=(385, 385), in_c=4,
                                  out_c=4, kernel_hw=(3, 3), strides=(2, 2),
                                  padding=((1, 1), (1, 1))), (2, 1), 2),
    "crop_deconv128_2x2": (dict(kind="transposed", in_hw=(128, 128),
                                in_c=8, out_c=8, kernel_hw=(3, 3),
                                strides=(2, 2),
                                padding=((-2, 5), (-2, 5))), (2, 2), 1),
}
INT8 = (dict(kind="dilated", in_hw=(385, 385), in_c=4, out_c=4,
             kernel_hw=(3, 3), strides=(1, 1), padding=((2, 2), (2, 2)),
             dilation=(2, 2), wdtype="int8"), (2, 2), 1)
UNET = dict(image_hw=256, base=8, time_dim=16)
DEGRADE_KW = dict(kind="dilated", in_hw=(385, 385), in_c=4, out_c=4,
                  kernel_hw=(3, 3), strides=(1, 1), padding=((2, 2), (2, 2)),
                  dilation=(2, 2))
SHRINK = ((4, 1), (3, 1), (4, 2), (2, 2))


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(a).max() + 1e-30))


# ---------------------------------------------------------------------------
# the ranks' side (runs in the spawned processes)
# ---------------------------------------------------------------------------

def _patched(obj, name, fn):
    """Swap ``obj.name`` for ``fn(original)`` and return the undo."""
    orig = getattr(obj, name)
    setattr(obj, name, fn(orig))
    return lambda: setattr(obj, name, orig)


def _run_sharded(kw, tiles, data, x, pk, wdtype_q=None):
    """Forward and gradients of ``sum(y²)`` through the sharded plan."""
    from repro_torch.core import spatial
    from repro_torch.core.plan import ConvSpec, QuantizedSuperpack, plan_conv
    from repro_torch.launch.mesh import make_spatial_mesh
    plan = plan_conv(ConvSpec(backend="torch", spatial=tiles, **kw))
    assert plan.route_for_batch(x.shape[0]).dev_tiles == tiles
    mesh = make_spatial_mesh(*tiles, data=data)
    xt = torch.from_numpy(x).requires_grad_(True)
    if wdtype_q is None:
        w = torch.from_numpy(pk).requires_grad_(True)
        packed, grad_of = w, w
    else:
        q, scale = wdtype_q
        s = torch.from_numpy(scale).requires_grad_(True)
        packed, grad_of = QuantizedSuperpack(torch.from_numpy(q), s), s
    with spatial.use_spatial_mesh(mesh):
        y = plan.apply(xt, packed)
        (y ** 2).sum().backward()
    return y.detach().numpy(), xt.grad.numpy(), grad_of.grad.numpy()


def _parity_case(rank, kw, tiles, data, x, pk, refs):
    from repro_torch.core import spatial
    y1, gx1, gk1 = refs
    out = {}
    y, gx, gk = _run_sharded(kw, tiles, data, x, pk)
    out["sound"] = (rel(y1, y), rel(gx1, gx), rel(gk1, gk))

    # planted: the first halo rank 1 receives arrives as zeros
    state = {"done": False}

    def zero_first_halo(orig):
        def f(sends, recvs, group):
            orig(sends, recvs, group)
            if rank == 1 and recvs and not state["done"]:
                state["done"] = True
                recvs[0][0].zero_()
        return f
    undo = _patched(spatial, "_send_recv", zero_first_halo)
    try:
        y, gx, _ = _run_sharded(kw, tiles, data, x, pk)
    finally:
        undo()
    out["zero_halo"] = (rel(y1, y), rel(gx1, gx))

    # planted: rank 1 keeps its own piece of the superpack gradient
    def unsummed(orig):
        def f(t, group):
            summed = orig(t.clone(), group)
            return t if rank == 1 else summed
        return f
    undo = _patched(spatial, "_all_reduce", unsummed)
    try:
        _, _, gk = _run_sharded(kw, tiles, data, x, pk)
    finally:
        undo()
    out["unsummed"] = rel(gk1, gk)
    return out


def _exchange_case(kw, tiles, data, x, pk):
    """Collectives and bytes inside ``spatial_apply``, forward and
    backward, on this rank."""
    import torch.distributed as dist
    from repro_torch.core import spatial
    from repro_torch.core.plan import ConvSpec
    from repro_torch.launch.mesh import make_spatial_mesh
    sp = spatial.spatial_plan(ConvSpec(backend="torch", spatial=tiles,
                                       **kw))
    mesh = make_spatial_mesh(*tiles, data=data)
    xb = spatial.scatter_plane(sp, torch.from_numpy(x), mesh)
    xb = spatial.PlaneBlocks(xb.block.detach().requires_grad_(True),
                             xb.layout)
    w = torch.from_numpy(pk).requires_grad_(True)
    calls = {"forbidden": [], "all_reduce": 0}
    sent = [0]

    def forbid(name):
        def wrap(orig):
            def f(*a, **k):
                calls["forbidden"].append(name)
                return orig(*a, **k)
            return f
        return wrap

    def count_reduce(orig):
        def f(*a, **k):
            calls["all_reduce"] += 1
            return orig(*a, **k)
        return f

    def count_bytes(orig):
        def f(sends, recvs, group):
            sent[0] += sum(t.numel() * t.element_size() for t, _ in sends)
            return orig(sends, recvs, group)
        return f
    undos = [_patched(dist, n, forbid(n)) for n in (
        "all_gather", "all_gather_into_tensor", "all_to_all",
        "all_to_all_single", "gather", "scatter", "broadcast",
        "reduce_scatter", "reduce_scatter_tensor")]
    undos.append(_patched(dist, "all_reduce", count_reduce))
    undos.append(_patched(spatial, "_send_recv", count_bytes))
    try:
        yb = spatial.spatial_apply(sp, xb, w, mesh)
        fwd = sent[0]
        yb.block.backward(torch.ones_like(yb.block))
    finally:
        for u in undos:
            u()
    return {"forbidden": calls["forbidden"], "all_reduce":
            calls["all_reduce"], "fwd_bytes": fwd,
            "bwd_bytes": sent[0] - fwd}


def _unet_case(cfg_kw, np_params, x, t, y_ref):
    from repro_torch.core import spatial
    from repro_torch.launch.mesh import make_spatial_mesh
    from repro_torch.models import unet as tunet
    cfg = tunet.UNetConfig("unet-sp", backend="torch", spatial=(2, 1),
                           **cfg_kw)
    params = tunet.params_from_jax(np_params, cfg, device="cpu")
    verdicts = {n: p.route_for_batch(x.shape[0]).dev_tiles
                for n, p in tunet.unet_plans(cfg).items()}
    with spatial.use_spatial_mesh(make_spatial_mesh(2, 1, data=2)), \
            torch.no_grad():
        y = tunet.unet_apply(params, torch.from_numpy(x),
                             torch.from_numpy(t), cfg)
    out = {"err": rel(y_ref, y.numpy()), "verdicts": verdicts}

    # the gradients of sum(y²) over every parameter, split against the
    # port's single-device run, with the all-gathers and the split sites'
    # output blocks counted
    def grads(mesh):
        ps = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        with spatial.use_spatial_mesh(mesh):
            y = tunet.unet_apply(ps, torch.from_numpy(x),
                                 torch.from_numpy(t), cfg)
            (y ** 2).sum().backward()
        return {k: v.grad for k, v in ps.items()}
    g1 = grads(None)
    gathers, blocks = [], []

    def count(orig):
        def f(t, group):
            gathers.append(tuple(t.shape))
            return orig(t, group)
        return f

    def record(orig):
        def f(*a):
            y = orig(*a)
            blocks.append((tuple(y.block.shape), y.layout.hw))
            return y
        return f
    undos = [_patched(spatial, "_all_gather", count),
             _patched(spatial, "spatial_apply", record)]
    try:
        g = grads(make_spatial_mesh(2, 1, data=2))
    finally:
        for u in undos:
            u()
    out["grad_err"] = max(rel(g1[k], g[k]) for k in g1)
    out["gathers"], out["blocks"] = gathers, blocks
    return out


def _degrade_case(kern, payloads, answers):
    from repro_torch.core import spatial
    from repro_torch.core.plan import ConvSpec, plan_conv
    from repro_torch.launch.mesh import mesh_shape
    from repro_torch.serving.control_plane import ControlPlane, ServeRequest
    rows = []

    def serve_for(tiles):
        plan = plan_conv(ConvSpec(backend="torch", spatial=tiles,
                                  **DEGRADE_KW))
        pk = plan.pack(torch.from_numpy(kern))

        def serve(x):
            rows.append(x.shape[0])
            return plan.apply(x, pk)
        return serve

    ticks = iter(range(10 ** 6))
    cp = ControlPlane(clock=lambda: next(ticks) * 1e-3)
    cp.register_image_model("seg", serve_for((1, 1)),
                            np.zeros((385, 385, 4), np.float32),
                            buckets=(1, 2, 4), device="cpu")
    n = len(payloads) - 1
    cp.run([ServeRequest(rid=i, model="seg", payload=z)
            for i, z in enumerate(payloads[:n])])
    before = {r.rid: r.out for r in cp.done}
    mesh = cp.degrade(4, spatial_tiles=(2, 1),
                      serve_fns={"seg": serve_for((2, 1))})
    bound = spatial.active_spatial_mesh()[0] is mesh
    split0 = spatial.SPLIT_SITES[0]
    cp.run([ServeRequest(rid=10 + i, model="seg", payload=z)
            for i, z in enumerate(payloads[:n])])
    after = {r.rid: r.out for r in cp.done if r.rid >= 10}
    out = {"mesh": mesh_shape(mesh), "degraded": cp.degraded,
           "bound": bound, "split_sites": spatial.SPLIT_SITES[0] - split0,
           "launches": list(cp.backends["seg"].batcher.launches),
           "before": [rel(answers[i], before[i]) for i in range(n)],
           "after": [rel(answers[i], after[10 + i]) for i in range(n)]}
    # data-parallel: every batch of four split over 'data', one row a rank
    dmesh = cp.degrade(4, serve_fns={"seg": serve_for((1, 1))})
    del rows[:]
    cp.run([ServeRequest(rid=20 + i, model="seg", payload=z)
            for i, z in enumerate(payloads)])
    dp = {r.rid: r.out for r in cp.done if r.rid >= 20}
    out["dp"] = {"mesh": mesh_shape(dmesh), "rows": list(rows),
                 "launches": cp.backends["seg"].batcher.launches[-1:],
                 "err": [rel(answers[i], dp[20 + i])
                         for i in range(len(payloads))]}
    return out


def _blocks_case(kw, x, pk):
    """A split site's output as blocks: elementwise ops and a channel
    concatenation stay blocks (no all-gather), a reduction gathers, an
    in-place method is refused; the results equal the single-device
    ones."""
    import torch.nn.functional as F
    from repro_torch.core import spatial
    from repro_torch.core.plan import ConvSpec, plan_conv
    from repro_torch.launch.mesh import make_spatial_mesh
    plan = plan_conv(ConvSpec(backend="torch", spatial=(2, 2), **kw))
    one = plan_conv(ConvSpec(backend="torch", **kw))
    b = torch.linspace(-1.0, 1.0, kw["out_c"])
    xt, w = torch.from_numpy(x), torch.from_numpy(pk)

    def chain(y):
        z = F.leaky_relu(y + b, 0.2) * 2.0 - 1.0
        z = torch.abs(-z) ** 2 / 3.0 + torch.square(torch.tanh(y))
        return z, torch.cat([z, y], dim=-1)
    z1, c1 = chain(one.apply(xt, w))
    gathers = []

    def count(orig):
        def f(t, group):
            gathers.append(tuple(t.shape))
            return orig(t, group)
        return f
    undo = _patched(spatial, "_all_gather", count)
    try:
        with spatial.use_spatial_mesh(make_spatial_mesh(2, 2)):
            y = plan.apply(xt, w)
            z, c = chain(y)
            kinds = [type(v).__name__ for v in (y, z, c)]
            n_chain = len(gathers)
            total = float(z.sum())
            n_sum = len(gathers) - n_chain
            try:
                z.add_(1.0)
                refused = None
            except TypeError as e:
                refused = str(e)
            zf, cf = spatial.gather_plane(z), spatial.gather_plane(c)
    finally:
        undo()
    return {"kinds": kinds, "shape": tuple(c.shape), "n_chain": n_chain,
            "n_sum": n_sum, "refused": refused,
            "z": rel(z1.numpy(), zf.numpy()), "c": rel(c1.numpy(),
                                                      cf.numpy()),
            "sum": abs(total - float(z1.sum())) / float(z1.abs().sum())}


def _autotune_case():
    from repro_torch.core import spatial
    from repro_torch.core.autotune import AutotunePolicy, measure_bucket
    from repro_torch.core.plan import ConvSpec, plan_conv
    from repro_torch.launch.mesh import make_spatial_mesh
    plan = plan_conv(ConvSpec(backend="torch", spatial=(4, 1),
                              **DEGRADE_KW))
    with spatial.use_spatial_mesh(make_spatial_mesh(4, 1)):
        best, timings = measure_bucket(plan, 1, AutotunePolicy(
            iters=1, warmup=0, min_gain=1.0))
    return best, sorted(timings)


def _shrink_case():
    from repro_torch.launch.mesh import mesh_shape
    from repro_torch.runtime.elastic import shrink_mesh
    out = []
    for left, model in SHRINK:
        mesh = shrink_mesh(left, model)
        out.append((mesh_shape(mesh), mesh.get_coordinate() is not None))
    try:
        shrink_mesh(1, 2)
    except ValueError as e:
        out.append(str(e))
    return out


def _rank(rank, world, dev, path):
    torch.set_num_threads(1)
    with open(path, "rb") as f:
        parity, int8, unet, degrade = pickle.load(f)
    out = {"parity": {}, "exchange": {}}
    for name, (kw, tiles, data, x, pk, refs) in parity.items():
        out["parity"][name] = _parity_case(rank, kw, tiles, data, x, pk,
                                           refs)
        out["exchange"][name] = _exchange_case(kw, tiles, data, x, pk)
    kw, tiles, data, x, qs, y_ref = int8
    y, _, gscale = _run_sharded(kw, tiles, data, x, None, wdtype_q=qs)
    from repro_torch.core.plan import ConvSpec, QuantizedSuperpack, plan_conv
    single = plan_conv(ConvSpec(backend="torch", **kw))
    s = torch.from_numpy(qs[1]).requires_grad_(True)
    ys = single.apply(torch.from_numpy(x),
                      QuantizedSuperpack(torch.from_numpy(qs[0]), s))
    (ys ** 2).sum().backward()
    out["int8"] = (rel(y_ref, y), rel(s.grad.numpy(), gscale))
    kw, tiles, data, x, pk, _ = parity["dilated385_4x1"]
    out["blocks"] = _blocks_case(kw, x, pk)
    out["unet"] = _unet_case(*unet)
    out["degrade"] = _degrade_case(*degrade)
    out["autotune"] = _autotune_case()
    out["shrink"] = _shrink_case()
    return out


# ---------------------------------------------------------------------------
# the JAX side and the launch (here)
# ---------------------------------------------------------------------------

def _inputs(kw, seed):
    rng = np.random.default_rng(seed)
    h, w = kw["in_hw"]
    x = rng.standard_normal((BATCH, h, w, kw["in_c"])).astype(np.float32)
    kern = rng.standard_normal(kw["kernel_hw"] + (kw["in_c"], kw["out_c"])
                               ).astype(np.float32)
    return x, kern


def _jax_refs(kw, x, kern):
    plan = jplan.plan_conv(jplan.ConvSpec(backend="xla", **kw))
    pk = plan.pack(jnp.asarray(kern))

    def loss(x_, pk_):
        return jnp.sum(plan.apply(x_, pk_) ** 2)
    y = plan.apply(jnp.asarray(x), pk)
    gx, gk = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), pk)
    return np.asarray(pk), tuple(np.asarray(a) for a in (y, gx, gk))


@pytest.fixture(scope="module")
def launch(tmp_path_factory):
    parity = {}
    for i, (name, (kw, tiles, data)) in enumerate(PARITY.items()):
        x, kern = _inputs(kw, i)
        pk, refs = _jax_refs(kw, x, kern)
        parity[name] = (kw, tiles, data, x, pk, refs)
    kw, tiles, data = INT8
    x, kern = _inputs(kw, 7)
    jp = jplan.plan_conv(jplan.ConvSpec(backend="xla", **kw))
    qsp = jp.pack(jnp.asarray(kern))
    y8 = np.asarray(jp.apply(jnp.asarray(x), qsp))
    int8 = (kw, tiles, data, x, (np.asarray(qsp.q), np.asarray(qsp.scale)),
            y8)
    jcfg = junet.UNetConfig("unet-sp", **UNET)
    # the port's seeded draw, handed to both packages (JAX's own init
    # takes ~14 s on the CPU here)
    np_params = {k: v.numpy() for k, v in tunet.unet_init(
        0, tunet.UNetConfig("unet-sp", **UNET), device="cpu").items()}
    jp_u = {k: jnp.asarray(v) for k, v in np_params.items()}
    rng = np.random.default_rng(3)
    xu = rng.standard_normal((BATCH, 256, 256, 3)).astype(np.float32)
    tu = rng.uniform(0.0, 1.0, (BATCH,)).astype(np.float32)
    yu = np.asarray(jax.jit(functools.partial(junet.unet_apply, cfg=jcfg))(
        jp_u, xu, tu))
    junet_verdicts = {n: p.route_for_batch(BATCH).dev_tiles for n, p in
                      junet.unet_plans(dataclasses.replace(
                          jcfg, spatial=(2, 1))).items()}
    kern = jax.random.normal(jax.random.PRNGKey(0), (3, 3, 4, 4))
    dplan = jplan.plan_conv(jplan.ConvSpec(backend="xla", **DEGRADE_KW))
    dpk = dplan.pack(kern)
    payloads = [np.random.RandomState(i).randn(385, 385, 4)
                .astype(np.float32) for i in range(4)]
    answers = [np.asarray(dplan.apply(jnp.asarray(z[None]), dpk))[0]
               for z in payloads]
    # the inputs and references reach the ranks through one file (pickling
    # ~75 MB into every spawned rank costs more than the ranks' work)
    path = tmp_path_factory.mktemp("spatial") / "inputs.pkl"
    with open(path, "wb") as f:
        pickle.dump((parity, int8, (UNET, np_params, xu, tu, yu),
                     (np.asarray(kern), payloads, answers)), f, protocol=5)
    ranks = run_spmd(_rank, WORLD, str(path), device="cpu", timeout=300)
    return {"ranks": ranks, "parity": parity, "junet": junet_verdicts}


@pytest.mark.parametrize("name", list(PARITY))
def test_forward_and_gradients_match_jax(launch, name):
    """Every rank's forward, x gradient and superpack gradient within
    JAX's tolerance of JAX's single-device plan."""
    for r, res in enumerate(launch["ranks"]):
        y, gx, gk = res["parity"][name]["sound"]
        assert max(y, gx, gk) < TOL, (r, y, gx, gk)


@pytest.mark.parametrize("name", list(PARITY))
def test_planted_faults_exceed_the_tolerance(launch, name):
    """The same gates read two planted faults: an inner halo delivered as
    zeros (the forward and the x gradient, on every rank: the plane is
    gathered), and the superpack gradient left unsummed on rank 1 (that
    rank's superpack gradient; on a 2-D mesh the sum's second stage
    carries the fault to other ranks too)."""
    for r, res in enumerate(launch["ranks"]):
        got = res["parity"][name]
        assert got["zero_halo"][0] > 10 * TOL, (r, got)
        assert got["zero_halo"][1] > 10 * TOL, (r, got)
    assert launch["ranks"][1]["parity"][name]["unsummed"] > 10 * TOL


@pytest.mark.parametrize("name", list(PARITY))
def test_exchange_moves_only_halo_bytes(launch, name):
    """Inside ``spatial_apply`` only halo rows move: no all-gather,
    all-to-all, gather, scatter or broadcast forward or backward, the
    bytes sent each way equal to the geometry's, and the superpack
    gradient's all-reduce once over each split axis."""
    from repro_torch.core import spatial
    from repro_torch.core.plan import ConvSpec
    kw, tiles, data, *_ = launch["parity"][name]
    sp = spatial.spatial_plan(ConvSpec(backend="torch", spatial=tiles, **kw))
    want = spatial.halo_bytes(sp, BATCH // data, 4) * data
    got = [res["exchange"][name] for res in launch["ranks"]]
    assert all(g["forbidden"] == [] for g in got), got
    assert sum(g["fwd_bytes"] for g in got) == want > 0
    assert sum(g["bwd_bytes"] for g in got) == want
    split_axes = sum(d > 1 for d in (*tiles, data))
    assert all(g["all_reduce"] == split_axes for g in got), got


def test_int8_site_matches_jax(launch):
    """An int8 site (JAX's codes and scales) split (2, 2): the forward
    within JAX's tolerance of JAX's int8 plan, the scale's gradient
    within it of the port's single-device plan."""
    for res in launch["ranks"]:
        y, gscale = res["int8"]
        assert y < TOL and gscale < TOL, res["int8"]


def test_reduced_unet_matches_jax(launch):
    """The 256 px U-Net (``base=8``) at B = 2 split (2, 1) with data = 2
    against JAX's forward on the same weights; the sites that carry a
    verdict are JAX's, every site but the 64² bottleneck."""
    verdicts = launch["ranks"][0]["unet"]["verdicts"]
    assert verdicts == launch["junet"]
    split = {n for n, v in verdicts.items() if v == (2, 1)}
    assert split == {"stem", "down0", "down1", "up1", "fuse1", "up0",
                     "fuse0", "head"}, verdicts
    for res in launch["ranks"]:
        assert res["unet"]["err"] < 1e-5, res["unet"]["err"]


def test_reduced_unet_keeps_planes_split(launch):
    """Between split sites the U-Net's planes stay split: each split
    site's output is the rank's block (half the padded rows, half the
    batch), the only all-gathers of the forward and backward are those of
    the planes the bottleneck (no verdict) and the output need whole and
    of the cotangent of the bottleneck's output (the first split site
    after it took its block), and the gradients of every parameter equal
    the port's single-device ones."""
    for res in launch["ranks"]:
        u = res["unet"]
        assert u["grad_err"] < 1e-5, u["grad_err"]
        assert len(u["blocks"]) == 8
        for shape, ((dh, vh, bh), (dw, vw, bw)) in u["blocks"]:
            assert (dh, dw) == (2, 1) and dh * bh >= vh and bw == vw
            assert shape[:3] == (BATCH // 2, bh, bw), (shape, bh, bw)
        # forward: the bottleneck's input (32 channels at 64²) and the
        # output (3 channels at 256²), each over 'sp_h' then 'data';
        # backward: the cotangent of the bottleneck's output
        mid = [(1, 32, 64, 32), (1, 64, 64, 32)]
        assert u["gathers"] == mid + [(1, 128, 256, 3),
                                      (1, 256, 256, 3)] + mid, u["gathers"]


def test_degrade_replans_spatial_tiles(launch):
    """``degrade(4, spatial_tiles=(2, 1))`` builds the (data=2, sp_h=2,
    sp_w=1) mesh, binds it and serves the re-planned closure: the answers
    before and after within JAX's tolerance of JAX's single-device
    closure, on every rank, with the same launches everywhere, and the
    launch after the degrade really split its plane."""
    launches = []
    for res in launch["ranks"]:
        d = res["degrade"]
        assert d["mesh"] == {"data": 2, "sp_h": 2, "sp_w": 1}
        assert d["degraded"]["spatial_tiles"] == (2, 1)
        assert d["degraded"]["devices_left"] == 4 and d["bound"]
        assert max(d["before"] + d["after"]) < TOL, d
        # the launch after the degrade split its plane: one split site
        assert d["split_sites"] == 1
        launches.append(d["launches"])
    assert all(ls == launches[0] for ls in launches)
    assert launches[0] == [(4, 3), (4, 3)]


def test_data_parallel_degrade_splits_the_batch(launch):
    """``degrade(4)`` (no tiling) gives the (data=4, model=1) mesh, and
    each rank serves its one row of a batch of four: the serve function
    sees one row on every rank, and the joined answers are JAX's."""
    for res in launch["ranks"]:
        dp = res["degrade"]["dp"]
        assert dp["mesh"] == {"data": 4, "model": 1}
        assert dp["launches"] == [(4, 4)] and dp["rows"] == [1], dp
        assert max(dp["err"]) < TOL, dp


def test_split_output_stays_blocks_through_elementwise_ops(launch):
    """The split site's output and what elementwise ops and a channel
    concatenation make of it are ``PlaneBlocks`` with the global shape,
    made with no all-gather; a reduction gathers the plane (over 'sp_w'
    then 'sp_h'); an in-place method is refused; every result equals the
    single-device one."""
    for res in launch["ranks"]:
        got = res["blocks"]
        assert got["kinds"] == ["PlaneBlocks"] * 3
        assert got["shape"] == (BATCH, 385, 385, 8)
        assert got["n_chain"] == 0 and got["n_sum"] == 2, got
        assert "in-place" in got["refused"]
        assert max(got["z"], got["c"], got["sum"]) < TOL, got


def test_autotune_under_the_mesh_agrees_across_ranks(launch):
    """Measured under a bound (4, 1) mesh, the device-tiled candidates are
    timed beside the single-device ones, and every rank takes the slowest
    rank's times, so all pick the same winner."""
    results = [res["autotune"] for res in launch["ranks"]]
    assert all(r == results[0] for r in results)
    labels = results[0][1]
    assert any("@dev4x1" in lab for lab in labels)
    assert any("@dev" not in lab for lab in labels)


def test_shrink_mesh_matches_jax_arithmetic(monkeypatch, launch):
    """The surviving ranks' mesh has JAX's shape (its
    ``jax.make_mesh`` arguments), and ranks past it hold no
    coordinate."""
    monkeypatch.setattr(jelastic.jax, "make_mesh",
                        lambda shape, names, **kw: dict(zip(names, shape)))
    for r, res in enumerate(launch["ranks"]):
        *shapes, err = res["shrink"]
        for (left, model), (got, on_mesh) in zip(SHRINK, shapes):
            want = jelastic.shrink_mesh(left, model)
            assert got == want, (left, model)
            n = int(np.prod(list(want.values())))
            assert on_mesh == (r < n)
        assert "cannot keep TP=2 with 1 chips" in err
