"""The port's plane-parallel geometry and verdicts against the JAX
package's, in one process (pure arithmetic, no ranks): every
``DimTiling`` field, the local spec and the output extent of
``repro_torch.core.spatial.spatial_plan`` equal to ``repro.core.spatial``'s
at the three ``CONVPLANE_SITES`` over every tiling of
``DEFAULT_DEV_TILES``, the specs of ``tests/test_spatial.py``, the
infeasible ones (both None, the warning's text, once per process) and
the DCGAN, SegNet, VAE and U-Net sites at (2, 1), (2, 2) and (4, 1);
``route_for_batch(b).dev_tiles`` equal over every bucket; the route's
JSON round trip and ``spec_key``; autotune's device-tiled candidates and
``_measurable``; and with no mesh bound, ``apply`` bit-equal to the
(1, 1) twin.  The split execution itself is
``tests/test_torch_spatial_dist.py``."""
import dataclasses
import warnings

import pytest
import torch

from repro.core import autotune as jtune
from repro.core import plan as jplan
from repro.core import spatial as jspatial
from repro.launch.dryrun import CONVPLANE_SITES, DEFAULT_DEV_TILES
from repro.models import gan as jgan
from repro.models import segnet as jseg
from repro.models import unet as junet
from repro.models import vae as jvae
from repro_torch.core import autotune as ttune
from repro_torch.core import plan as tplan
from repro_torch.core import spatial as tspatial
from repro_torch.models import gan as tgan
from repro_torch.models import segnet as tseg
from repro_torch.models import unet as tunet
from repro_torch.models import vae as tvae

TILINGS = ((2, 1), (2, 2), (4, 1))
BATCHES = (1, 2, 4, 5, 16, 17, 64, 100)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def port_spec(jspec, backend="torch"):
    fields = dataclasses.asdict(jspec)
    fields["backend"] = backend
    return tplan.ConvSpec(**fields)


def convplane(site, tiles):
    g = CONVPLANE_SITES[site]
    return jplan.ConvSpec(kind=g["kind"], in_hw=g["in_hw"], in_c=g["c"],
                          out_c=g["n"], kernel_hw=g["kernel"],
                          strides=g["strides"], padding=g["padding"],
                          dilation=g["dilation"], backend="xla",
                          spatial=tuple(tiles))


def dilated385(tiles, c=4, n=4):
    return jplan.ConvSpec(kind="dilated", in_hw=(385, 385), in_c=c, out_c=n,
                          kernel_hw=(3, 3), strides=(1, 1),
                          padding=((2, 2), (2, 2)), dilation=(2, 2),
                          backend="xla", spatial=tiles)


def decoder96(tiles, c=16, n=16):
    return jplan.ConvSpec(kind="transposed", in_hw=(96, 96), in_c=c,
                          out_c=n, kernel_hw=(4, 4), strides=(2, 2),
                          padding=((1, 3), (1, 3)), backend="xla",
                          spatial=tiles)


# tests/test_spatial.py's specs, feasible and not
TEST_SPATIAL_SPECS = [
    dilated385((4, 1)), dilated385((4, 1), 32, 32), dilated385((4, 1), 8, 8),
    decoder96((2, 2)),
    jplan.ConvSpec(kind="conv", in_hw=(32, 32), in_c=4, out_c=4,
                   kernel_hw=(3, 3), strides=(1, 1),
                   padding=((1, 1), (1, 1)), backend="xla", spatial=(2, 1)),
    jplan.ConvSpec(kind="conv", in_hw=(385, 385), in_c=4, out_c=4,
                   kernel_hw=(3, 3), strides=(2, 2),
                   padding=((1, 1), (1, 1)), backend="xla", spatial=(2, 1)),
    jplan.ConvSpec(kind="transposed", in_hw=(96, 96), in_c=16, out_c=16,
                   kernel_hw=(4, 4), strides=(2, 2), padding=((1, 3), (1, 3)),
                   backend="xla", spatial=(2, 2)),
]

# geometries that admit no one-hop exchange, each for its own reason
# (channel counts unique to this file: the warning fires once per process)
INFEASIBLE = [
    ("multi_hop", jplan.ConvSpec(
        kind="conv", in_hw=(16, 16), in_c=2, out_c=3, kernel_hw=(5, 5),
        strides=(1, 1), padding=((2, 2), (2, 2)), backend="xla",
        spatial=(16, 1)), "needs multi-hop exchange"),
    ("non_uniform", jplan.ConvSpec(
        kind="transposed", in_hw=(24, 24), in_c=7, out_c=11,
        kernel_hw=(3, 3), strides=(2, 2), padding=((1, 0), (1, 0)),
        backend="xla", spatial=(2, 2)), "non-uniform"),
    ("crop", jplan.ConvSpec(
        kind="conv", in_hw=(40, 40), in_c=3, out_c=5, kernel_hw=(3, 3),
        strides=(1, 1), padding=((-1, 0), (0, 0)), backend="xla",
        spatial=(2, 1)), "crop-style padding"),
]


def model_specs():
    """(name, JAX spec) of every DCGAN (generator and discriminator),
    SegNet, VAE and U-Net site at each tiling."""
    out = []
    for t in TILINGS:
        tag = f"{t[0]}x{t[1]}"
        gcfg = dataclasses.replace(jgan.DCGAN, spatial=t)
        plans = (list(jgan.generator_plans(gcfg))
                 + list(jgan.discriminator_plans(gcfg))
                 + list(jseg.segnet_plans(dataclasses.replace(
                     jseg.SEGNET, spatial=t)))
                 + list(jvae.vae_plans(dataclasses.replace(
                     jvae.VAE, spatial=t))))
        out += [(f"{tag}/{i}", p.spec) for i, p in enumerate(plans)]
        out += [(f"{tag}/unet_{n}", p.spec) for n, p in junet.unet_plans(
            dataclasses.replace(junet.UNET, spatial=t)).items()]
    return out


with warnings.catch_warnings():
    warnings.simplefilter("ignore", RuntimeWarning)
    MODEL_SPECS = model_specs()

GEOMETRY_SPECS = (
    [(f"{site}/{t[0]}x{t[1]}", convplane(site, t))
     for site in CONVPLANE_SITES for t in DEFAULT_DEV_TILES]
    + [(f"test_spatial/{i}", s) for i, s in enumerate(TEST_SPATIAL_SPECS)]
    + MODEL_SPECS)


def assert_same_geometry(jsp, tsp):
    if jsp is None:
        assert tsp is None
        return
    assert tsp is not None
    for jd, td in zip(jsp.dims, tsp.dims):
        assert dataclasses.asdict(td) == dataclasses.asdict(jd)
    want = dataclasses.asdict(jsp.local_spec)
    got = dataclasses.asdict(tsp.local_spec)
    assert got.pop("backend") == "torch" and want.pop("backend") == "xla"
    assert got == want
    assert tsp.out_hw == jsp.out_hw and tsp.dev_tiles == jsp.dev_tiles


@pytest.mark.parametrize("name,jspec", GEOMETRY_SPECS,
                         ids=[n for n, _ in GEOMETRY_SPECS])
def test_geometry_and_verdicts_match_jax(name, jspec):
    """Every tiling field, the local spec, the output extent and each
    bucket's ``dev_tiles`` (the exact routes beyond the largest bucket
    too) equal to JAX's."""
    tspec = port_spec(jspec)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        assert_same_geometry(jspatial.spatial_plan(jspec),
                             tspatial.spatial_plan(tspec))
        jp, tp = jplan.plan_conv(jspec), tplan.plan_conv(tspec)
    for b in BATCHES:
        assert tp.route_for_batch(b).dev_tiles == \
            jp.route_for_batch(b).dev_tiles, b


def test_convplane_sites_carry_verdicts():
    """JAX's three dryrun geometries split at their own batch (4) on every
    tiling; the verdict leaves the single-device route as it was."""
    for site, g in CONVPLANE_SITES.items():
        for t in DEFAULT_DEV_TILES:
            tp = tplan.plan_conv(port_spec(convplane(site, t)))
            twin = tplan.plan_conv(port_spec(convplane(site, (1, 1))))
            r = tp.route_for_batch(g["batch"])
            assert r.dev_tiles == t, (site, t)
            assert dataclasses.replace(r, dev_tiles=None) == \
                twin.route_for_batch(g["batch"])


def test_verdict_floor():
    """Below ``_SPATIAL_MIN_BYTES`` a tiling request routes single-device
    (JAX's floor, unchanged)."""
    assert tplan._SPATIAL_MIN_BYTES == jplan._SPATIAL_MIN_BYTES == 4 << 20
    small = port_spec(TEST_SPATIAL_SPECS[4])
    assert all(r.dev_tiles is None for r in tplan.plan_conv(small).routes)
    # JAX's parity geometry clears it at B = 1 (385² x 4 channels, in+out)
    assert tplan.plan_conv(port_spec(dilated385((4, 1)))).route_for_batch(
        1).dev_tiles == (4, 1)


# a transposed site whose padding crops: the local spec's low pad
# ``pl - gl·s`` is negative
CROP_DECONV = jplan.ConvSpec(kind="transposed", in_hw=(128, 128), in_c=8,
                             out_c=8, kernel_hw=(3, 3), strides=(2, 2),
                             padding=((-2, 5), (-2, 5)), backend="xla",
                             spatial=(2, 2))


@pytest.mark.parametrize("jspec", [
    convplane("decoder_96", (2, 2)), convplane("decoder_96", (4, 1)),
    CROP_DECONV], ids=["decoder96_2x2", "decoder96_4x1", "crop_2x2"])
def test_transposed_local_plan_shares_the_superpack_layout(jspec):
    """The port's local plan of a transposed site equals JAX's, phase for
    phase, and keeps the parent's superpack layout; its output block is
    the padded output over the devices.  The crop site's local low pad is
    negative, and both packages plan it the same."""
    jsp = jspatial.spatial_plan(jspec)
    tsp = tspatial.spatial_plan(port_spec(jspec))
    assert_same_geometry(jsp, tsp)
    if jspec is CROP_DECONV:
        assert tsp.local_spec.padding[0][0] < 0
    jl = jplan.plan_conv(jsp.local_spec)
    tl = tplan.plan_conv(tsp.local_spec)
    assert tl.gpad == jl.gpad and tl.out_hw == jl.out_hw
    assert [dataclasses.asdict(e) for e in tl.phases] == \
        [dataclasses.asdict(e) for e in jl.phases]
    assert tl.dx_taps == jl.dx_taps and tl.bwd_pad == jl.bwd_pad
    parent = tplan.plan_conv(port_spec(dataclasses.replace(
        jspec, spatial=(1, 1))))
    assert tl.total_taps == parent.total_taps
    assert [(e.q, e.tap_off) for e in tl.phases] == \
        [(e.q, e.tap_off) for e in parent.phases]
    assert tl.out_hw == (tsp.dims[0].out_pad // tsp.dims[0].dev,
                         tsp.dims[1].out_pad // tsp.dims[1].dev)


@pytest.mark.parametrize("name,jspec,why", INFEASIBLE,
                         ids=[n for n, _, _ in INFEASIBLE])
def test_infeasible_tiling_warns_once(name, jspec, why):
    """Both packages give None and the same warning text, once per
    process, surviving ``plan_cache_clear``; the plan keeps no verdict and
    runs bit-equal to its (1, 1) twin."""
    tspec = port_spec(jspec)
    with warnings.catch_warnings(record=True) as jrec:
        warnings.simplefilter("always")
        assert jspatial.spatial_plan(jspec) is None
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        assert tspatial.spatial_plan(tspec) is None
        plan = tplan.plan_conv(tspec)
        tplan.plan_cache_clear()
        plan2 = tplan.plan_conv(tspec)
    hits = [str(w.message) for w in rec
            if issubclass(w.category, RuntimeWarning)
            and "spatial_plan" in str(w.message)]
    assert len(hits) == 1, hits
    jhits = [str(w.message) for w in jrec if "spatial_plan" in
             str(w.message)]
    if jhits:                      # JAX's set may have warned in this process
        assert hits[0] == jhits[0]
    assert why in hits[0] and "planning single-device" in hits[0]
    assert f"spatial={jspec.spatial}" in hits[0]
    assert all(r.dev_tiles is None for r in plan.routes)
    twin = tplan.plan_conv(dataclasses.replace(tspec, spatial=(1, 1)))
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, *tspec.in_hw, tspec.in_c), generator=gen)
    k = torch.randn((*tspec.kernel_hw, tspec.in_c, tspec.out_c),
                    generator=gen)
    assert torch.equal(plan2.apply(x, plan2.pack(k)),
                       twin.apply(x, twin.pack(k)))


def test_route_json_roundtrip_and_spec_key():
    tspec = port_spec(convplane("dilated_context_385", (4, 1)))
    r = tplan.plan_conv(tspec).route_for_batch(4)
    assert r.dev_tiles == (4, 1)
    assert ttune.route_from_json(ttune.route_to_json(r)) == r
    assert ttune.route_to_json(r)["dev_tiles"] == \
        jtune.route_to_json(jplan.plan_conv(convplane(
            "dilated_context_385", (4, 1))).route_for_batch(4))["dev_tiles"]
    for t in DEFAULT_DEV_TILES:
        key = ttune.spec_key(port_spec(convplane("encoder_512", t)))
        jkey = jtune.spec_key(convplane("encoder_512", t))
        assert key.endswith(f":sp{t[0]}x{t[1]}") and jkey.endswith(
            f":sp{t[0]}x{t[1]}")
    assert ":sp" not in ttune.spec_key(port_spec(dilated385((1, 1))))


class _FakeMesh:
    """What ``mesh_matches`` reads of a mesh: its axis names and extents."""

    def __init__(self, **sizes):
        self.mesh_dim_names = tuple(sizes)
        self.shape = tuple(sizes.values())


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_autotune_pairs_device_tiled_candidates(backend):
    """Each single-device candidate beside its device-tiled twin, as
    JAX pairs them; a device-tiled candidate is measurable only under a
    bound mesh of its extents."""
    jspec = convplane("dilated_context_385", (4, 1))
    tp = tplan.plan_conv(port_spec(jspec, backend))
    cands = ttune.candidate_routes(tp, 4)
    single = [r for r in cands if r.dev_tiles is None]
    dev = [r for r in cands if r.dev_tiles == (4, 1)]
    assert single and len(dev) == len(single)
    assert [dataclasses.replace(r, dev_tiles=None) for r in dev] == single
    jc = jtune.candidate_routes(jplan.plan_conv(jspec), 4)
    assert len([r for r in jc if r.dev_tiles == (4, 1)]) == \
        len([r for r in jc if r.dev_tiles is None])
    torch_dev = [r for r in dev if r.path != "cuda"]
    assert not ttune._measurable(torch_dev[0])
    assert not jtune._measurable(next(r for r in jc if r.dev_tiles))
    with tspatial.use_spatial_mesh(_FakeMesh(data=1, sp_h=4, sp_w=1)):
        assert ttune._measurable(torch_dev[0])
    with tspatial.use_spatial_mesh(_FakeMesh(data=2, sp_h=2, sp_w=1)):
        assert not ttune._measurable(torch_dev[0])
    # a (1, 1) spec gets no twins
    flat = tplan.plan_conv(port_spec(convplane("dilated_context_385",
                                               (1, 1)), backend))
    assert all(r.dev_tiles is None
               for r in ttune.candidate_routes(flat, 4))


def test_apply_without_a_mesh_is_bit_equal_to_the_twin():
    """A ``dev_tiles`` route with no mesh bound (or a mesh of other
    extents) runs the single-device route: bit-equal to the (1, 1)
    twin, forward and gradients."""
    spec = port_spec(dilated385((4, 1)))
    plan = tplan.plan_conv(spec)
    twin = tplan.plan_conv(dataclasses.replace(spec, spatial=(1, 1)))
    assert plan.route_for_batch(1).dev_tiles == (4, 1)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((1, 385, 385, 4), generator=gen)
    k = torch.randn((3, 3, 4, 4), generator=gen)
    outs = []
    for p, mesh in ((plan, None), (plan, _FakeMesh(data=1, sp_h=2,
                                                   sp_w=2)), (twin, None)):
        xg = x.clone().requires_grad_(True)
        pk = p.pack(k).requires_grad_(True)
        with tspatial.use_spatial_mesh(mesh):
            y = p.apply(xg, pk)
        (y ** 2).sum().backward()
        outs.append((y.detach(), xg.grad, pk.grad))
    for got in outs[:2]:
        for a, b in zip(got, outs[2]):
            assert torch.equal(a, b)


def test_model_configs_pass_spatial_into_every_site():
    """``spatial`` of the GAN, SegNet, U-Net and VAE configs reaches every
    site's spec, and the sites equal JAX's."""
    t = (2, 1)
    pairs = [
        (tgan.generator_plans(dataclasses.replace(tgan.DCGAN, spatial=t)),
         jgan.generator_plans(dataclasses.replace(jgan.DCGAN, spatial=t))),
        (tgan.discriminator_plans(dataclasses.replace(tgan.DCGAN,
                                                      spatial=t)),
         jgan.discriminator_plans(dataclasses.replace(jgan.DCGAN,
                                                      spatial=t))),
        (tseg.segnet_plans(dataclasses.replace(tseg.SEGNET, spatial=t)),
         jseg.segnet_plans(dataclasses.replace(jseg.SEGNET, spatial=t))),
        (tuple(tunet.unet_plans(dataclasses.replace(
            tunet.UNET, spatial=t)).values()),
         tuple(junet.unet_plans(dataclasses.replace(
             junet.UNET, spatial=t)).values())),
        (tvae.vae_plans(dataclasses.replace(tvae.VAE, spatial=t)),
         jvae.vae_plans(dataclasses.replace(jvae.VAE, spatial=t))),
    ]
    for tps, jps in pairs:
        assert len(tps) == len(jps)
        for tp, jp in zip(tps, jps):
            got, want = (dataclasses.asdict(tp.spec),
                         dataclasses.asdict(jp.spec))
            got.pop("backend"), want.pop("backend")
            assert got == want and got["spatial"] == t
