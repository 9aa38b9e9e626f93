"""The port's plans against the JAX package's: geometry field by field,
bit-equal superpacks, and route verdicts (the 'cuda' routes tiled exactly
where the fixture's 'pallas' rows are), over every transposed, conv and
dilated site of the golden route table (``tools/gen_route_table.py``)."""
import dataclasses
import json
import pathlib
import warnings

import numpy as np
import pytest
import torch

from repro.core import plan as jplan
from repro_torch.core import plan as tplan
from repro_torch.core.autotune import AutotunePolicy

from tools.gen_route_table import route_specs

FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "route_table.json"


def transposed_sites():
    """The f32, single-device transposed sites the port covers."""
    return [(name, spec) for name, spec in route_specs()
            if spec.kind == "transposed" and spec.wdtype == "float32"
            and spec.spatial == (1, 1)]


def single_sites():
    """The f32, single-device 'conv'/'dilated' sites the port covers."""
    return [(name, spec) for name, spec in route_specs()
            if spec.kind in ("conv", "dilated")
            and spec.wdtype == "float32" and spec.spatial == (1, 1)]


SITES = transposed_sites()
SITE_IDS = [name for name, _ in SITES]
SINGLE_SITES = single_sites()
SINGLE_IDS = [name for name, _ in SINGLE_SITES]


def port_spec(spec, backend):
    fields = dataclasses.asdict(spec)
    fields["backend"] = backend
    return tplan.ConvSpec(**fields)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("name,spec", SITES, ids=SITE_IDS)
def test_geometry_and_superpack_match_jax(name, spec):
    jp = jplan.plan_conv(dataclasses.replace(spec, backend="xla"))
    tp = tplan.plan_conv(port_spec(spec, "torch"))
    assert dataclasses.asdict(tp.spec) == {
        **dataclasses.asdict(jp.spec), "backend": "torch"}
    for field in ("out_hw", "gpad", "total_taps", "sum_uv", "uniform",
                  "bwd_pad", "dx_taps"):
        assert getattr(tp, field) == getattr(jp, field), field
    assert [dataclasses.asdict(ex) for ex in tp.phases] == \
        [dataclasses.asdict(ex) for ex in jp.phases]
    r, s = spec.kernel_hw
    k = np.random.default_rng(len(name)).standard_normal(
        (r, s, spec.in_c, spec.out_c)).astype(np.float32)
    packed_j = np.asarray(jp.pack(k))
    packed_t = tp.pack(torch.from_numpy(k))
    np.testing.assert_array_equal(packed_t.numpy(), packed_j)
    np.testing.assert_array_equal(tp.unpack(packed_t).numpy(), k)


def _fixture_rows(backend):
    table = json.loads(FIXTURE.read_text())
    return {e["name"]: e["routes"] for e in table["entries"]
            if e["backend"] == backend}


@pytest.mark.parametrize("name,spec", SITES, ids=SITE_IDS)
def test_torch_routes_equal_fixture_xla_rows(name, spec):
    want = _fixture_rows("xla")[name]
    tp = tplan.plan_conv(port_spec(spec, "torch"))
    assert [(r.batch, r.path) for r in tp.routes] == \
        [(w["batch"], w["path"]) for w in want]
    assert all(r.tiles is None and r.sp_tiles is None and r.dev_tiles is None
               for r in tp.routes)


def assert_tiled_where_the_fixture_is(routes, pallas_rows):
    """'cuda' routes carry the card's block tile (``sp_tiles``) exactly at
    the buckets where the fixture's 'pallas' rows take the reference's
    tiled kernel, and never a VMEM tile or a device tiling."""
    assert [r.sp_tiles is not None for r in routes] == \
        [w["sp_tiles"] is not None for w in pallas_rows]
    assert all(r.tiles is None and r.dev_tiles is None for r in routes)


@pytest.mark.parametrize("name,spec", SITES, ids=SITE_IDS)
def test_cuda_routes_at_every_bucket(name, spec):
    tp = tplan.plan_conv(port_spec(spec, "cuda"))
    assert [r.path for r in tp.routes] == ["cuda"] * len(tplan.BATCH_BUCKETS)
    assert_tiled_where_the_fixture_is(tp.routes,
                                      _fixture_rows("pallas")[name])
    # beyond the largest bucket: an exactly sized, memoized route
    assert tp.route_for_batch(100).path == "cuda"
    assert tp.route_for_batch(100) is tp.route_for_batch(100)


def test_auto_backend_follows_the_card():
    spec = port_spec(SITES[0][1], "auto")
    want = "cuda" if torch.cuda.is_available() else "fused_tap"
    assert tplan.plan_conv(spec).path == want


def test_unpack_pack_roundtrip_odd_geometry():
    """Stride 3 > kernel 2 (an empty phase), asymmetric pads, odd strides."""
    for (h, w, r, s, strides, pads) in [(4, 5, 2, 2, (3, 3), ((1, 1), (1, 1))),
                                        (5, 4, 5, 4, (2, 3),
                                         ((2, 2), (1, 1)))]:
        k = torch.from_numpy(np.random.default_rng(h).standard_normal(
            (r, s, 3, 2)).astype(np.float32))
        plan = tplan.plan_conv(tplan.conv_spec(
            "transposed", (1, h, w, 3), k.shape, strides=strides,
            padding=pads, backend="torch"))
        packed = plan.pack(k)
        assert packed.shape == (plan.total_taps * 3, 2)
        assert torch.equal(plan.unpack(packed), k)
        legacy = {ex.key: packed[ex.tap_off * 3:(ex.tap_off + ex.taps[0]
                                                 * ex.taps[1]) * 3]
                  for ex in plan.phases if ex.taps[0] * ex.taps[1]}
        assert torch.equal(plan.as_superpack(legacy), packed)
        jp = jplan.plan_conv(jplan.conv_spec(
            "transposed", (1, h, w, 3), k.shape, strides=strides,
            padding=pads))
        np.testing.assert_array_equal(np.asarray(jp.pack(k.numpy())),
                                      packed.numpy())


@pytest.mark.parametrize("name,spec", SINGLE_SITES, ids=SINGLE_IDS)
def test_single_geometry_and_superpack_match_jax(name, spec):
    jp = jplan.plan_conv(dataclasses.replace(spec, backend="xla"))
    tp = tplan.plan_conv(port_spec(spec, "torch"))
    for field in ("out_hw", "gpad", "total_taps", "sum_uv", "uniform",
                  "bwd_pad", "dx_taps"):
        assert getattr(tp, field) == getattr(jp, field), field
    assert [dataclasses.asdict(ex) for ex in tp.phases] == \
        [dataclasses.asdict(ex) for ex in jp.phases]
    r, s = spec.kernel_hw
    k = np.random.default_rng(len(name)).standard_normal(
        (r, s, spec.in_c, spec.out_c)).astype(np.float32)
    packed_t = tp.pack(torch.from_numpy(k))
    np.testing.assert_array_equal(packed_t.numpy(), np.asarray(jp.pack(k)))
    np.testing.assert_array_equal(tp.unpack(packed_t).numpy(), k)
    # a 4-D HWIO kernel adapts onto the superpack (the free flatten)
    assert torch.equal(tp.as_superpack(torch.from_numpy(k)), packed_t)


@pytest.mark.parametrize("name,spec", SINGLE_SITES, ids=SINGLE_IDS)
def test_single_routes_equal_fixture_rows(name, spec):
    """'torch' routes are the fixture's 'xla' rows (path and fused_bwd per
    bucket); 'cuda' routes are 'cuda' with the 'pallas' rows' fused_bwd."""
    xla, pallas = _fixture_rows("xla")[name], _fixture_rows("pallas")[name]
    tp = tplan.plan_conv(port_spec(spec, "torch"))
    assert [(r.batch, r.path, r.fused_bwd) for r in tp.routes] == \
        [(w["batch"], w["path"], w["fused_bwd"]) for w in xla]
    cp = tplan.plan_conv(port_spec(spec, "cuda"))
    assert [(r.batch, r.path, r.fused_bwd) for r in cp.routes] == \
        [(w["batch"], "cuda", w["fused_bwd"]) for w in pallas]
    assert all(r.tiles is None and r.sp_tiles is None and r.dev_tiles is None
               for r in tp.routes)
    assert_tiled_where_the_fixture_is(cp.routes, pallas)
    # beyond the largest bucket: an exactly sized, memoized route with the
    # verdict JAX gives that batch
    jp = jplan.plan_conv(dataclasses.replace(spec, backend="xla"))
    for plan in (tp, cp):
        big = plan.route_for_batch(100)
        assert big is plan.route_for_batch(100) and big.batch == 100
        assert big.fused_bwd == jp.route_for_batch(100).fused_bwd
    jpp = jplan.plan_conv(dataclasses.replace(spec, backend="pallas"))
    assert (cp.route_for_batch(100).sp_tiles is None) == \
        (jpp.route_for_batch(100).sp_tiles is None)


@pytest.mark.parametrize("change,exc", [
    ({"kind": "conv", "spatial": (2, 1)}, None),
    ({"kind": "dilated", "dilation": (2, 2), "wdtype": "int8",
      "spatial": (2, 1)}, None),
    ({"spatial": (2, 1)}, None),
    ({"wdtype": "int4"}, ValueError),
    ({"backend": "pallas"}, ValueError),
])
def test_unported_specs_raise(change, exc):
    """Unknown wdtypes and backends are refused; device tiling is ported
    (``core.spatial``): such a spec plans, its routes those of its (1, 1)
    twin but for the ``dev_tiles`` verdict."""
    spec = dataclasses.replace(port_spec(SITES[0][1], "torch"), **change)
    if exc is not None:
        with pytest.raises(exc):
            tplan.plan_conv(spec)
        return
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # infeasible tiling
        plan = tplan.plan_conv(spec)
    twin = tplan.plan_conv(dataclasses.replace(spec, spatial=(1, 1)))
    assert [dataclasses.replace(r, dev_tiles=None) for r in plan.routes] \
        == list(twin.routes)


def test_autotune_argument_raises():
    """Anything but an ``AutotunePolicy`` (or None) is refused; a policy
    gives the tuned sibling plan."""
    spec = port_spec(SITES[0][1], "torch")
    with pytest.raises(TypeError, match="AutotunePolicy"):
        tplan.plan_conv(spec, autotune=object())
    tuned = tplan.plan_conv(spec, autotune=AutotunePolicy(
        mode="cache", cache_path=""))
    assert tuned.tuned and tuned.routes == tplan.plan_conv(spec).routes


def test_apply_checks_input_shape():
    plan = tplan.plan_conv(port_spec(SITES[0][1], "torch"))
    with pytest.raises(ValueError, match="does not match plan spec"):
        plan.apply(torch.zeros(1, 5, 5, plan.spec.in_c),
                   torch.zeros(plan.total_taps * plan.spec.in_c,
                               plan.spec.out_c))
