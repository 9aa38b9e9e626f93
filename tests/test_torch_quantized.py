"""The port's int8 superpacks against the JAX package's: ``pack`` codes
and scales bit-equal at every single-device site of the golden route
table, ``unpack`` within one grid step, ``as_superpack`` quantizing what it
adapts, the routes of the ``_w8`` sites, every port route (the torch
routes and the 'cuda' route's plain version) against JAX's int8
``plan.apply`` within ``tests/test_quantized.py``'s composed bound, dx and
dscale against ``jax.vjp`` of JAX's int8 plan, and the int8 plain kernel
versions against JAX's Pallas kernels (interpret mode, ``scales=``)."""
import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plan as jplan
from repro.kernels.untangled_conv import (untangled_conv2d_superpack_pallas,
                                          untangled_deconv2d_pallas)
from repro.models.gan import deconv_padding
from repro_torch.core import plan as tplan
from repro_torch.core.untangle import pad_or_crop
from repro_torch.kernels import untangled_conv as tk

from tests.conftest import TOL_GRAD, assert_close, conv_oracle_f64, ulp_bound
from tests.test_quantized import CASES, oracle_pair, scale_to_hwio
from tests.test_quantized import transposed_oracle_f64
from tests.test_torch_compress import HALF_STEP
from tests.test_torch_cuda import CONV_CASES, CASES as DECONV_CASES
from tests.test_torch_cuda import conv_inputs, inputs as deconv_inputs
from tools.gen_route_table import route_specs

FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "route_table.json"

W8_SITES = [(name, spec) for name, spec in route_specs()
            if spec.wdtype == "int8" and spec.spatial == (1, 1)]
W8_IDS = [name for name, _ in W8_SITES]

# test_quantized.py's geometries plus a pixel_shuffle-eligible k4 s2 site
QCASES = CASES + [("transposed", 2, 4, 4, 8, 8, 4, 4, (2, 2), (1, 1),
                   deconv_padding(4, 2))]
# (path, QCASES index): every port route on every case it serves
ROUTES = [(p, i) for i in (0, 1, 2) for p in ("cuda", "fused_tap", "taps")]
ROUTES += [(p, 3) for p in ("cuda", "fused_tap", "fused_plane", "taps")]
ROUTES += [(p, 4) for p in ("cuda", "fused_plane", "taps")]
ROUTES += [(p, 5) for p in ("cuda", "pixel_shuffle", "fused_tap", "taps")]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def port_spec(spec, backend, **change):
    fields = dataclasses.asdict(spec)
    fields.update(backend=backend, **change)
    return tplan.ConvSpec(**fields)


def case_plans(case, backend, jbackend="xla"):
    """(JAX f32 plan, JAX int8 plan, port f32 plan, port int8 plan)."""
    kind, b, h, w, c, n, r, s, strides, dil, pads = case
    jspec = jplan.conv_spec(kind, (b, h, w, c), (r, s, c, n),
                            strides=strides, padding=pads, dilation=dil,
                            backend=jbackend)
    tspec = tplan.conv_spec(kind, (b, h, w, c), (r, s, c, n),
                            strides=strides, padding=pads, dilation=dil,
                            backend=backend)
    return (jplan.plan_conv(jspec),
            jplan.plan_conv(dataclasses.replace(jspec, wdtype="int8")),
            tplan.plan_conv(tspec),
            tplan.plan_conv(dataclasses.replace(tspec, wdtype="int8")))


def case_inputs(case, seed=0):
    kind, b, h, w, c, n, r, s = case[:8]
    rng = np.random.default_rng(seed + sum(map(ord, kind)) + h * w + c)
    return (rng.standard_normal((b, h, w, c)).astype(np.float32),
            rng.standard_normal((r, s, c, n)).astype(np.float32), rng)


def as_port(wq) -> tplan.QuantizedSuperpack:
    return tplan.QuantizedSuperpack(torch.from_numpy(np.array(wq.q)),
                                    torch.from_numpy(np.array(wq.scale)))


def half_step_hwio(pf, wq):
    """Half a grid step per element in HWIO coordinates, through the f32
    twin's ``unpack`` (the scale rows are in superpack row order): the
    round-trip bound ``tests.test_torch_compress.HALF_STEP`` derives."""
    sc = np.asarray(pf.unpack(jnp.broadcast_to(wq.scale, wq.q.shape)),
                    np.float64)
    return HALF_STEP * sc


def forced(plan, path):
    return plan.with_routes(tuple(
        tplan.Route(bb, path, None) for bb in tplan.BATCH_BUCKETS))


# ---------------------------------------------------------------------------
# pack / unpack / as_superpack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,spec", W8_SITES, ids=W8_IDS)
def test_int8_pack_bit_equal_to_jax(name, spec):
    jp = jplan.plan_conv(dataclasses.replace(spec, backend="xla"))
    tp = tplan.plan_conv(port_spec(spec, "torch"))
    r, s = spec.kernel_hw
    k = np.random.default_rng(len(name)).standard_normal(
        (r, s, spec.in_c, spec.out_c)).astype(np.float32)
    wj = jp.pack(k)
    wt = tp.pack(torch.from_numpy(k))
    assert isinstance(wt, tplan.QuantizedSuperpack)
    assert wt.q.dtype == torch.int8 and wt.scale.dtype == torch.float32
    assert np.array_equal(wt.q.numpy(), np.asarray(wj.q))
    assert np.array_equal(wt.scale.numpy(), np.asarray(wj.scale))
    assert wt.shape == tuple(wj.shape) and wt.nbytes() == wj.nbytes()
    # unpack dequantizes, as JAX's, and lands within one grid step
    kd = tp.unpack(wt).numpy()
    assert np.array_equal(kd, np.asarray(jp.unpack(wj)))
    pf = jplan.plan_conv(dataclasses.replace(spec, backend="xla",
                                             wdtype="float32"))
    assert np.all(np.abs(kd.astype(np.float64) - k) <= half_step_hwio(pf, wj))


@pytest.mark.parametrize("case", QCASES, ids=[f"{c[0]}{i}" for i, c in
                                              enumerate(QCASES)])
def test_as_superpack_quantizes_what_it_adapts(case):
    """An int8 plan quantizes an f32 superpack (and, for conv/dilated, a
    4-D HWIO kernel) it is handed; a ``QuantizedSuperpack`` passes through
    as it is; an f32 plan passes a quantized one through too."""
    x, k, _ = case_inputs(case)
    _, jq, tf, tq = case_plans(case, "torch")
    kt = torch.from_numpy(k)
    want = tq.pack(kt)
    for adapted in (tq.as_superpack(tf.pack(kt)),
                    *([tq.as_superpack(kt)] if case[0] != "transposed"
                      else [])):
        assert isinstance(adapted, tplan.QuantizedSuperpack)
        assert torch.equal(adapted.q, want.q)
        assert torch.equal(adapted.scale, want.scale)
    assert tq.as_superpack(want) is want
    assert tf.as_superpack(want) is want
    jw = jq.as_superpack(jnp.asarray(tf.pack(kt).numpy()))
    assert np.array_equal(np.asarray(jw.q), want.q.numpy())


def _fixture_rows(backend):
    table = json.loads(FIXTURE.read_text())
    return {e["name"]: e["routes"] for e in table["entries"]
            if e["backend"] == backend}


@pytest.mark.parametrize("name,spec", W8_SITES, ids=W8_IDS)
def test_w8_routes_equal_fixture_xla_rows(name, spec):
    """Route paths do not depend on ``wdtype``: the int8 sites' 'torch'
    routes are the fixture's 'xla' rows, their 'cuda' routes 'cuda', tiled
    (``sp_tiles``) exactly where the fixture's 'pallas' rows are."""
    want = _fixture_rows("xla")[name]
    tp = tplan.plan_conv(port_spec(spec, "torch"))
    assert [(r.batch, r.path, r.fused_bwd) for r in tp.routes] == \
        [(w["batch"], w["path"], w["fused_bwd"]) for w in want]
    f32 = tplan.plan_conv(port_spec(spec, "torch", wdtype="float32"))
    assert tp.routes == f32.routes
    cp = tplan.plan_conv(port_spec(spec, "cuda"))
    assert [r.path for r in cp.routes] == ["cuda"] * len(tplan.BATCH_BUCKETS)
    assert [r.sp_tiles is not None for r in cp.routes] == \
        [w["sp_tiles"] is not None for w in _fixture_rows("pallas")[name]]


def test_weight_itemsize():
    spec = port_spec(W8_SITES[0][1], "torch")
    assert tplan._weight_itemsize(spec) == 1
    assert tplan._weight_itemsize(
        dataclasses.replace(spec, wdtype="float32")) == 4
    assert tplan._weight_itemsize(
        dataclasses.replace(spec, wdtype="float32", dtype="bfloat16")) == 2


# ---------------------------------------------------------------------------
# forward: every port route within the composed bound, beside JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path,idx", ROUTES,
                         ids=[f"{p}-{QCASES[i][0]}{i}" for p, i in ROUTES])
def test_int8_route_matches_jax_within_composed_bound(path, idx):
    """The port's route on the int8 superpack, JAX's int8 ``plan.apply``
    under 'xla' and under 'pallas' (interpret mode), all within the
    composed bound ``γ-bound(conv(x, K_deq)) + Σ|x|·E_max`` of the f64
    oracle on the original kernel; port and JAX within twice the γ-bound
    of each other (both compute conv(x, K_deq) in f32)."""
    case = QCASES[idx]
    kind, b, h, w, c, n, r, s, strides, dil, pads = case
    x, k, _ = case_inputs(case)
    jf, jq, _, tq = case_plans(case, "cuda" if path == "cuda" else "torch")
    _, jq_pallas, _, _ = case_plans(case, "torch", jbackend="pallas")
    tq = forced(tq, path)
    wq = jq.pack(k)
    launches = tk.untangled_deconv2d.launches_int8 \
        + tk.untangled_conv2d_superpack.launches_int8
    got = tq.apply(torch.from_numpy(x), tq.pack(torch.from_numpy(k)))
    assert launches == tk.untangled_deconv2d.launches_int8 \
        + tk.untangled_conv2d_superpack.launches_int8   # CPU: no launch
    got = got.numpy().astype(np.float64)
    want = {"xla": np.asarray(jq.apply(x, wq), np.float64),
            "pallas": np.asarray(jq_pallas.apply(x, jq_pallas.pack(k)),
                                 np.float64)}
    kd = np.asarray(jq.unpack(wq))
    y64d, amaxd = oracle_pair(kind, x, kd, strides=strides, padding=pads,
                              dilation=dil)
    gamma = ulp_bound(y64d, amaxd, r * s * c)
    y64, _ = oracle_pair(kind, x, k, strides=strides, padding=pads,
                         dilation=dil)
    qterm, _ = oracle_pair(kind, np.abs(x.astype(np.float64)),
                           scale_to_hwio(jf, wq), strides=strides,
                           padding=pads, dilation=dil)
    for y in (got, *want.values()):
        assert y.shape == y64.shape
        assert np.all(np.abs(y - y64d) <= gamma)
        assert np.all(np.abs(y - y64) <= gamma + qterm)
    for y in want.values():
        assert np.all(np.abs(got - y) <= 2 * gamma)


# ---------------------------------------------------------------------------
# backward: dx and dscale against jax.vjp of JAX's int8 plan
# ---------------------------------------------------------------------------

VJP_ROUTES = [("torch", 0), ("cuda", 0), ("torch", 1), ("torch", 2),
              ("cuda", 2), ("torch", 3), ("cuda", 3), ("torch", 4),
              ("torch", 5)]


@pytest.mark.parametrize("backend,idx", VJP_ROUTES,
                         ids=[f"{b}-{QCASES[i][0]}{i}" for b, i in
                              VJP_ROUTES])
def test_int8_vjp_matches_jax(backend, idx):
    """dx and dscale of the port's int8 plan against ``jax.vjp`` of JAX's
    (the codes take no cotangent: float0 in JAX, none in the port)."""
    case = QCASES[idx]
    x, k, rng = case_inputs(case, seed=1)
    _, jq, _, tq = case_plans(case, backend)
    wq = jq.pack(k)
    y_j, vjp = jax.vjp(jq.apply, jnp.asarray(x), wq)
    ct = rng.standard_normal(y_j.shape).astype(np.float32)
    dx_j, dw_j = vjp(jnp.asarray(ct))
    assert dw_j.q.dtype == jax.dtypes.float0
    packed = as_port(wq)
    assert torch.equal(packed.q, tq.pack(torch.from_numpy(k)).q)
    xt = torch.from_numpy(x).requires_grad_()
    scale = packed.scale.clone().requires_grad_()
    y = tq.apply(xt, tplan.QuantizedSuperpack(packed.q, scale))
    dx, dscale = torch.autograd.grad(y, (xt, scale), torch.from_numpy(ct))
    assert_close(y.detach().numpy(), np.asarray(y_j), TOL_GRAD)
    assert_close(dx.numpy(), np.asarray(dx_j), TOL_GRAD)
    assert dscale.shape == scale.shape
    assert_close(dscale.numpy(), np.asarray(dw_j.scale), TOL_GRAD)


def test_int8_codes_get_no_gradient_and_scale_alone_does():
    """Only the scale column asks for a cotangent: the backward then skips
    dx, and dscale is the closed form Σ_n dK·q per row."""
    case = QCASES[0]
    x, k, rng = case_inputs(case, seed=2)
    _, _, tf, tq = case_plans(case, "torch")
    packed = tq.pack(torch.from_numpy(k))
    scale = packed.scale.clone().requires_grad_()
    y = tq.apply(torch.from_numpy(x), tplan.QuantizedSuperpack(packed.q,
                                                              scale))
    ct = torch.from_numpy(rng.standard_normal(tuple(y.shape))
                          .astype(np.float32))
    (dscale,) = torch.autograd.grad(y, (scale,), ct)
    wd = packed.dequant().requires_grad_()
    yf = tf.apply(torch.from_numpy(x), wd)
    (dk,) = torch.autograd.grad(yf, (wd,), ct)
    want = (dk * packed.q.float()).sum(dim=1, keepdim=True)
    assert_close(dscale.numpy(), want.numpy(), TOL_GRAD)
    assert not packed.q.requires_grad


# ---------------------------------------------------------------------------
# the int8 plain kernel versions against JAX's Pallas kernels (scales=)
# ---------------------------------------------------------------------------

def _phase_terms(plan, c):
    (sh, sw) = plan.spec.strides
    terms = np.zeros(plan.out_hw)
    for ex in plan.phases:
        terms[ex.q[0]::sh, ex.q[1]::sw] = ex.taps[0] * ex.taps[1] * c
    return terms[None, :, :, None]


@pytest.mark.parametrize("case", DECONV_CASES, ids=[c[0] for c in
                                                    DECONV_CASES])
def test_deconv_int8_plain_version_matches_pallas(case):
    _, b, h, c, n, k, s, pads = case
    x, kern = deconv_inputs(case)
    spec = jplan.conv_spec("transposed", x.shape, kern.shape, strides=(s, s),
                           padding=pads, backend="pallas", wdtype="int8")
    jp = jplan.plan_conv(spec)
    jf = jplan.plan_conv(dataclasses.replace(spec, wdtype="float32"))
    tp = tplan.plan_conv(port_spec(spec, "cuda"))
    wq = jp.pack(kern)
    route = jp.route_for_batch(b)
    xg = np.pad(x, ((0, 0), *jp.gpad, (0, 0)))
    y_pallas = np.asarray(untangled_deconv2d_pallas(
        jnp.asarray(xg), wq.q, scales=wq.scale, phases=jp.phases,
        out_hw=jp.out_hw, strides=(s, s), sum_uv=jp.sum_uv,
        c_tile=route.tiles[0], n_tile=route.tiles[1], interpret=True))
    packed = tp.pack(torch.from_numpy(kern))
    assert np.array_equal(packed.q.numpy(), np.asarray(wq.q))
    kw = dict(phases=tp.phases, out_hw=tp.out_hw, strides=(s, s),
              sum_uv=tp.sum_uv, scales=packed.scale)
    xg_t = pad_or_crop(torch.from_numpy(x), tp.gpad)
    y_ref = tk.untangled_deconv2d_ref(xg_t, packed.q, **kw).numpy()
    y_wrap = tk.untangled_deconv2d(xg_t, packed.q, **kw).numpy()
    kd = np.asarray(jf.unpack(wq.dequant()))
    y64, amax = transposed_oracle_f64(x, kd, strides=(s, s), padding=pads)
    bound = ulp_bound(y64, amax, _phase_terms(tp, c))
    for got in (y_pallas, y_ref, y_wrap):
        assert np.all(np.abs(got.astype(np.float64) - y64) <= bound)
    assert_close(y_ref, y_pallas)
    assert np.array_equal(y_ref, y_wrap)


@pytest.mark.parametrize("case", CONV_CASES, ids=[c[0] for c in CONV_CASES])
def test_conv_int8_plain_version_matches_pallas(case):
    _, b, h, c, n, k, s, d, pads = case
    x, kern = conv_inputs(case)
    xp = np.pad(x, ((0, 0), *pads, (0, 0)))
    w = kern.reshape(k * k * c, n)
    w[c] = 0.0                          # an all-zero superpack row
    from repro.runtime.compress import quantize_int8_rows
    q_j, s_j = quantize_int8_rows(jnp.asarray(w))
    kw = dict(taps_hw=(k, k), strides=(s, s), rhs_dilation=(d, d))
    y_pallas = np.asarray(untangled_conv2d_superpack_pallas(
        jnp.asarray(xp), q_j, scales=s_j, interpret=True, **kw))
    q, scale = (torch.from_numpy(np.array(a)) for a in (q_j, s_j))
    xt = torch.from_numpy(xp)
    y_ref = tk.untangled_conv2d_superpack_ref(xt, q, scales=scale,
                                              **kw).numpy()
    y_wrap = tk.untangled_conv2d_superpack(xt, q, scales=scale, **kw).numpy()
    kd = (np.asarray(q_j, np.float32) * np.asarray(s_j)).reshape(k, k, c, n)
    y64, amax = conv_oracle_f64(x, kd, strides=(s, s), dilation=(d, d),
                                padding=pads)
    bound = ulp_bound(y64, amax, k * k * c)
    for got in (y_pallas, y_ref, y_wrap):
        assert np.all(np.abs(got.astype(np.float64) - y64) <= bound)
    assert_close(y_ref, y_pallas)
    assert np.array_equal(y_ref, y_wrap)


def test_int8_wrappers_check_their_scales():
    q = torch.zeros((27, 8), dtype=torch.int8, device="meta")
    x = torch.empty((1, 9, 9, 3), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tk.untangled_conv2d_superpack(x, q, taps_hw=(3, 3),
                                      scales=torch.empty((27, 1),
                                                         device="meta"))
    with pytest.raises(TypeError, match="int8"):
        tk._check_weights("kernel B", q.float(), torch.empty((27, 1)))
    with pytest.raises(ValueError, match="scales"):
        tk._check_weights("kernel B", q, torch.empty((27,)))
    with pytest.raises(TypeError, match="float32"):
        tk._check_weights("kernel B", q, None)


@pytest.mark.parametrize("source,symbol,argtypes", [
    ("untangled_deconv", "untangled_deconv2d_i8", tk._ARGTYPES_I8),
    ("untangled_conv", "untangled_conv2d_i8", tk._CONV_ARGTYPES_I8),
])
def test_int8_ctypes_bindings_match_the_c_entries(source, symbol, argtypes):
    """The int8 entries' argtypes follow their C signatures: every pointer
    (codes, scales, the stream) ``c_void_p``, every int ``c_int``; the
    codes are ``int8_t*`` and the scale column follows them."""
    import ctypes
    import re
    src = (pathlib.Path(tk.__file__).parent / "csrc"
           / f"{source}.cu").read_text()
    sig = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', src).group(1)
    params = [p.strip() for p in sig.split(",")]
    assert params[1].startswith("const int8_t*")
    assert params[2].startswith("const float* scale")
    want = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params]
    assert argtypes == want
