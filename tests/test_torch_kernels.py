"""Kernels A's and B's plain versions and the port's torch routes against
the JAX package: ``untangled_deconv2d_pallas`` and
``untangled_conv2d_superpack_pallas`` in interpret mode (as the JAX suite
runs them), JAX's own routes, and the float64 oracle's ULP bound.  The
card-side checks of the CUDA kernels are in ``tests/test_torch_cuda.py``."""
import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plan as jplan
from repro.kernels.untangled_conv import (untangled_conv2d_superpack_pallas,
                                          untangled_deconv2d_pallas)
from repro_torch.core import plan as tplan
from repro_torch.core import reference as tref
from repro_torch.core.untangle import pad_or_crop
from repro_torch.kernels import untangled_conv as tk

from tests.conftest import assert_close, conv_oracle_f64, ulp_bound
from tests.test_quantized import transposed_oracle_f64
from tests.test_torch_cuda import (CASE_IDS, CASES, CONV_CASES, conv_inputs,
                                   inputs)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def plans(case, backend):
    _, b, h, c, n, k, s, pads = case
    jb = {"cuda": "pallas", "torch": "xla"}[backend]
    jp = jplan.plan_conv(jplan.conv_spec(
        "transposed", (b, h, h, c), (k, k, c, n), strides=(s, s),
        padding=pads, backend=jb))
    tp = tplan.plan_conv(tplan.conv_spec(
        "transposed", (b, h, h, c), (k, k, c, n), strides=(s, s),
        padding=pads, backend=backend))
    return jp, tp


def phase_terms(plan, c):
    """Per-output-element term count T_h·T_w·C of its phase, (1, OH, OW, 1)."""
    (sh, sw) = plan.spec.strides
    terms = np.zeros(plan.out_hw)
    for ex in plan.phases:
        terms[ex.q[0]::sh, ex.q[1]::sw] = ex.taps[0] * ex.taps[1] * c
    return terms[None, :, :, None]


def assert_within_ulp(got, y64, amax, terms):
    err = np.abs(np.asarray(got, np.float64) - y64)
    bound = ulp_bound(y64, amax, terms)
    assert np.all(err <= bound), float(np.max(err - bound))


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_kernel_plain_version_matches_pallas_and_oracle(case):
    _, b, h, c, n, k, s, pads = case
    x, kern = inputs(case)
    jp, tp = plans(case, "cuda")
    # JAX: the Pallas kernel in interpret mode on the same superpack
    route = jp.route_for_batch(b)
    packed_j = jp.pack(kern)
    xg_j = jnp.pad(x, ((0, 0), *jp.gpad, (0, 0)))
    y_pallas = np.asarray(untangled_deconv2d_pallas(
        xg_j, packed_j, phases=jp.phases, out_hw=jp.out_hw, strides=(s, s),
        sum_uv=jp.sum_uv, c_tile=route.tiles[0], n_tile=route.tiles[1],
        interpret=True))
    # the port: the plain version and the wrapper on CPU tensors
    packed_t = tp.pack(torch.from_numpy(kern))
    np.testing.assert_array_equal(packed_t.numpy(), np.asarray(packed_j))
    xg_t = pad_or_crop(torch.from_numpy(x), tp.gpad)
    kw = dict(phases=tp.phases, out_hw=tp.out_hw, strides=(s, s),
              sum_uv=tp.sum_uv)
    launches = tk.untangled_deconv2d.launches
    y_ref = tk.untangled_deconv2d_ref(xg_t, packed_t, **kw).numpy()
    y_wrap = tk.untangled_deconv2d(xg_t, packed_t, **kw).numpy()
    assert tk.untangled_deconv2d.launches == launches   # CPU: no launch
    y64, amax = transposed_oracle_f64(x, kern, strides=(s, s), padding=pads)
    terms = phase_terms(tp, c)
    for got in (y_pallas, y_ref, y_wrap):
        assert got.shape == y64.shape
        assert_within_ulp(got, y64, amax, terms)
    assert_close(y_ref, y_pallas)
    # phases with no taps come out exactly zero
    for ex in tp.phases:
        if ex.taps[0] * ex.taps[1] == 0:
            assert not y_wrap[:, ex.q[0]::s, ex.q[1]::s].any()


def test_port_oracle_harness_matches_conftest():
    """The port's f64 oracle and ULP bound (what ``chip_smoke.py`` holds
    the card to) are the JAX suite's, number for number."""
    case = CASES[2]
    _, b, h, c, n, k, s, pads = case
    x, kern = inputs(case)
    y64, amax = transposed_oracle_f64(x, kern, strides=(s, s), padding=pads)
    ty64, tamax = tref.conv_oracle_f64(
        tref.zero_insert(torch.from_numpy(x), (s, s)), kern, padding=pads)
    np.testing.assert_allclose(ty64.numpy(), y64, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tamax.numpy(), amax, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        tref.ulp_bound(ty64, tamax, 25 * c).numpy(),
        ulp_bound(y64, amax, 25 * c), rtol=1e-12)
    # the float32 references agree with the f64 oracle too
    xt, kt = torch.from_numpy(x), torch.from_numpy(kern)
    for fn in (tref.oracle_conv_transpose2d, tref.naive_conv_transpose2d):
        got = fn(xt, kt, strides=(s, s), padding=pads).numpy()
        assert_within_ulp(got, y64, amax, 25 * c)


def test_library_yardstick_mapping():
    """``chip_smoke.library_args`` (the flip, the (C_in, C_out, kH, kW)
    layout, padding R-1-lo and output_padding hi-lo) turns
    ``F.conv_transpose2d`` into the port's transposed conv."""
    import chip_smoke
    for case in (CASES[0], CASES[2]):
        _, b, h, c, n, k, s, pads = case
        x, kern = inputs(case)
        xl, wl, kw = chip_smoke.library_args(
            torch.from_numpy(x), torch.from_numpy(kern), (s, s), pads)
        got = torch.nn.functional.conv_transpose2d(xl, wl, **kw)
        y64, amax = transposed_oracle_f64(x, kern, strides=(s, s),
                                          padding=pads)
        assert_within_ulp(got.permute(0, 2, 3, 1).numpy(), y64, amax,
                          k * k * c)
    with pytest.raises(ValueError):     # output_padding would reach stride
        chip_smoke.library_args(torch.zeros(1, 8, 8, 2),
                                torch.zeros(4, 4, 2, 2), (2, 2),
                                ((1, 3), (1, 3)))


ROUTE_CASES = [
    ("fused_tap", CASES[0]), ("fused_tap", CASES[1]),
    ("fused_plane", CASES[0]), ("fused_plane", CASES[2]),
    ("fused_plane", CASES[3]),
    ("pixel_shuffle", CASES[1]),
    ("taps", CASES[0]), ("taps", CASES[2]), ("taps", CASES[3]),
    ("taps", CASES[4]),
]


@pytest.mark.parametrize("path,case", ROUTE_CASES,
                         ids=[f"{p}-{c[0]}" for p, c in ROUTE_CASES])
def test_torch_route_matches_jax_route(path, case):
    _, b, h, c, n, k, s, pads = case
    x, kern = inputs(case)
    jp, tp = plans(case, "torch")
    jp = jp.with_routes(tuple(jplan.Route(bb, path, None)
                              for bb in jplan.BATCH_BUCKETS))
    tp = tp.with_routes(tuple(tplan.Route(bb, path, None)
                              for bb in tplan.BATCH_BUCKETS))
    want = np.asarray(jp.apply(x, jp.pack(kern)))
    got = tp.apply(torch.from_numpy(x), tp.pack(torch.from_numpy(kern)))
    assert got.shape == want.shape
    assert_close(got.numpy(), want)


def test_cuda_route_on_cpu_runs_plain_version_and_differentiates():
    """Under backend='cuda' a CPU tensor takes the kernel's plain version
    (no launch), and the route differentiates through ``_PlannedTransposed``."""
    case = CASES[0]
    _, b, h, c, n, k, s, pads = case
    x, kern = inputs(case)
    jp, tp = plans(case, "cuda")
    assert tp.path == "cuda"
    xt = torch.from_numpy(x).requires_grad_()
    launches = tk.untangled_deconv2d.launches
    y = tp.apply(xt, tp.pack(torch.from_numpy(kern)))
    assert tk.untangled_deconv2d.launches == launches
    y64, amax = transposed_oracle_f64(x, kern, strides=(s, s), padding=pads)
    assert_within_ulp(y.detach().numpy(), y64, amax, phase_terms(tp, c))
    y.sum().backward()
    assert xt.grad is not None and xt.grad.shape == xt.shape


def test_wrapper_refuses_non_cpu_non_cuda_tensors():
    """Off the CPU the wrapper launches the kernel or raises: a tensor on
    another device never falls back to the plain version."""
    case = CASES[0]
    _, b, h, c, n, k, s, pads = case
    _, tp = plans(case, "cuda")
    hg = h + sum(tp.gpad[0])
    xg = torch.empty((b, hg, hg, c), device="meta")
    sp = torch.empty((tp.total_taps * c, n), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tk.untangled_deconv2d(xg, sp, phases=tp.phases, out_hw=tp.out_hw,
                              strides=(s, s), sum_uv=tp.sum_uv)
    with pytest.raises(ValueError, match="phases"):
        tk.untangled_deconv2d(xg, sp, phases=tp.phases[:2],
                              out_hw=tp.out_hw, strides=(s, s),
                              sum_uv=tp.sum_uv)


def test_kernel_tile_choice():
    """Kernel B's tile: thin N takes the 128x16 tile; the 128x128 tile only
    when it alone fills the card (DC1's rows at B=64), else the M tile
    follows the rows; BN follows N."""
    dc1 = tplan.plan_conv(tplan.conv_spec(
        "transposed", (1, 4, 4, 1024), (5, 5, 1024, 512), strides=(2, 2),
        padding=((2, 3), (2, 3)), backend="cuda"))
    def rows(b):
        return sum(b * ex.out_hw[0] * ex.out_hw[1] for ex in dc1.phases)
    k = 25 * 1024
    assert tk.conv_schedule(rows(64), k, 512).tile == (128, 128)
    small = tk.conv_schedule(rows(1), k, 512).tile
    assert small[0] < 128 and small[1] == 128
    assert tk.conv_schedule(rows(64), k, 3).tile == (128, 16)
    assert tk.conv_schedule(rows(64), k, 64).tile[1] == 64


def test_ctypes_binding_matches_the_c_entry():
    """The wrapper's argtypes follow the C signature in the source: every
    pointer (and the stream) is ``c_void_p``, every int ``c_int``."""
    import ctypes
    import re
    src = (pathlib.Path(tk.__file__).parent / "csrc"
           / "untangled_deconv.cu").read_text()
    sig = re.search(r'extern "C" int untangled_deconv2d_f32\(([^)]*)\)',
                    src).group(1)
    params = [p.strip() for p in sig.split(",")]
    want = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params]
    assert all("*" in p or p.startswith("int ") for p in params)
    assert tk._ARGTYPES == want


def test_ieee_fp32_turns_tf32_off_and_restores():
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    try:
        with tref.ieee_fp32():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def test_kernel_spec_fields_match_jax_spec_fields():
    """``ConvSpec`` keeps every field of JAX's, in order."""
    assert [f.name for f in dataclasses.fields(tplan.ConvSpec)] == \
        [f.name for f in dataclasses.fields(jplan.ConvSpec)]


# ---------------------------------------------------------------------------
# kernel B: the single correlation on the superpack
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", CONV_CASES, ids=[c[0] for c in CONV_CASES])
def test_conv_kernel_plain_version_matches_pallas_and_oracle(case):
    """Kernel B's plain version and its wrapper on CPU tensors against
    ``untangled_conv2d_superpack_pallas`` in interpret mode, all within the
    f64 oracle's ULP bound (n_terms = R·S·C)."""
    _, b, h, c, n, k, s, d, pads = case
    x, kern = conv_inputs(case)
    xp = np.pad(x, ((0, 0), *pads, (0, 0)))
    packed = kern.reshape(k * k * c, n)
    kw = dict(taps_hw=(k, k), strides=(s, s), rhs_dilation=(d, d))
    y_pallas = np.asarray(untangled_conv2d_superpack_pallas(
        jnp.asarray(xp), jnp.asarray(packed), interpret=True, **kw))
    xt, pt = torch.from_numpy(xp), torch.from_numpy(packed)
    launches = tk.untangled_conv2d_superpack.launches
    y_ref = tk.untangled_conv2d_superpack_ref(xt, pt, **kw).numpy()
    y_wrap = tk.untangled_conv2d_superpack(xt, pt, **kw).numpy()
    y_hwio = tk.untangled_conv2d(xt, torch.from_numpy(kern),
                                 strides=(s, s), rhs_dilation=(d, d)).numpy()
    assert tk.untangled_conv2d_superpack.launches == launches  # CPU: none
    y64, amax = conv_oracle_f64(x, kern, strides=(s, s), dilation=(d, d),
                                padding=pads)
    for got in (y_pallas, y_ref, y_wrap, y_hwio):
        assert got.shape == y64.shape
        assert_within_ulp(got, y64, amax, k * k * c)
    assert_close(y_ref, y_pallas)
    # the port's own f64 oracle is the suite's, number for number
    ty64, tamax = tref.conv_oracle_f64(torch.from_numpy(x), kern,
                                       strides=(s, s), dilation=(d, d),
                                       padding=pads)
    np.testing.assert_allclose(ty64.numpy(), y64, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tamax.numpy(), amax, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("case", CONV_CASES[:3], ids=[c[0] for c in
                                                      CONV_CASES[:3]])
def test_conv_references_match_oracle(case):
    """The port's float32 single-kind references (``oracle_dilated_conv2d``
    / ``oracle_conv2d`` through ``F.conv2d`` with TF32 off, and the
    DarkNet-style ``naive_dilated_conv2d``) sit within the ULP bound."""
    _, b, h, c, n, k, s, d, pads = case
    x, kern = conv_inputs(case)
    y64, amax = conv_oracle_f64(x, kern, strides=(s, s), dilation=(d, d),
                                padding=pads)
    xt, kt = torch.from_numpy(x), torch.from_numpy(kern)
    got = [tref.oracle_dilated_conv2d(xt, kt, dilation=(d, d),
                                      strides=(s, s), padding=pads),
           tref.naive_dilated_conv2d(xt, kt, dilation=(d, d),
                                     strides=(s, s), padding=pads)]
    if d == 1:
        got.append(tref.oracle_conv2d(xt, kt, strides=(s, s), padding=pads))
    for y in got:
        assert_within_ulp(y.numpy(), y64, amax, k * k * c)
    dk = tref.dilate_kernel(kt, (2, 3))
    assert dk.shape == ((k - 1) * 2 + 1, (k - 1) * 3 + 1, c, n)
    assert torch.equal(dk[::2, ::3], kt) and int(dk.ne(0).sum()) == \
        int(kt.ne(0).sum())


def test_conv_wrapper_checks_shapes_and_devices():
    """Off the CPU kernel B launches or raises; mismatched shapes raise."""
    x = torch.empty((1, 9, 9, 4), device="meta")
    sp = torch.empty((25 * 4, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tk.untangled_conv2d_superpack(x, sp, taps_hw=(5, 5), strides=(2, 2))
    with pytest.raises(ValueError, match="rows"):
        tk.untangled_conv2d_superpack(x, sp, taps_hw=(3, 3))
    with pytest.raises(ValueError, match="no valid output"):
        tk.untangled_conv2d_superpack(x, sp, taps_hw=(5, 5),
                                      rhs_dilation=(3, 3))
    assert tk.conv_schedule(64 * 16 * 16, 25 * 128,
                            256).tile == (128, 128)      # D2 at B=64
    assert tk.conv_schedule(16, 25 * 512, 1024).tile == (16, 128)  # D4, B=1
    assert tk.conv_schedule(1024, 9 * 32, 3).tile == (128, 16)


def test_conv_ctypes_binding_matches_the_c_entry():
    """Kernel B's argtypes follow the C signature in its source."""
    import ctypes
    import re
    src = (pathlib.Path(tk.__file__).parent / "csrc"
           / "untangled_conv.cu").read_text()
    sig = re.search(r'extern "C" int untangled_conv2d_f32\(([^)]*)\)',
                    src).group(1)
    params = [p.strip() for p in sig.split(",")]
    want = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params]
    assert all("*" in p or p.startswith("int ") for p in params)
    assert tk._CONV_ARGTYPES == want
    from repro_torch.kernels import _build
    assert set(_build.SOURCES) == {"untangled_deconv", "untangled_conv",
                                   "untangled_conv_tiled",
                                   "untangled_deconv_tiled",
                                   "flash_attention"}


def test_conv_library_yardstick_and_sites():
    """``chip_smoke.conv_library_args`` turns ``F.conv2d`` into kernel B's
    valid correlation of the pre-padded plane, and ``chip_smoke.disc_sites``
    lists exactly the DCGAN and cGAN discriminator plans' geometry."""
    import chip_smoke
    from repro_torch.models import gan as tgan
    for case in (CONV_CASES[0], CONV_CASES[3]):
        _, b, h, c, n, k, s, d, pads = case
        x, kern = conv_inputs(case)
        xp = torch.from_numpy(np.pad(x, ((0, 0), *pads, (0, 0))))
        xl, wl, kw = chip_smoke.conv_library_args(
            xp, torch.from_numpy(kern), (s, s), (d, d))
        got = torch.nn.functional.conv2d(xl, wl, **kw).permute(0, 2, 3, 1)
        y64, amax = conv_oracle_f64(x, kern, strides=(s, s),
                                    dilation=(d, d), padding=pads)
        assert_within_ulp(got.numpy(), y64, amax, k * k * c)
    want = []
    for layers in (tgan.DCGAN_LAYERS, tgan.CGAN_LAYERS):
        cfg = tgan.GANConfig("g", layers)
        want += [(p.spec.in_hw[0], p.spec.in_c, p.spec.out_c,
                  p.spec.kernel_hw[0], p.spec.strides[0], p.spec.padding)
                 for p in tgan.discriminator_plans(cfg)]
    assert [site[1:] for site in chip_smoke.disc_sites()] == want
