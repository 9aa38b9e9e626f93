"""Kernels C's and D's plain versions and the port's tiled route verdict
against the JAX package.

- The tiled plain versions (the CPU side of ``sp_tiles=`` on both kernel
  wrappers) against JAX's spatially tiled Pallas kernels in interpret mode
  at every ``tests/test_tiled_kernels.py`` geometry, f32 and int8 (JAX's
  ``scales=`` path): both within the f64 oracle's ULP bound, and within
  ``TOL_FWD`` of each other.  Never bit for bit: JAX's own tiled kernels
  are not bit-equal to its whole-plane ones (the six seed failures of
  ``tests/test_tiled_kernels.py``), and sums in another order differ at
  the 1e-6 level.
- ``halo_extent`` and ``deconv_tap_span`` equal JAX's at every U-Net and
  fixture site; kernel D refuses non-uniform phases.
- The 'cuda' routes carry the card's block tile exactly where JAX's
  ``'pallas'`` policy takes its tiled kernel: at every ``UNetConfig(
  image_hw=512)`` site and bucket, f32 and int8, live against
  ``plan_conv``; with both packages' budget constants shrunk, at the
  ``UNET_TINY`` sites.  (The fixture rows are held in
  ``tests/test_torch_plan.py``.)
- The card's block tiles fit one block's shared memory."""
import contextlib
import ctypes
import dataclasses
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plan as jplan
from repro.kernels import untangled_conv as jk
from repro.models import unet as junet
from repro.runtime.compress import dequantize_int8 as jdequant
from repro.runtime.compress import quantize_int8_rows as jquant
from repro_torch.core import plan as tplan
from repro_torch.kernels import untangled_conv as tk

from tests.conftest import (TOL_FWD, assert_close, conv_oracle_f64,
                            ulp_bound, vmem_budget)
from tests.test_quantized import transposed_oracle_f64
from tests.test_tiled_kernels import DECONV_CASES, SINGLE_CASES
from tools.gen_route_table import route_specs

UNET_512 = junet.UNetConfig("unet-512", image_hw=512)


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


def _rng(case):
    return np.random.default_rng(abs(hash(repr(case))) % (2 ** 31))


def _int8_of(sp):
    """(q, scale, dequantized) of an f32 superpack by JAX's quantizer."""
    q, scale = jquant(jnp.asarray(sp))
    return (np.array(q), np.array(scale),
            np.array(jdequant(q, scale), np.float32))


def assert_within_ulp(got, y64, amax, terms):
    err = np.abs(np.asarray(got, np.float64) - y64)
    assert np.all(err <= ulp_bound(y64, amax, terms))


# ---------------------------------------------------------------------------
# the tiled plain versions against JAX's tiled Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wdtype", ["float32", "int8"])
@pytest.mark.parametrize("case", SINGLE_CASES,
                         ids=[f"single{i}" for i in range(len(SINGLE_CASES))])
def test_tiled_conv_plain_version_matches_pallas(case, wdtype):
    b, hp, wp, c, n, r, s, strides, dil, c_t, n_t, sp_tiles = case
    rng = _rng(case)
    x = rng.standard_normal((b, hp, wp, c)).astype(np.float32)
    sp = rng.standard_normal((r * s * c, n)).astype(np.float32)
    kw = dict(taps_hw=(r, s), strides=strides, rhs_dilation=dil,
              sp_tiles=sp_tiles)
    if wdtype == "int8":
        q, scale, wd = _int8_of(sp)
        want = jk.untangled_conv2d_superpack_pallas(
            jnp.asarray(x), jnp.asarray(q), scales=jnp.asarray(scale),
            c_tile=c_t, n_tile=n_t, interpret=True, **kw)
        got = tk.untangled_conv2d_superpack(
            torch.from_numpy(x), torch.from_numpy(q),
            scales=torch.from_numpy(scale), **kw)
    else:
        wd = sp
        want = jk.untangled_conv2d_superpack_pallas(
            jnp.asarray(x), jnp.asarray(sp), c_tile=c_t, n_tile=n_t,
            interpret=True, **kw)
        got = tk.untangled_conv2d_superpack(torch.from_numpy(x),
                                            torch.from_numpy(sp), **kw)
    y64, amax = conv_oracle_f64(x, wd.reshape(r, s, c, n), strides=strides,
                                dilation=dil)
    assert got.shape == want.shape == y64.shape
    assert_within_ulp(got.numpy(), y64, amax, r * s * c)
    assert_within_ulp(np.asarray(want), y64, amax, r * s * c)
    assert_close(got.numpy(), np.asarray(want), TOL_FWD)


@pytest.mark.parametrize("wdtype", ["float32", "int8"])
@pytest.mark.parametrize("case", DECONV_CASES,
                         ids=[f"deconv{i}" for i in range(len(DECONV_CASES))])
def test_tiled_deconv_plain_version_matches_pallas(case, wdtype):
    b, h, w, c, n, r, s, strides, pads, c_t, n_t, sp_tiles = case
    jp = jplan.plan_conv(jplan.conv_spec(
        "transposed", (b, h, w, c), (r, s, c, n), strides=strides,
        padding=pads))
    tp = tplan.plan_conv(tplan.conv_spec(
        "transposed", (b, h, w, c), (r, s, c, n), strides=strides,
        padding=pads, backend="torch"))
    rng = _rng(case)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    k = rng.standard_normal((r, s, c, n)).astype(np.float32)
    packed = np.asarray(jp.pack(k))
    xg = np.asarray(jnp.pad(x, ((0, 0), *jp.gpad, (0, 0))))
    jkw = dict(phases=jp.phases, out_hw=jp.out_hw, strides=strides,
               sum_uv=jp.sum_uv, c_tile=c_t, n_tile=n_t, sp_tiles=sp_tiles,
               interpret=True)
    tkw = dict(phases=tp.phases, out_hw=tp.out_hw, strides=strides,
               sum_uv=tp.sum_uv, sp_tiles=sp_tiles)
    if wdtype == "int8":
        q, scale, wd = _int8_of(packed)
        want = jk.untangled_deconv2d_pallas(
            jnp.asarray(xg), jnp.asarray(q), scales=jnp.asarray(scale),
            **jkw)
        got = tk.untangled_deconv2d(torch.from_numpy(xg),
                                    torch.from_numpy(q),
                                    scales=torch.from_numpy(scale), **tkw)
    else:
        wd = packed
        want = jk.untangled_deconv2d_pallas(jnp.asarray(xg),
                                            jnp.asarray(packed), **jkw)
        got = tk.untangled_deconv2d(torch.from_numpy(xg),
                                    torch.from_numpy(packed), **tkw)
    y64, amax = transposed_oracle_f64(
        x, np.asarray(jp.unpack(jnp.asarray(wd))), strides=strides,
        padding=pads)
    terms = np.zeros(tp.out_hw)
    for ex in tp.phases:
        terms[ex.q[0]::strides[0], ex.q[1]::strides[1]] = \
            ex.taps[0] * ex.taps[1] * c
    assert got.shape == want.shape == y64.shape
    assert_within_ulp(got.numpy(), y64, amax, terms[None, :, :, None])
    assert_within_ulp(np.asarray(want), y64, amax, terms[None, :, :, None])
    assert_close(got.numpy(), np.asarray(want), TOL_FWD)
    for ex in tp.phases:
        if ex.taps[0] * ex.taps[1] == 0:
            assert not got[:, ex.q[0]::strides[0],
                           ex.q[1]::strides[1]].ne(0).any()


def test_tiled_deconv_refuses_non_uniform_phases():
    """Kernel D tiles uniform phases only (out % stride == 0), as JAX's
    ``_deconv_tiled`` asserts; the whole-plane kernel A takes the rest."""
    plan = tplan.plan_conv(tplan.conv_spec(
        "transposed", (1, 7, 7, 4), (5, 5, 4, 3), strides=(2, 2),
        padding=((1, 1), (1, 1)), backend="torch"))
    assert not plan.uniform
    xg = torch.zeros((1, 7 + sum(plan.gpad[0]), 7 + sum(plan.gpad[1]), 4))
    sp = torch.zeros((plan.total_taps * 4, 3))
    kw = dict(phases=plan.phases, out_hw=plan.out_hw, strides=(2, 2),
              sum_uv=plan.sum_uv)
    assert tk.untangled_deconv2d(xg, sp, **kw).shape[1:3] == plan.out_hw
    with pytest.raises(ValueError, match="uniform"):
        tk.untangled_deconv2d(xg, sp, sp_tiles=(2, 2), **kw)


# ---------------------------------------------------------------------------
# halo geometry
# ---------------------------------------------------------------------------

def _all_sites():
    sites = [(name, spec) for name, spec in route_specs()
             if spec.spatial == (1, 1)]
    for cfg in (junet.UNET_TINY, junet.UNET, UNET_512):
        sites += [(f"{cfg.name}_{n}", s) for n, s in junet.unet_sites(cfg)]
    return sites


def test_halo_geometry_equals_jax_at_every_site():
    for name, spec in _all_sites():
        jp = jplan.plan_conv(dataclasses.replace(spec, backend="xla"))
        if spec.kind == "transposed":
            if any(ex.taps[0] * ex.taps[1] for ex in jp.phases):
                assert tk.deconv_tap_span(jp.phases) == \
                    jk.deconv_tap_span(jp.phases), name
            continue
        (r, s), st = spec.kernel_hw, spec.strides
        d = spec.dilation if spec.kind == "dilated" else (1, 1)
        for tile in (1, 3, 8, 16, 128):
            assert tk.halo_extent(tile, r, st[0], d[0]) == \
                jk.halo_extent(tile, r, st[0], d[0]), name
            assert tk.halo_extent(tile, s, st[1], d[1]) == \
                jk.halo_extent(tile, s, st[1], d[1]), name


def test_vmem_estimates_equal_jax():
    """The integer copies of the reference's working-set estimates."""
    for args in [(12, 12, 8, 9, 8, 64), (33, 17, 32, 16, 64, 512)]:
        for itemsize, witemsize in ((4, None), (4, 1), (2, None)):
            assert tplan.vmem_bytes_estimate_tiled(
                *args, itemsize, witemsize=witemsize) == \
                jk.vmem_bytes_estimate_tiled(*args, itemsize,
                                             witemsize=witemsize)
            assert tplan.vmem_bytes_estimate_superpack(
                *args[:2], 16, 9, 32, 10, 10, itemsize, witemsize) == \
                jk.vmem_bytes_estimate_superpack(
                    *args[:2], 16, 9, 32, 10, 10, itemsize, witemsize)
            assert tplan.vmem_bytes_estimate_fused(
                *args[:2], 16, 9, 32, 400, 20, 20, itemsize, witemsize) == \
                jk.vmem_bytes_estimate_fused(
                    *args[:2], 16, 9, 32, 400, 20, 20, itemsize, witemsize)


# ---------------------------------------------------------------------------
# the tiled verdict, live against JAX
# ---------------------------------------------------------------------------

def _assert_verdicts_equal(cfg, backend_j="pallas"):
    """Every site of ``cfg``: the port's 'cuda' routes tiled exactly at the
    buckets (and the beyond-bucket batch) where JAX's 'pallas' routes are;
    its 'torch' routes never.  Returns the tiled site names."""
    tiled = []
    for name, spec in junet.unet_sites(cfg):
        jp = jplan.plan_conv(dataclasses.replace(spec, backend=backend_j))
        cp = tplan.plan_conv(port_spec(spec, "cuda"))
        tp = tplan.plan_conv(port_spec(spec, "torch"))
        assert [r.sp_tiles is not None for r in cp.routes] == \
            [r.path == "pallas" and r.sp_tiles is not None
             for r in jp.routes], name
        assert (cp.route_for_batch(100).sp_tiles is None) == \
            (jp.route_for_batch(100).sp_tiles is None), name
        assert all(r.path == "cuda" and r.tiles is None for r in cp.routes)
        assert all(r.sp_tiles is None for r in tp.routes)
        if cp.routes[0].sp_tiles is not None:
            tiled.append(name)
    return tiled


@pytest.mark.parametrize("wdtype", ["float32", "int8"])
def test_unet_512_tiled_verdict_equals_jax(wdtype):
    cfg = dataclasses.replace(UNET_512, wdtype=wdtype)
    assert _assert_verdicts_equal(cfg) == ["stem", "down0", "up0", "fuse0",
                                           "head"]


@contextlib.contextmanager
def both_budgets(budget):
    """Shrink both packages' reference budget constants (JAX's through
    ``tests/conftest.py:vmem_budget``), each plan cache cleared."""
    old = tplan._REF_VMEM_BUDGET
    with vmem_budget(budget):
        tplan._REF_VMEM_BUDGET = budget
        tplan.plan_cache_clear()
        try:
            yield
        finally:
            tplan._REF_VMEM_BUDGET = old
            tplan.plan_cache_clear()


# shrunk budgets under which small U-Nets take the reference's tiled
# verdict: UNET_TINY's 16 px stem, fuse0 and head (kernel C); a 32 px
# base-8 U-Net's stem, down0, up0, fuse0 and head, the sites the 512 px
# U-Net tiles (kernels C and D; UNET_TINY's 8 px up planes never tile)
TINY_BUDGET = 16 * 1024
UNET_TINY32 = junet.UNetConfig("unet-tiny-32", image_hw=32, base=8,
                               time_dim=16)
TINY32_BUDGET = 32 * 1024
SHRUNK = [(junet.UNET_TINY, TINY_BUDGET, ["stem", "fuse0", "head"]),
          (UNET_TINY32, TINY32_BUDGET,
           ["stem", "down0", "up0", "fuse0", "head"])]


@pytest.mark.parametrize("wdtype", ["float32", "int8"])
@pytest.mark.parametrize("base,budget,want", SHRUNK,
                         ids=[c[0].name for c in SHRUNK])
def test_small_unet_tiled_verdict_under_shrunk_budgets(base, budget, want,
                                                       wdtype):
    cfg = dataclasses.replace(base, wdtype=wdtype)
    assert _assert_verdicts_equal(cfg) == []
    with both_budgets(budget):
        assert _assert_verdicts_equal(cfg) == want


# ---------------------------------------------------------------------------
# the card's block tiles
# ---------------------------------------------------------------------------

def test_block_tiles_fit_one_block():
    """Every tiled 'cuda' route's tile fits one block: its pixel groups in
    the block's threads and its ring in the block's shared memory; at the
    U-Net's sites, the blocks an SM that kernel C's and kernel D's
    schedules state."""
    checked = 0
    sites = [(name, spec) for name, spec in route_specs()
             if spec.spatial == (1, 1)]
    sites += [(n, s) for n, s in junet.unet_sites(UNET_512)]
    for name, spec in sites:
        cp = tplan.plan_conv(port_spec(spec, "cuda"))
        tile = cp.routes[0].sp_tiles
        if tile is None:
            continue
        checked += 1
        n = spec.out_c
        if spec.kind == "transposed":
            sch = tk.tiled_deconv_schedule(tuple(cp.phases), cp.out_hw,
                                           spec.in_c, n, tile)
            assert sch is not None and sch.tile == tile, name
            groups = sch.threads // sch.column_groups
            assert tile[0] * sch.gpr <= sch.gpp, name
            assert sch.gpp * (1 if sch.path == 1 else sch.phases) <= groups
        else:
            (r, s), st = spec.kernel_hw, spec.strides
            d = spec.dilation if spec.kind == "dilated" else (1, 1)
            hp = spec.in_hw[0] + sum(spec.padding[0])
            wp = spec.in_hw[1] + sum(spec.padding[1])
            out = tk.single_out_hw(hp, wp, (r, s), st, d)
            sch = tk.tiled_conv_schedule(out, (r, s), st, d, spec.in_c, n,
                                         tile)
            assert sch is not None and sch.tile == tile, name
            assert tile[0] * sch.gpr <= sch.groups, name
        assert sch.smem_bytes <= tk.SMEM_BLOCK_MAX, name
        if name in dict(junet.unet_sites(UNET_512)):
            assert sch.blocks_sm * (sch.smem_bytes + tk.SMEM_RESERVED) \
                <= tk.SMEM_SM, name
    assert checked == 9        # 4 fixture rows + the 5 U-Net-512 sites


@pytest.mark.parametrize("source,symbol,argtypes", [
    ("untangled_conv_tiled", "untangled_conv2d_tiled_f32",
     tk._CONV_TILED_ARGTYPES),
    ("untangled_conv_tiled", "untangled_conv2d_tiled_i8",
     [ctypes.c_void_p] + tk._CONV_TILED_ARGTYPES),
    ("untangled_deconv_tiled", "untangled_deconv2d_tiled_f32",
     tk._DECONV_TILED_ARGTYPES),
    ("untangled_deconv_tiled", "untangled_deconv2d_tiled_i8",
     [ctypes.c_void_p] + tk._DECONV_TILED_ARGTYPES),
])
def test_ctypes_bindings_match_the_c_entries(source, symbol, argtypes):
    """Kernels C's and D's argtypes follow the C signatures: a pointer (or
    the stream) for every ``*`` parameter, an int for every ``int``."""
    src = (pathlib.Path(tk.__file__).parent / "csrc"
           / f"{source}.cu").read_text()
    sig = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', src).group(1)
    params = [p.strip() for p in sig.split(",")]
    assert all("*" in p or p.startswith("int ") for p in params)
    assert argtypes == [ctypes.c_void_p if "*" in p else ctypes.c_int
                        for p in params]
