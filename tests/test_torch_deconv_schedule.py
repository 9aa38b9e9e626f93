"""Kernel A's schedule (``deconv_schedule``): how the card's kernel covers
one call with tiles, K slices, work units and a workspace, checked on the
CPU without a card.

- Every K chunk of every (phase, M tile, N tile) lies in exactly one slice,
  for phases from ``plan_conv`` (k 2-5, stride 1-3, ragged C and N, empty
  phases, B in {1, 4, 16, 64}); a replica of the kernel's unit lookup and
  of the reduction's indexing maps the grid one to one onto those slices.
- The f32 and int8 entries take one schedule and one set of launch ints.
- Every DCGAN, cGAN and U-Net site of kernel A has at least 132 work units
  in every bucket, split or not; no split where the unsplit grid already
  has them; the workspace is bounded.
- A numpy f32 replay of the slice-ordered sum at DCGAN DC1 (B = 1, full
  width) stays within the f64 oracle's ULP bound."""
import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from repro_torch.core.plan import BATCH_BUCKETS, ConvSpec, conv_spec, plan_conv
from repro_torch.kernels import untangled_conv as tk
from repro_torch.models import gan, unet

from tests.conftest import ulp_bound
from tests.test_quantized import transposed_oracle_f64


def _plan(b, h, c, n, k, s, pads):
    return plan_conv(conv_spec("transposed", (b, h, h, c), (k, k, c, n),
                               strides=(s, s), padding=pads, backend="cuda"))


def _find_unit(sch, x):
    """The kernel's ``find_unit``: grid x index -> (phase, M tile, slice)."""
    for p, (tiles, slices) in enumerate(zip(sch.m_tiles, sch.slices)):
        if x < tiles * slices:
            return p, x // slices, x % slices
        x -= tiles * slices
    raise AssertionError("grid index past the last unit")


def _reduce_units(sch):
    """The reduction's indexing: for each (phase, M tile) its first unit and
    slice count, in the order of its grid's x."""
    out, unit0 = [], 0
    for p, (tiles, slices) in enumerate(zip(sch.m_tiles, sch.slices)):
        for mt in range(tiles):
            out.append(((p, mt), unit0 + mt * slices, slices))
        unit0 += tiles * slices
    return out


def check_schedule(plan, b):
    c, n = plan.spec.in_c, plan.spec.out_c
    sch = tk.deconv_schedule(plan.phases, b, c, n)
    bm, bn, bk = tk._DECONV_CONFIGS[sch.config]
    assert sch.tile == (bm, bn) and sch.bk == bk
    assert (sch.config == tk._THIN) == (n <= tk._THIN_N)
    if sch.config == tk._THIN:
        tiles = []
        for ex in plan.phases:
            u, v = ex.out_hw
            tv = min(v, tk._THIN_TV)
            tu = min(bm // max(tv, 1), tk._THIN_TU)
            tiles.append(b * -(-u // tu) * -(-v // tv) if u * v else 0)
            assert tu * tv <= bm
        assert sch.m_tiles == tuple(tiles)
        assert tk.thin_smem_bytes(sch) <= tk.SMEM_BLOCK_MAX
    else:
        assert sch.m_tiles == tuple(-(-b * ex.out_hw[0] * ex.out_hw[1] // bm)
                                    for ex in plan.phases)
    assert sch.phase_chunks == tuple(ex.taps[0] * ex.taps[1] * -(-c // bk)
                                     for ex in plan.phases)
    longest = 0
    for k_p, s_p in zip(sch.phase_chunks, sch.slices):
        assert s_p == tk._n_slices(k_p, sch.chunk_len) >= 1
        bounds = [tk._slice_begin(k_p, s_p, i) for i in range(s_p + 1)]
        covered = [ch for i in range(s_p)
                   for ch in range(bounds[i], bounds[i + 1])]
        assert covered == list(range(k_p))           # each chunk once
        lengths = np.diff(bounds)
        assert lengths.max() <= sch.chunk_len
        assert k_p == 0 or lengths.min() >= 1        # no empty slice
        longest = max(longest, int(lengths.max()))
    assert sch.max_chunks == longest or sum(sch.phase_chunks) == 0
    assert sch.grid == (sum(t * s for t, s in zip(sch.m_tiles, sch.slices)),
                        -(-n // bn))
    # the kernel's unit lookup covers every (phase, M tile, slice) once, and
    # the reduction finds each tile's slices at consecutive units
    seen = [_find_unit(sch, x) for x in range(sch.grid[0])]
    assert len(set(seen)) == len(seen) == sch.grid[0]
    for (p, mt), unit0, slices in _reduce_units(sch):
        for s in range(slices):
            assert seen[unit0 + s] == (p, mt, s)
    assert sch.split == any(s > 1 for s in sch.slices)
    assert sch.workspace_bytes == (4 * sch.units * bm * bn if sch.split
                                   else 0)
    assert sch.workspace_bytes <= tk._WORKSPACE_MAX
    if sch.config == tk._THIN:
        assert sch.max_chunks * bk <= tk._THIN_ROWS_MAX
    return sch


@settings(max_examples=150, deadline=None)
@given(k=st.integers(2, 5), s=st.integers(1, 3), h=st.integers(1, 9),
       c=st.integers(1, 300), n=st.integers(1, 300),
       b=st.sampled_from(BATCH_BUCKETS), lo=st.integers(0, 4),
       hi=st.integers(0, 4))
@example(k=2, s=3, h=4, c=8, n=8, b=1, lo=1, hi=1)     # an empty phase
@example(k=5, s=2, h=4, c=1024, n=512, b=64, lo=2, hi=3)
def test_slices_cover_every_chunk_once(k, s, h, c, n, b, lo, hi):
    lo, hi = min(lo, k - 1), min(hi, k - 1)
    if (h - 1) * s + lo + hi - k + 2 < 1:
        return                                       # no output
    plan = _plan(b, h, c, n, k, s, ((lo, hi), (lo, hi)))
    check_schedule(plan, b)


def test_an_empty_phase_has_one_empty_slice():
    plan = _plan(2, 4, 8, 8, 2, 3, ((1, 1), (1, 1)))
    empty = [i for i, ex in enumerate(plan.phases)
             if ex.taps[0] * ex.taps[1] == 0]
    assert empty
    sch = check_schedule(plan, 2)
    assert all(sch.phase_chunks[i] == 0 and sch.slices[i] == 1
               for i in empty)


def model_sites():
    """(name, plan) of every kernel-A site: the DCGAN and cGAN generators,
    the U-Net's transposed ups at 32² and 512² (whole plane at every bucket
    but 512²'s up0, which kernel D takes)."""
    out = []
    for tag, layers in (("DCGAN", gan.DCGAN_LAYERS),
                        ("cGAN", gan.CGAN_LAYERS)):
        for i, l in enumerate(layers):
            out.append((f"{tag}_DC{i + 1}", plan_conv(ConvSpec(
                kind="transposed", in_hw=(l.in_hw, l.in_hw), in_c=l.in_c,
                out_c=l.out_c, kernel_hw=(l.kernel, l.kernel),
                strides=(l.stride, l.stride),
                padding=gan.deconv_padding(l.kernel, l.stride),
                backend="cuda"))))
    for cfg in (unet.UNET, unet.UNetConfig("unet-512", image_hw=512)):
        cfg = dataclasses.replace(cfg, backend="cuda")
        for name, p in unet.unet_plans(cfg).items():
            if p.spec.kind == "transposed" and p.routes[0].sp_tiles is None:
                out.append((f"unet{cfg.image_hw}_{name}", p))
    return out


MODEL_SITES = model_sites()


@pytest.mark.parametrize("b", BATCH_BUCKETS)
@pytest.mark.parametrize("name,plan", MODEL_SITES,
                         ids=[n for n, _ in MODEL_SITES])
def test_model_sites_fill_the_card(name, plan, b):
    """At least 132 work units at every site and bucket; a split only where
    the unsplit grid has fewer."""
    sch = check_schedule(plan, b)
    assert sch.units >= tk.SMS
    whole = tk._schedule(sch.config, plan.phases, b, plan.spec.in_c,
                         plan.spec.out_c, max(sch.phase_chunks))
    if sch.split and sch.config != tk._THIN:
        assert whole.units < tk.SMS
    if whole.units >= tk.SMS and sch.config != tk._THIN:
        assert not sch.split


def test_dcgan_schedules():
    """B = 1: the M tile follows DC1's 16 rows and K is split; B = 64: DC1's
    128 tiles of 128x128 are split, the 9-tap phase into more slices than
    the 4-tap one, DC2-DC4 are not; the RGB head takes the thin tile."""
    sites = dict(MODEL_SITES)
    dc1_b1 = tk.deconv_schedule(sites["DCGAN_DC1"].phases, 1, 1024, 512)
    assert dc1_b1.tile[0] == 16 and dc1_b1.split
    dc1 = tk.deconv_schedule(sites["DCGAN_DC1"].phases, 64, 1024, 512)
    assert dc1.tile == (128, 128) and dc1.split
    assert dc1.slices[0] > dc1.slices[3]
    for name, c, n in (("DCGAN_DC2", 512, 256), ("DCGAN_DC3", 256, 128),
                       ("DCGAN_DC4", 128, 3)):
        assert not tk.deconv_schedule(sites[name].phases, 64, c, n).split
    assert tk.deconv_schedule(sites["DCGAN_DC4"].phases, 1, 128,
                              3).config == tk._THIN


@pytest.mark.parametrize("name,b", [("DCGAN_DC1", 1), ("DCGAN_DC1", 64),
                                    ("DCGAN_DC4", 1), ("cGAN_DC2", 16),
                                    ("unet32_up0", 4)])
def test_f32_and_int8_entries_take_one_schedule(name, b):
    """The wrapper's launch ints (geometry, tile, 16-byte path, slices,
    grid) are the same for an f32 superpack and for int8 codes."""
    plan = dict(MODEL_SITES)[name]
    sp = plan.spec
    hg = sp.in_hw[0] + sum(plan.gpad[0])
    wg = sp.in_hw[1] + sum(plan.gpad[1])
    rows = plan.total_taps * sp.in_c
    xg = torch.empty((b, hg, wg, sp.in_c))
    y = torch.empty((b, *plan.out_hw, sp.out_c))
    got = [tk.deconv_launch_ints(xg, torch.empty((rows, sp.out_c),
                                                 dtype=dtype), y,
                                 plan.phases, sp.strides)
           for dtype in (torch.float32, torch.int8)]
    assert got[0] == got[1]
    assert got[0][0] is tk.deconv_schedule(plan.phases, b, sp.in_c,
                                           sp.out_c)


def test_slice_ordered_replay_at_dc1_within_ulp_bound():
    """DCGAN DC1 at B = 1, full width (C 1024, N 512, 25 taps): each slice
    of the card's schedule summed in f32 in ascending K order, the slices
    then added in slice order, is within the f64 oracle's ULP bound."""
    plan = dict(MODEL_SITES)["DCGAN_DC1"]
    sch = tk.deconv_schedule(plan.phases, 1, 1024, 512)
    assert sch.split
    rng = np.random.default_rng(17)
    x = rng.standard_normal((1, 4, 4, 1024)).astype(np.float32)
    kern = rng.standard_normal((5, 5, 1024, 512)).astype(np.float32)
    packed = plan.pack(torch.from_numpy(kern)).numpy()
    xg = np.pad(x, ((0, 0), *plan.gpad, (0, 0)))
    y = np.zeros((1, *plan.out_hw, 512), np.float32)
    bk = sch.bk
    for ex, k_p, s_p in zip(plan.phases, sch.phase_chunks, sch.slices):
        th, tw = ex.taps
        u, v = ex.out_hw
        # the phase's im2col rows in superpack order: (U·V, T·C)
        cols = np.concatenate(
            [xg[0, ex.xoff[0] + t // tw:ex.xoff[0] + t // tw + u,
                ex.xoff[1] + t % tw:ex.xoff[1] + t % tw + v].reshape(u * v,
                                                                    -1)
             for t in range(th * tw)], axis=1)
        w = packed[ex.tap_off * 1024:(ex.tap_off + th * tw) * 1024]
        total = None
        for s in range(s_p):
            k0 = tk._slice_begin(k_p, s_p, s) * bk
            k1 = tk._slice_begin(k_p, s_p, s + 1) * bk
            acc = np.zeros((u * v, 512), np.float32)
            for kk in range(k0, k1):
                acc += cols[:, kk:kk + 1] * w[kk]
            total = acc if total is None else total + acc
        y[0, ex.q[0]::2, ex.q[1]::2] = total.reshape(u, v, 512)
    y64, amax = transposed_oracle_f64(x, kern, strides=(2, 2),
                                      padding=gan.deconv_padding(5, 2))
    terms = np.zeros(plan.out_hw)
    for ex in plan.phases:
        terms[ex.q[0]::2, ex.q[1]::2] = ex.taps[0] * ex.taps[1] * 1024
    err = np.abs(y.astype(np.float64) - y64)
    bound = ulp_bound(y64, amax, terms[None, :, :, None])
    assert np.all(err <= bound), float(np.max(err - bound))
