"""Kernel B's schedule (``conv_schedule``): how the card's kernel covers one
call with tiles, K slices, work units and a workspace, checked on the CPU
without a card.

- Every K chunk of every (M tile, N tile) lies in exactly one slice, for
  random (M, K, N) and at every DCGAN/cGAN discriminator, SegNet and
  whole-plane U-Net site (32² and 512²) in every batch bucket; a replica
  of the kernel's unit lookup and of the reduction's indexing maps the
  grid one to one onto those slices.
- The schedule meets its rule: of a tile's unsplit schedule and its
  splits (each at least 132 units, or every unit one-chunk slices can
  give), the least modelled cost; a 128x128 grid of one wave never
  split; at B = 1
  the DCGAN discriminator sites (but D1, whose K of 5 chunks stays whole)
  and SegNet L1-L8 fill the card.
- BN follows N, BM the rows; the f32 and int8 entries take one schedule
  and one set of launch ints.
- A numpy f32 replay of the slice-ordered sum at DCGAN D4 (B = 1, full
  width, K = 12 800) stays within the f64 oracle's ULP bound."""
import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from repro_torch.core.plan import BATCH_BUCKETS
from repro_torch.kernels import untangled_conv as tk
from repro_torch.models import gan, segnet, unet

from tests.conftest import conv_oracle_f64, ulp_bound


def _units_of(sch):
    """The kernel's unit lookup: grid x -> (M tile, slice), x = mt*S + s."""
    return [divmod(x, sch.slices) for x in range(sch.grid[0])]


def check_schedule(m, k, n):
    """Every structural property of ``conv_schedule(m, k, n)``; returns
    it."""
    sch = tk.conv_schedule(m, k, n)
    bm, bn, _ = tk._CONV_CONFIGS[sch.config]
    assert sch.tile == (bm, bn) and sch.bk == tk._CONV_BK
    if n <= tk._THIN_N:
        assert sch.config == tk._CONV_THIN
    else:                          # BN >= N rounded to the tile, at most 128
        assert bn == min(t for t in (32, 64, 128) if t >= min(n, 128))
    assert sch.chunks == -(-k // tk._CONV_BK)
    assert sch.m_tiles == -(-m // bm)
    assert sch.slices == tk._n_slices(sch.chunks, sch.chunk_len) >= 1
    bounds = [tk._slice_begin(sch.chunks, sch.slices, i)
              for i in range(sch.slices + 1)]
    covered = [ch for i in range(sch.slices)
               for ch in range(bounds[i], bounds[i + 1])]
    assert covered == list(range(sch.chunks))          # each chunk once
    lengths = np.diff(bounds)
    assert lengths.max() <= sch.chunk_len and lengths.min() >= 1
    assert sch.grid == (sch.m_tiles * sch.slices, -(-n // bn))
    assert sorted(sch.unit_chunks()) == sorted(
        list(lengths) * sch.m_tiles * sch.grid[1])
    # the kernel's lookup covers every (M tile, slice) once, and the
    # reduction finds tile mt's slices at units mt*S .. mt*S + S - 1
    seen = _units_of(sch)
    assert len(set(seen)) == len(seen) == sch.m_tiles * sch.slices
    for mt in range(sch.m_tiles):
        for s in range(sch.slices):
            assert seen[mt * sch.slices + s] == (mt, s)
    assert sch.split == (sch.slices > 1)
    assert sch.workspace_bytes == (4 * sch.units * bm * bn if sch.split
                                   else 0)
    assert sch.workspace_bytes <= tk._WORKSPACE_MAX
    # the rule: of the tile's unsplit schedule and its splits (at least 132
    # units, or all one-chunk slices give), the least modelled cost
    whole = tk._conv_schedule(sch.config, m, sch.chunks, n,
                              max(sch.chunks, 1))
    most = tk._conv_schedule(sch.config, m, sch.chunks, n, 1).units
    splits = list(tk._conv_splits(sch.config, m, sch.chunks, n))
    assert all(s.split and min(tk.SMS, most) <= s.units <= tk._UNITS_MAX
               for s in splits)
    if whole.units <= tk._UNITS_MAX:
        assert sch.cost == min(c.cost for c in [whole, *splits])
    assert not sch.split or sch in splits
    if sch.tile == (128, 128):     # one block an SM: 120-132 units, one
        assert whole.units >= tk._CONV_BIG_TILE_UNITS   # wave, unsplit
        assert whole.units > tk.SMS or not sch.split
    return sch


@settings(max_examples=150, deadline=None)
@given(m=st.integers(1, 2 ** 20), k=st.integers(1, 13000),
       n=st.integers(1, 2048))
@example(m=16, k=12800, n=1024)                   # DCGAN D4 at B = 1
@example(m=4096, k=6400, n=512)                   # DCGAN D3 at B = 64
@example(m=1024, k=27, n=3)                       # thin N, tiny K
@example(m=1, k=1, n=1)
def test_slices_cover_every_chunk_once(m, k, n):
    check_schedule(m, k, n)


def model_sites():
    """(name, OH·OW, K = R·S·C, N) of every whole-plane kernel-B site, from
    the models' plans: the DCGAN and cGAN discriminators, the SegNet and
    the U-Net at 32² and 512² (the 512² plan's tiled sites go to kernel
    C)."""
    def row(name, p):
        sp = p.spec
        return (name, p.out_hw[0] * p.out_hw[1],
                sp.kernel_hw[0] * sp.kernel_hw[1] * sp.in_c, sp.out_c)

    out = []
    for tag, cfg in (("DCGAN", gan.DCGAN), ("cGAN", gan.CGAN)):
        out += [row(f"{tag}_D{i + 1}", p)
                for i, p in enumerate(gan.discriminator_plans(cfg))]
    out += [row(f"SegNet_L{i}", p)
            for i, p in enumerate(segnet.segnet_plans(segnet.SEGNET))]
    for cfg in (unet.UNET, unet.UNetConfig("unet-512", image_hw=512)):
        cfg = dataclasses.replace(cfg, backend="cuda")
        out += [row(f"unet{cfg.image_hw}_{name}", p)
                for name, p in unet.unet_plans(cfg).items()
                if p.spec.kind != "transposed"
                and p.routes[0].sp_tiles is None]
    return out


MODEL_SITES = model_sites()


def test_model_sites():
    """6 discriminator sites, 10 SegNet sites, 8 U-Net 32² sites and 4
    whole-plane 512² sites, at the models' widths."""
    names = [s[0] for s in MODEL_SITES]
    assert len(names) == 6 + 10 + 8 + 4 == len(set(names))
    sites = {s[0]: s[1:] for s in MODEL_SITES}
    assert sites["DCGAN_D1"] == (32 * 32, 75, 128)
    assert sites["DCGAN_D4"] == (16, 12800, 1024)
    assert sites["SegNet_L4"] == (256, 1152, 128)
    assert sites["SegNet_L9"] == (256, 128, 21)
    assert sites["unet512_fuse1"] == (256 * 256, 1152, 64)


@pytest.mark.parametrize("b", BATCH_BUCKETS)
@pytest.mark.parametrize("name,rows,k,n", MODEL_SITES,
                         ids=[s[0] for s in MODEL_SITES])
def test_model_sites_meet_the_rule(name, rows, k, n, b):
    """At B = 1 the DCGAN discriminator sites and SegNet L1-L8 fill the
    card: K is split into 132+ units, but for a K of fewer than
    ``_MIN_SLICE`` chunks (D1: 5), which keeps K whole."""
    sch = check_schedule(b * rows, k, n)
    if b == 1 and (name.startswith("DCGAN") or name in {
            f"SegNet_L{i}" for i in range(1, 9)}):
        if sch.chunks < tk._MIN_SLICE:
            assert not sch.split and name == "DCGAN_D1"
        else:
            assert sch.split and sch.units >= tk.SMS


def test_tiles_follow_rows_and_n():
    """B = 1: D4's 16 rows take a 16-row tile, D3's 64 rows at most 64;
    B = 64: the discriminator and SegNet sites take the 128-row tiles, BN
    32 at SegNet L0 and 64 at L1-L2; the U-Net's fuse1 at 512² takes
    128x64; its RGB head the thin tile."""
    sites = {s[0]: s[1:] for s in MODEL_SITES}

    def tile(name, b):
        rows, k, n = sites[name]
        return tk.conv_schedule(b * rows, k, n).tile

    assert tile("DCGAN_D4", 1) == (16, 128)
    assert tile("DCGAN_D3", 1)[0] <= 64
    assert tile("DCGAN_D2", 64) == (128, 128)
    assert tile("SegNet_L0", 64) == (128, 32)
    assert tile("SegNet_L1", 64) == tile("SegNet_L2", 64) == (128, 64)
    assert tile("SegNet_L4", 64)[0] == 128
    assert tile("unet512_fuse1", 16) == (128, 64)
    assert tile("unet32_head", 64) == (128, 16)


@pytest.mark.parametrize("name,b", [("DCGAN_D4", 1), ("DCGAN_D1", 64),
                                    ("SegNet_L9", 1), ("unet32_head", 4)])
def test_f32_and_int8_entries_take_one_schedule(name, b):
    """The wrapper's launch ints (geometry, tile, 16-byte paths, slices,
    grid) are the same for an f32 superpack and for int8 codes."""
    rows, k, n = {s[0]: s[1:] for s in MODEL_SITES}[name]
    oh = int(rows ** 0.5)
    r = 1 if name == "SegNet_L9" else 3 if name.startswith("unet") else 5
    c = k // (r * r)
    x = torch.empty((b, oh + r - 1, oh + r - 1, c))
    y = torch.empty((b, oh, oh, n))
    got = [tk.conv_launch_ints(x, torch.empty((k, n), dtype=dtype), y,
                               (r, r), (1, 1), (1, 1))
           for dtype in (torch.float32, torch.int8)]
    assert got[0] == got[1]
    assert got[0][0] is tk.conv_schedule(b * rows, k, n)


def test_slice_ordered_replay_at_d4_within_ulp_bound():
    """DCGAN D4 at B = 1, full width (C 512, N 1024, 25 taps, K = 12 800):
    each slice of the card's schedule summed in f32 in ascending K order,
    the slices then added in slice order, is within the f64 oracle's ULP
    bound."""
    c, n, k, s = 512, 1024, 5, 2
    sch = tk.conv_schedule(16, k * k * c, n)
    assert sch.split and sch.units >= tk.SMS
    rng = np.random.default_rng(18)
    x = rng.standard_normal((1, 8, 8, c)).astype(np.float32)
    kern = rng.standard_normal((k, k, c, n)).astype(np.float32)
    xp = np.pad(x, ((0, 0), (2, 2), (2, 2), (0, 0)))
    # the im2col rows in superpack order: (OH·OW, R·S·C)
    cols = np.concatenate(
        [xp[0, ti:ti + 7:s, tj:tj + 7:s].reshape(16, c)
         for ti in range(k) for tj in range(k)], axis=1)
    w = kern.reshape(k * k * c, n)
    total = None
    for sl in range(sch.slices):
        k0 = tk._slice_begin(sch.chunks, sch.slices, sl) * sch.bk
        k1 = min(tk._slice_begin(sch.chunks, sch.slices, sl + 1) * sch.bk,
                 k * k * c)
        acc = np.zeros((16, n), np.float32)
        for kk in range(k0, k1):
            acc += cols[:, kk:kk + 1] * w[kk]
        total = acc if total is None else total + acc
    y64, amax = conv_oracle_f64(x, kern, strides=(s, s),
                                padding=((2, 2), (2, 2)))
    err = np.abs(total.reshape(1, 4, 4, n).astype(np.float64) - y64)
    bound = ulp_bound(y64, amax, k * k * c)
    assert np.all(err <= bound), float(np.max(err - bound))


def test_tile_table_is_the_kernels_dispatch():
    """``_CONV_CONFIGS`` (BM, BN, blocks an SM holds) is the dispatch of
    ``csrc/untangled_conv.cu``: case i launches BM x BN with ``MINB`` blocks
    an SM asked of ptxas, which the cost model counts as block slots."""
    import pathlib
    import re
    src = (pathlib.Path(tk.__file__).parent / "csrc"
           / "untangled_conv.cu").read_text()
    cases = re.findall(r"case (\d+):[^\n]*\n\s*return launch<(\d+), (\d+), "
                       r"\d+, \d+, \d+, (\d+)>", src)
    assert [int(c) for c, *_ in cases] == list(range(len(tk._CONV_CONFIGS)))
    assert tuple((int(bm), int(bn), int(minb))
                 for _, bm, bn, minb in cases) == tk._CONV_CONFIGS
    assert tk._CONV_CONFIGS[tk._CONV_THIN][1] == tk._THIN_N
