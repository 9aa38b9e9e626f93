"""Kernel C's schedule (``tiled_conv_schedule``): how the card's tiled
kernel lays out one call — tile, BN, pixel groups, staged halo, ring —
checked on the CPU without a card.

- At every tiled site (the four U-Net-512 kernel-C sites and both 385 px
  context sites) and at every geometry of the card tests'
  ``TILED_CONV_CASES``, the tile covers the output, its rows of pixel
  groups fit the block's, its ring fits the block's shared memory, and the
  card's tiles let the stated blocks share an SM.
- BN follows N (4 for N <= 4, the head; else 32, 64, 128); the 3x3 sites
  take the compile-time tap loops; the stem makes 36 K steps a pixel.
- A replay of the warp's halo reads (the kernel's pixel groups and its
  ``halo_unit`` layout) finds no shared-memory bank conflict at the tiled
  sites.
- A float32 replay of the kernel's sum order (chunk, tap row, tap,
  channel; each step one rounding, as an FFMA) at fuse0's geometry stays
  within the f64 oracle's ULP bound."""
import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import untangled_conv as tk
from repro_torch.models import unet

from tests.conftest import conv_oracle_f64, ulp_bound
from tests.test_torch_cuda import TILED_CONV_CASES

UNET_512 = unet.UNetConfig("unet-512", image_hw=512, backend="cuda")


def unet512_sites():
    """(name, out_hw, taps, strides, dilation, C, N, route tile) of the
    U-Net-512 sites kernel C takes."""
    out = []
    for name, plan in unet.unet_plans(UNET_512).items():
        sp = plan.spec
        if plan.routes[0].sp_tiles is None or sp.kind == "transposed":
            continue
        hp = sp.in_hw[0] + sum(sp.padding[0])
        wp = sp.in_hw[1] + sum(sp.padding[1])
        o = tk.single_out_hw(hp, wp, sp.kernel_hw, sp.strides, sp.dilation)
        out.append((name, o, sp.kernel_hw, sp.strides, sp.dilation,
                    sp.in_c, sp.out_c, plan.routes[0].sp_tiles))
    return out


# (name, out_hw, taps, strides, dilation, C, N): the 385 px context
# sites, 32 -> 32 at d = 2 and d = 4
CONTEXT_SITES = [
    ("ctx385_d2", (385, 385), (3, 3), (1, 1), (2, 2), 32, 32),
    ("ctx385_d4", (385, 385), (3, 3), (1, 1), (4, 4), 32, 32),
]


def card_cases():
    """(name, out_hw, taps, strides, dilation, C, N, tile) of the card
    tests' kernel-C geometries (tile None: the card's own)."""
    out = []
    for name, b, hp, wp, c, n, r, s, st, dil, tile in TILED_CONV_CASES:
        o = tk.single_out_hw(hp, wp, (r, s), st, dil)
        out.append((name, o, (r, s), st, dil, c, n, tile))
    return out


SITES = [(*s[:7], None) for s in unet512_sites()] + \
    [(*s, None) for s in CONTEXT_SITES]


def check_layout(sch, out_hw):
    """The tile covers the output, its pixel rows fit the block's groups,
    its ring fits shared memory for the blocks an SM it states."""
    assert sch.tiles[0] * sch.tile[0] >= out_hw[0]
    assert sch.tiles[1] * sch.tile[1] >= out_hw[1]
    assert (sch.tiles[0] - 1) * sch.tile[0] < out_hw[0]
    assert (sch.tiles[1] - 1) * sch.tile[1] < out_hw[1]
    assert sch.tile[0] * sch.gpr <= sch.groups
    assert sch.gpr * tk._TC_TM >= sch.tile[1]
    assert sch.smem_bytes <= tk.SMEM_BLOCK_MAX
    assert sch.stages >= tk._TC_INT8_MIN_STAGES
    assert sch.pitch >= tk.tiled_halo_unit(sch.halo[1] - 1) + 1
    assert sch.fits_sm


@pytest.mark.parametrize("name,out_hw,taps,strides,dil,c,n,tile",
                         SITES + card_cases(),
                         ids=[s[0] for s in SITES + card_cases()])
def test_schedule_covers_output_and_fits_the_block(name, out_hw, taps,
                                                   strides, dil, c, n, tile):
    sch = tk.tiled_conv_schedule(out_hw, taps, strides, dil, c, n, tile)
    assert sch is not None, name
    if tile is not None:
        assert sch.tile == tile
    check_layout(sch, out_hw)
    # the widest pixel a thread's groups read lies in the staged halo
    (r, s), (sh, sw), (dh, dw) = taps, strides, dil
    cols = sch.gpr // sch.pd * tk._TC_TM * sch.pd
    assert (cols - 1) * sw + (s - 1) * dw < sch.halo[1]
    assert (sch.tile[0] - 1) * sh + (r - 1) * dh < sch.halo[0]


def test_unet_routes_carry_the_schedule_tile():
    """``pick_block_tile_single`` returns the schedule's tile, and the
    U-Net-512's 'cuda' routes carry it at the four kernel-C sites."""
    sites = unet512_sites()
    assert [s[0] for s in sites] == ["stem", "down0", "fuse0", "head"]
    for name, out_hw, taps, st, dil, c, n, tile in sites:
        sch = tk.tiled_conv_schedule(out_hw, taps, st, dil, c, n)
        assert tile == sch.tile == tk.pick_block_tile_single(
            out_hw, taps, st, dil, n), name
        assert sch.tiles[0] * sch.tiles[1] >= 256, name  # thousands at B=16


@pytest.mark.parametrize("n,bn", [(1, 4), (3, 4), (4, 4), (5, 32), (32, 32),
                                  (33, 64), (48, 64), (64, 64), (65, 128),
                                  (256, 128)])
def test_bn_follows_n(n, bn):
    assert tk.tiled_conv_bn(n) == bn
    sch = tk.tiled_conv_schedule((64, 64), (3, 3), (1, 1), (1, 1), 16, n)
    assert sch.bn == bn


def test_head_keeps_bn4_and_sites_take_compile_time_taps():
    paths = {name: tk.tiled_conv_schedule(o, t, st, d, c, n)
             for name, o, t, st, d, c, n, _ in unet512_sites()}
    assert paths["head"].bn == 4
    assert {k: (v.bn, v.path) for k, v in paths.items()} == {
        "stem": (32, 1), "down0": (64, 2), "fuse0": (32, 1), "head": (4, 1)}
    for name, *geom in CONTEXT_SITES:
        sch = tk.tiled_conv_schedule(*geom)
        assert (sch.path, sch.pd) == (1, geom[3][1]), name
    # the run-time tap loop takes every other geometry
    assert tk.tiled_conv_path((7, 7), (1, 1), (1, 1)) == 0
    assert tk.tiled_conv_path((3, 3), (2, 2), (2, 2)) == 0
    assert tk.tiled_conv_path((2, 2), (1, 1), (1, 1)) == 0


def test_stem_makes_no_padded_k_beyond_one_chunk():
    """C = 3 is one chunk of 4 channels: at most 9 taps x 4 = 36 K steps
    a pixel (the old CK = 8 chunk made 72)."""
    (stem,) = [s for s in unet512_sites() if s[0] == "stem"]
    _, o, t, st, d, c, n, _ = stem
    sch = tk.tiled_conv_schedule(o, t, st, d, c, n)
    assert c == 3 and sch.chunk == 4
    assert sch.k_steps == 36 <= 9 * 4
    for c_, want in ((64, 9 * 64), (130, 9 * 132), (10, 9 * 12)):
        assert tk.tiled_conv_schedule(o, t, st, d, c_, n).k_steps == want


def warp_waves(sch, strides, dilation):
    """Replays the kernel's halo reads: for each warp, tap row m and span
    value j, the 16-byte units its 32 lanes read (the kernel's pixel groups
    and halo_unit layout), and the shared-memory wavefronts that takes (the
    most distinct units on one of the 8 sixteen-byte bank groups) against
    the least any layout could take.  Returns (excess, total)."""
    ng = sch.bn // tk._TC_TN
    span = tk._TC_TM + 2 if sch.path == 1 else 2 * (tk._TC_TM - 1) + 3
    excess = total = 0
    for warp in range(sch.threads // 32):
        for m in range(3):
            for j in range(span):
                units = set()
                for lane in range(32):
                    grp = (warp * 32 + lane) // ng
                    ph, gg = divmod(grp, sch.gpr)
                    blk, r = divmod(gg, sch.pd)
                    ow0 = blk * tk._TC_TM * sch.pd + r
                    if ph >= sch.tile[0]:
                        ph = ow0 = 0
                    row = ph * strides[0] + m * dilation[0]
                    if sch.path == 1:
                        u = tk.tiled_halo_unit(ow0 + j * sch.pd)
                    else:
                        u = tk.tiled_halo_unit(2 * ow0) + j + j // 8
                    units.add(row * sch.pitch + u)
                per_bank = {}
                for u in units:
                    per_bank.setdefault(u % 8, set()).add(u)
                waves = max(len(v) for v in per_bank.values())
                excess += waves - -(-len(units) // 8)
                total += waves
    return excess, total


@pytest.mark.parametrize("name,out_hw,taps,strides,dil,c,n,tile", SITES,
                         ids=[s[0] for s in SITES])
def test_halo_vector_reads_are_conflict_free(name, out_hw, taps, strides,
                                             dil, c, n, tile):
    sch = tk.tiled_conv_schedule(out_hw, taps, strides, dil, c, n)
    excess, total = warp_waves(sch, strides, dil)
    assert total > 0 and excess == 0, name


def test_block_table_matches_the_source():
    """The wrapper's threads and blocks an SM per BN are the kernel's
    ``Block<BN>``, and its ring's shared memory is the kernel's
    ``smem_bytes``."""
    src = (pathlib.Path(tk.__file__).parent / "csrc"
           / "untangled_conv_tiled.cu").read_text()
    threads = re.search(r"kThreads = BN == 4 \? (\d+) : (\d+);", src)
    blocks = int(re.search(r"kMinBlocks = (\d+);", src).group(1))
    for bn, want in tk._TILED_CONV_BLOCKS.items():
        assert want == (int(threads.group(1 if bn == 4 else 2)), blocks), bn
    assert "return g.stages * (halo + wt);" in src
    assert ("return g.stages * (halo + 4 * taps * kCK + taps * kCK * BN) "
            "+ 2 * wt;") in src
    assert tk.tiled_conv_smem_bytes(32, 18, 20, 9, 4) == \
        4 * (18 * 20 * 16 + 4 * 9 * 4 * 32)
    assert tk.tiled_conv_smem_bytes(32, 18, 20, 9, 3, True) == \
        3 * (18 * 20 * 16 + 4 * 36 + 36 * 32) + 2 * 4 * 36 * 32


def test_kernel_order_sum_within_ulp_bound_at_fuse0_geometry():
    """The kernel's sum of one output, replayed in float32: chunks of 4
    channels, then tap row, tap, channel, each step a single rounding of
    acc + x·w (an FFMA), at fuse0's geometry (C = 64, N = 32, 3x3) on a
    narrow plane — within the f64 oracle's ULP bound."""
    rng = np.random.default_rng(19)
    c, n, h, w = 64, 32, 10, 12
    x = rng.standard_normal((1, h + 2, w + 2, c)).astype(np.float32)
    k = rng.standard_normal((3, 3, c, n)).astype(np.float32)
    x64, k64 = torch.from_numpy(x).double(), torch.from_numpy(k).double()
    acc = torch.zeros((h, w, n), dtype=torch.float32)
    for chunk in range(c // 4):
        for m in range(3):
            for t in range(3):
                for ch in range(4 * chunk, 4 * chunk + 4):
                    term = x64[0, m:m + h, t:t + w, ch, None] * k64[m, t, ch]
                    acc = (acc.double() + term).float()
    y64, amax = conv_oracle_f64(x, k)
    bound = np.asarray(ulp_bound(y64, amax, 9 * c))
    assert np.all(np.abs(acc.numpy()[None].astype(np.float64) - y64)
                  <= bound)
