"""Kernel D's schedule (``tiled_deconv_schedule``): how the card's tiled
transposed kernel lays out one call — tap loop, register split, tile, BN,
staged halo, ring — checked on the CPU without a card.

- At every uniform transposed site the repo plans (the route table's, the
  generators', the U-Nets') and at every geometry of the card tests'
  ``TILED_DECONV_CASES`` and ``chip_smoke.py``'s, a replay of the kernel's
  thread layout and store masks writes every phase-output pixel and
  channel exactly once, and every halo read lies in the staged halo.
- The shared-window path is taken exactly where all phases share their
  xoff and 2x2 taps (the U-Net's up sites, every k4 s2 plan such as the
  cGAN's); the DCGAN's k5 s2 plans take the run-time path.
- Shared memory fits a block, and at up0 the blocks an SM the schedule
  states; up0's grid fills the card's 132 SMs at B = 1; a replay of each
  warp's 16-byte halo and weight reads finds no bank conflict at up0.
- The tiled verdict still equals JAX's at every transposed site.
- ``F.conv_transpose2d`` at ``padding=0`` cropped ``[k-1-lo:]`` computes
  the pad-(lo, hi) transposed conv (the library yardstick of up0, whose
  pad (1, 3) has no one-call uncropped form); a float32 replay of the
  kernel's sum order at up0's widths stays within the f64 ULP bound."""
import dataclasses
import pathlib
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from repro.core import plan as jplan
from repro.models import gan as jgan
from repro.models import unet as junet
from repro_torch.core import plan as tplan
from repro_torch.core import reference as ref
from repro_torch.core.untangle import pad_or_crop
from repro_torch.kernels import untangled_conv as tk

from tests.conftest import ulp_bound
from tests.test_torch_cuda import TILED_DECONV_CASES
from tools.gen_route_table import route_specs

UNET_512 = junet.UNetConfig("unet-512", image_hw=512)


def port_plan(spec):
    fields = dataclasses.asdict(spec)
    fields.update(backend="cuda")
    return tplan.plan_conv(tplan.ConvSpec(**fields))


def site_plan(h, w, c, n, k, s, pads):
    return tplan.plan_conv(tplan.ConvSpec(
        kind="transposed", in_hw=(h, w), in_c=c, out_c=n, kernel_hw=(k, k),
        strides=(s, s), padding=pads, backend="cuda"))


def uniform(plan):
    uu, vv = plan.phases[0].out_hw
    return all(ex.out_hw == (uu, vv) for ex in plan.phases) and \
        len(plan.phases) * uu * vv == plan.out_hw[0] * plan.out_hw[1]


def repo_sites():
    """(name, plan, C, N, tile) of every uniform transposed site the repo
    plans, with the card's own tile (None)."""
    specs = [(name, spec) for name, spec in route_specs()
             if spec.kind == "transposed" and spec.spatial == (1, 1)]
    specs += [(f"unet512_{n}", s) for n, s in junet.unet_sites(UNET_512)
              if s.kind == "transposed"]
    specs += [(f"unet_tiny_{n}", s) for n, s in
              junet.unet_sites(junet.UNET_TINY) if s.kind == "transposed"]
    for arch, layers in (("dcgan", jgan.DCGAN_LAYERS),
                         ("cgan", jgan.CGAN_LAYERS)):
        cfg = jgan.GANConfig(arch, layers)
        specs += [(f"{arch}_gen{i}", p.spec) for i, p in
                  enumerate(jgan.generator_plans(cfg))]
    out, seen = [], set()
    for name, spec in specs:
        plan = port_plan(spec)
        key = (spec.in_hw, spec.in_c, spec.out_c, spec.kernel_hw,
               spec.strides, spec.padding)
        if key in seen or not uniform(plan):
            continue
        seen.add(key)
        out.append((name, plan, spec.in_c, spec.out_c, None))
    return out


def card_sites():
    """The card tests' and the smoke's kernel-D geometries, their tiles."""
    out = [(f"test_{name}", site_plan(h, w, c, n, k, s, pads), c, n, tile)
           for name, b, h, w, c, n, k, s, pads, tile in TILED_DECONV_CASES]
    out += [(f"smoke_{name}", site_plan(h, h, c, n, k, s, pads), c, n, tile)
            for name, b, h, c, n, k, s, pads, tile
            in chip_smoke.TILED_DECONV_CASES]
    return out


SITES = repo_sites() + card_sites()
IDS = [s[0] for s in SITES]


def up0():
    (site,) = [s for s in SITES if s[0] == "unet512_up0"]
    return site


def schedule_of(plan, c, n, tile):
    return tk.tiled_deconv_schedule(tuple(plan.phases), plan.out_hw, c, n,
                                    tile)


def thread_layout(sch, table):
    """The kernel's thread layout: per thread (phase list, channel group,
    tile row, first column, live), as deconv_tiled_kernel computes it."""
    tid = np.arange(sch.threads)
    nq = sch.bn // 4
    if sch.path == 1:
        ncg = sch.column_groups
        cg, grp = tid % ncg, tid // ncg
        pb, tx = cg // nq, cg % nq
        qs = [pb * sch.tp + i for i in range(sch.tp)]
        live = grp < sch.threads // ncg
        th = tw = np.full(sch.threads, 2)
        row_off = col_off = np.zeros(sch.threads, int)
    else:
        tx, pg = tid % nq, tid // nq
        q0, grp = pg // sch.gpp, pg % sch.gpp
        live = q0 < sch.phases
        qc = np.minimum(q0, sch.phases - 1)
        qs = [qc]
        th, tw = table[qc, 3], table[qc, 4]
        row_off = table[qc, 5] - sch.origin[0]
        col_off = table[qc, 6] - sch.origin[1]
    ph, ow0 = grp // sch.gpr, (grp % sch.gpr) * sch.tm
    live = live & (ph < sch.tile[0])
    return qs, tx, np.where(live, ph, 0), np.where(live, ow0, 0), live, \
        th, tw, row_off, col_off


def phase_table(plan):
    return np.array([(ex.q[0], ex.q[1], ex.tap_off, ex.taps[0], ex.taps[1],
                      ex.xoff[0], ex.xoff[1], ex.out_hw[0], ex.out_hw[1])
                     for ex in plan.phases])


@pytest.mark.parametrize("name,plan,c,n,tile", SITES, ids=IDS)
def test_schedule_writes_every_output_once_and_reads_inside_the_halo(
        name, plan, c, n, tile):
    sch = schedule_of(plan, c, n, tile)
    assert sch is not None, name
    if tile is not None:
        assert sch.tile == tuple(min(t, e) for t, e in
                                 zip(tile, plan.phases[0].out_hw))
    uu, vv = plan.phases[0].out_hw
    assert sch.tiles[0] * sch.tile[0] >= uu > (sch.tiles[0] - 1) * sch.tile[0]
    assert sch.tiles[1] * sch.tile[1] >= vv > (sch.tiles[1] - 1) * sch.tile[1]
    assert sch.gpr * sch.tm >= sch.tile[1]
    assert sch.smem_bytes <= tk.SMEM_BLOCK_MAX
    assert sch.stages >= 3
    assert sch.pitch >= tk.tiled_halo_unit(sch.halo[1] - 1) + 1
    table = phase_table(plan)
    qs, tx, ph, ow0, live, th, tw, row_off, col_off = thread_layout(
        sch, table)
    # every halo read (live or idle thread) lies in the staged halo
    assert np.all(row_off + ph + th - 1 < sch.halo[0])
    assert np.all(col_off + ow0 + sch.tm - 1 + tw - 1 < sch.halo[1])
    # replay the stores of every block (tile, N tile) of one image:
    # (phase, u, v, channel group) counts
    groups = -(-n // 4)
    count = np.zeros((len(plan.phases), uu, vv, groups), int)
    k = np.arange(sch.tm)
    grid = sch.grid(1, n)
    assert grid == (sch.tiles[0] * sch.tiles[1], -(-n // sch.bn), 1)
    for bx in range(grid[0]):
        for ny in range(grid[1]):
            ti, tj = divmod(bx, sch.tiles[1])
            ch = ny * sch.bn // 4 + tx
            u = ti * sch.tile[0] + ph
            pw = ow0[:, None] + k[None, :]
            v = tj * sch.tile[1] + pw
            ok = (live & (ch < groups) & (u < uu))[:, None] \
                & (pw < sch.tile[1]) & (v < vv)
            sel = np.nonzero(ok)
            for q in qs:
                qq = np.broadcast_to(q, live.shape)
                np.add.at(count, (qq[sel[0]], u[sel[0]], v[sel],
                                  ch[sel[0]]), 1)
    assert count.min() == 1 and count.max() == 1, name


def test_shared_window_path_where_phases_share_xoff_and_taps():
    """Path 1 exactly where every phase has 2x2 taps at one xoff: the
    U-Net's up sites and every k4 s2 plan such as the cGAN's; the DCGAN's
    k5 s2 plans take the run-time path, as do nine phases of one shared
    window (they do not split across the shared path's threads)."""
    paths = {}
    for name, plan, c, n, tile in SITES:
        sch = schedule_of(plan, c, n, tile)
        shared = tk.tiled_deconv_path(plan.phases)
        same = all(ex.taps == (2, 2) and ex.xoff == plan.phases[0].xoff
                   for ex in plan.phases)
        assert shared == same, name
        assert sch.path == (shared and len(plan.phases) % 2 == 0), name
        k, s = plan.spec.kernel_hw[0], plan.spec.strides[0]
        paths.setdefault((k, s), set()).add(sch.path)
    assert paths[(4, 2)] == {1}
    assert paths[(5, 2)] == {0}
    assert paths[(6, 3)] == {0}
    assert tk.tiled_deconv_path(
        site_plan(9, 9, 8, 8, 6, 3, ((2, 5), (2, 5))).phases) == 1
    by_name = {s[0]: schedule_of(*s[1:]).path for s in SITES}
    assert by_name["unet512_up0"] == by_name["fig7_cGAN_DC1"] == 1
    assert by_name["fig7_DCGAN_DC1"] == 0


@pytest.mark.parametrize("n,bn", [(1, 4), (3, 4), (4, 4), (5, 32), (32, 32),
                                  (33, 64), (64, 64), (65, 128), (256, 128)])
def test_bn_follows_n(n, bn):
    plan = site_plan(16, 16, 8, n, 4, 2, ((1, 3), (1, 3)))
    assert tk.tiled_deconv_schedule(tuple(plan.phases), plan.out_hw, 8,
                                    n).bn == bn


def test_up0_fits_its_blocks_an_sm_and_fills_the_card_at_batch_1():
    name, plan, c, n, _ = up0()
    sch = schedule_of(plan, c, n, None)
    assert (sch.path, sch.bn, sch.tm, sch.tp) == (1, 32, 8, 4)
    assert sch.fits_sm and sch.blocks_sm * (
        sch.smem_bytes + tk.SMEM_RESERVED) <= tk.SMEM_SM
    assert sch.grid(1, n)[0] * sch.grid(1, n)[1] >= tk.SMS
    # a few hundred phase-output positions a block (the 16-tap superpack
    # is staged once for each), where the old design's tile held 32
    assert sch.tile == (8, 32)
    assert plan.routes[0].sp_tiles == sch.tile == \
        tk.pick_block_tile_transposed(plan.phases, n)


def warp_waves(sch):
    """Replays up0's shared-memory reads: for each warp and span value of a
    tap row (halo) and each (tap, channel, phase) (weights), the 16-byte
    units its 32 lanes read, and the wavefronts that takes (the most
    distinct units on one of the 8 sixteen-byte bank groups) against the
    least any layout could take.  Returns (excess, total)."""
    qs, tx, ph, ow0, live, *_ = thread_layout(sch, None)
    excess = total = 0

    def waves(units):
        nonlocal excess, total
        per_bank = {}
        for u in set(units):
            per_bank.setdefault(u % 8, set()).add(u)
        w = max(len(v) for v in per_bank.values())
        excess += w - -(-len(set(units)) // 8)
        total += w
    for warp in range(sch.threads // 32):
        lanes = range(warp * 32, warp * 32 + 32)
        for m in range(2):
            for j in range(sch.tm + 1):
                waves([(ph[t] + m) * sch.pitch + tk.tiled_halo_unit(ow0[t])
                       + j + j // 8 for t in lanes])
            for t_ in range(4):
                for cc in range(4):
                    for i in range(sch.tp):
                        waves([((qs[i][t] * 4 + t_) * 4 + cc) * sch.bn // 4
                               + tx[t] for t in lanes])
    return excess, total


def test_up0_shared_reads_are_conflict_free():
    name, plan, c, n, _ = up0()
    excess, total = warp_waves(schedule_of(plan, c, n, None))
    assert total > 0 and excess == 0


def test_tiled_verdict_equals_jax_at_every_transposed_site():
    """The 'cuda' route carries a tile exactly where JAX's 'pallas' route
    tiles, at every bucket (only the tile is the card's)."""
    specs = [(name, spec) for name, spec in route_specs()
             if spec.kind == "transposed" and spec.spatial == (1, 1)]
    specs += [(n, s) for n, s in junet.unet_sites(UNET_512)
              if s.kind == "transposed"]
    tiled = []
    for name, spec in specs:
        jp = jplan.plan_conv(dataclasses.replace(spec, backend="pallas"))
        cp = port_plan(spec)
        assert [r.sp_tiles is not None for r in cp.routes] == \
            [r.path == "pallas" and r.sp_tiles is not None
             for r in jp.routes], name
        if cp.routes[0].sp_tiles is not None:
            tiled.append(name)
            sch = tk.tiled_deconv_schedule(tuple(cp.phases), cp.out_hw,
                                           spec.in_c, spec.out_c)
            assert cp.routes[0].sp_tiles == sch.tile, name
    assert "up0" in tiled


def test_variant_table_and_shared_memory_match_the_source():
    """``_TD_VARIANTS`` lists the kernel's D_VARIANT instantiations, and
    the ring's shared memory is the kernel's ``smem_bytes``."""
    src = (pathlib.Path(tk.__file__).parent / "csrc"
           / "untangled_deconv_tiled.cu").read_text()
    lines = {tuple(map(int, m)) for m in re.findall(
        r"^  D_VARIANT\((\d+), (\d+), (\d+), (\d+), (\d+), (\d+)\)$", src,
        re.M)}
    table = {(bn, path, *v) for (path, bn), vs in tk._TD_VARIANTS.items()
             for v in vs}
    assert lines == table
    assert "if (!I8) return g.stages * (halo + wt);" in src
    assert ("return g.stages * (halo + 4 * g.taps * kCK + g.taps * kCK * "
            "BN) + 2 * wt;") in src


@pytest.mark.parametrize("k,s,pads", [
    (4, 2, ((1, 3), (1, 3))), (5, 2, ((2, 3), (2, 3))),
    (4, 2, ((2, 2), (0, 1))), (3, 1, ((1, 1), (2, 0))),
    (2, 3, ((0, 0), (1, 1)))])
def test_cropped_conv_transpose2d_is_the_padded_transposed_conv(k, s, pads):
    """pad (lo, hi) = ``F.conv_transpose2d(padding=0)`` cropped from
    ``k-1-lo`` (``chip_smoke.cropped_library_args``, the library yardstick
    of kernel D), in f64 against zero-insert + pad + correlation."""
    rng = np.random.default_rng(k * 10 + s)
    x = torch.from_numpy(rng.standard_normal((2, 7, 6, 5)))
    kern = torch.from_numpy(rng.standard_normal((k, k, 5, 3)))
    xl, wl, kw, crop = chip_smoke.cropped_library_args(x, kern, (s, s), pads)
    y_lib = F.conv_transpose2d(xl, wl, **kw)[:, :, crop[0], crop[1]] \
        .permute(0, 2, 3, 1)
    y64, _ = ref.conv_oracle_f64(ref.zero_insert(x, (s, s)), kern,
                                 padding=pads)
    assert y_lib.shape == y64.shape
    assert float((y_lib - y64).abs().max()) < 1e-12


def test_cropped_library_equals_kernel_d_plain_version_at_up0_geometry():
    """up0's k4 s2 pad (1, 3) on a 12^2 plane (C = N = 8): the cropped
    ``F.conv_transpose2d`` — one call and a view, ``[:, :, 2:, 2:]`` —
    against ``untangled_deconv2d_tiled_ref`` on the card's up0 tile, within
    f32 tolerance."""
    name, p0, *_ = up0()
    plan = site_plan(12, 12, 8, 8, 4, 2, p0.spec.padding)
    rng = np.random.default_rng(20)
    x = torch.from_numpy(rng.standard_normal((2, 12, 12, 8))
                         .astype(np.float32))
    kern = torch.from_numpy(rng.standard_normal((4, 4, 8, 8))
                            .astype(np.float32))
    xg = pad_or_crop(x, plan.gpad).contiguous()
    y = tk.untangled_deconv2d_tiled_ref(
        xg, plan.pack(kern), phases=plan.phases, out_hw=plan.out_hw,
        strides=(2, 2), sp_tiles=p0.routes[0].sp_tiles)
    xl = x.permute(0, 3, 1, 2)
    wl = kern.flip(0, 1).permute(2, 3, 0, 1)
    y_lib = F.conv_transpose2d(xl, wl, stride=2)[:, :, 2:, 2:]
    assert y_lib.shape == (2, 8, 24, 24)
    assert torch.allclose(y_lib.permute(0, 2, 3, 1), y, rtol=1e-5,
                          atol=1e-5)


def test_kernel_order_sum_within_ulp_bound_at_up0_widths():
    """The kernel's sum of one output, replayed in float32: chunks of 4
    channels, then tap row, tap, channel, each step one rounding of acc +
    x·w (an FFMA), at up0's widths (C = 64, N = 32, k4 s2) on a 6^2 plane
    — within the f64 oracle's ULP bound."""
    name, p0, c, n, _ = up0()
    plan = site_plan(6, 6, c, n, 4, 2, p0.spec.padding)
    rng = np.random.default_rng(21)
    x = rng.standard_normal((1, 6, 6, c)).astype(np.float32)
    kern = rng.standard_normal((4, 4, c, n)).astype(np.float32)
    xg = pad_or_crop(torch.from_numpy(x), plan.gpad).double()
    w = plan.pack(torch.from_numpy(kern)).double()
    y = torch.zeros((1, *plan.out_hw, n), dtype=torch.float32)
    for ex in plan.phases:
        u, v = ex.out_hw
        acc = torch.zeros((u, v, n), dtype=torch.float32)
        for chunk in range(c // 4):
            for t in range(4):
                ti, tj = divmod(t, 2)
                xs = xg[0, ex.xoff[0] + ti:ex.xoff[0] + ti + u,
                        ex.xoff[1] + tj:ex.xoff[1] + tj + v]
                for ch in range(4 * chunk, 4 * chunk + 4):
                    row = (ex.tap_off + t) * c + ch
                    acc = (acc.double() + xs[..., ch, None] * w[row]).float()
        y[0, ex.q[0]::2, ex.q[1]::2] = acc
    y64, amax = ref.conv_oracle_f64(
        ref.zero_insert(torch.from_numpy(x), (2, 2)),
        torch.from_numpy(kern), padding=p0.spec.padding)
    bound = ulp_bound(y64.numpy(), amax.numpy(), 4 * c)
    assert np.all(np.abs(y.double().numpy() - y64.numpy()) <= bound)
