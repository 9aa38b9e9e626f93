"""Times of kernel C (``untangled_conv2d_superpack`` with ``sp_tiles=``, f32
and int8 entries) on one GPU, for the ``repro_torch`` of the tree given by
``--src`` (default: this checkout's ``src``), so that two trees can be
timed in turns on one card.

Per tiled site — the U-Net at a 512 px image (stem, down0, fuse0, head) at
B = 1 and 16, and the 385 px 32 -> 32 context sites at d = 2 and d = 4 at
B = 1 — on the tile the tree's ``pick_block_tile_single`` gives: the
kernel's time over 20 back-to-back calls by CUDA events (``ms``) and its
device time per call from ``torch.profiler`` (``device_ms``), the same two
for the int8 entry (bit-equal to the f32 entry on the dequantized
superpack, checked), for kernel B on the same site (whole plane, f32) and
for ``F.conv2d`` on the same (f32 or dequantized) weights (TF32 off), the
bound (the larger of bytes over 3.35 TB/s and FP32 operations over 67
TFLOP/s; int8: 1 B a code and 4 B a scale row) and, where the tree has
one, the schedule.  Kernel D at the U-Net's up0 (B = 1 and 16) is the
control.  One JSON object a line, the card's name and power limit last:

    python tools/time_kernel_c.py [--src DIR] [--label NAME] [--only TEXT]
        [--sweep]

``--only`` keeps the sites whose name holds TEXT (or one of its
comma-separated parts).  ``--sweep`` (trees with ``tiled_conv_schedule``)
times instead, per site, the f32 and int8 kernels' device time under
every tile shape the schedule considers at the site's BN (and the next
smaller BN), each with 3 to 6 ring stages where they fit one block: the
measurements the schedule's rule is chosen from.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PEAK_FLOPS, PEAK_BW = 67e12, 3.35e12       # H100 SXM: fp32 FFMA, HBM
ITERS, WARMUP = 20, 3


def c_sites(only: str):
    """(name, batches, in_hw, C, N, taps, stride, dilation, pads) of every
    kernel-C site timed."""
    from repro_torch.models import unet
    cfg = unet.UNetConfig("unet-512", image_hw=512, backend="cuda")
    out = []
    for name, p in unet.unet_plans(cfg).items():
        sp = p.spec
        if sp.kind != "transposed" and p.routes[0].sp_tiles is not None:
            out.append((f"unet512_{name}", (1, 16), sp.in_hw[0], sp.in_c,
                        sp.out_c, sp.kernel_hw[0], sp.strides[0],
                        sp.dilation[0], sp.padding))
    for d in (2, 4):
        out.append((f"ctx385_d{d}", (1,), 385, 32, 32, 3, 1, d,
                    ((d, d), (d, d))))
    return [s for s in out if any(t in s[0] for t in only.split(","))]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--only", default="")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("time_kernel_c: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, ROOT)
    from chip_smoke import conv_library_args
    from repro_torch.core.untangle import pad_or_crop
    from repro_torch.kernels import _build
    from repro_torch.kernels import untangled_conv as tk
    from repro_torch.models import unet
    from repro_torch.runtime.compress import (dequantize_int8,
                                              quantize_int8_rows)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _build.build(("untangled_conv", "untangled_conv_tiled",
                  "untangled_deconv_tiled"))
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    label = args.label

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    def time_ms(fn):
        for _ in range(WARMUP):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(ITERS):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / ITERS

    def device_ms(fn):
        """Device time of one call: the call's kernels, summed, over ITERS
        calls under the profiler.  A trace short of one kernel a call (CUPTI
        now and then drops a trace) is taken again, up to three times; then
        None, not measured."""
        fn()
        torch.cuda.synchronize()
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(ITERS):
                    fn()
                torch.cuda.synchronize()
            evs = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and e.device_time_total > 0]
            if len(evs) >= ITERS:
                return sum(e.device_time_total for e in evs) / 1e3 / ITERS
        return None

    def timed(fn):
        return {"ms": time_ms(fn), "device_ms": device_ms(fn)}

    def bound(flops, nbytes):
        t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BW * 1e3
        return {"bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes"}

    def library(xl, wl, lkw, y):
        y_lib = F.conv2d(xl, wl, **lkw).permute(0, 2, 3, 1)
        err = float((y_lib - y).abs().max())
        if err > 2e-4 * (1 + float(y.abs().max())):
            raise RuntimeError(f"library off by {err}")
        return timed(lambda: F.conv2d(xl, wl, **lkw))

    def schedule_of(out_hw, k, s, d, c, n, tile):
        if not hasattr(tk, "tiled_conv_schedule"):
            return {"tile": tile}
        sch = tk.tiled_conv_schedule(out_hw, (k, k), (s, s), (d, d), c, n,
                                     tile)
        return {"tile": sch.tile, "bn": sch.bn, "path": sch.path,
                "pd": sch.pd, "halo": sch.halo, "pitch": sch.pitch,
                "stages": sch.stages, "threads": sch.threads,
                "blocks_sm": sch.blocks_sm, "smem_bytes": sch.smem_bytes,
                "tiles": sch.tiles}

    def sweep(name, b, out_hw, k, s, d, c, n, calls):
        """Device ms of the f32 and int8 kernels under each candidate
        layout of one site (``tiled_conv_schedule`` patched for the
        call)."""
        real = tk.tiled_conv_schedule
        default = real(out_hw, (k, k), (s, s), (d, d), c, n)
        seen = set()
        for bn in sorted({default.bn, max(32, default.bn // 2)}
                         if default.bn > 4 else {4}):
            threads, _ = tk._TILED_CONV_BLOCKS[bn]
            groups = threads // (bn // tk._TC_TN)
            path = tk.tiled_conv_path((k, k), (s, s), (d, d))
            pd = d if path == 1 else 1
            for blocks in tk._pow2_tiles(groups // pd):
                tile = (min(groups // (blocks * pd), out_hw[0]),
                        min(blocks * tk._TC_TM * pd, out_hw[1]))
                base = tk._tc_schedule(tile, out_hw, (k, k), (s, s), (d, d),
                                       c, bn, path)
                if base is None:
                    continue
                for stages in (3, 4, 5, 6):
                    smem = max(tk.tiled_conv_smem_bytes(
                        bn, base.halo[0], base.pitch, k * k, stages, i8)
                        for i8 in (False, True))
                    if smem > tk.SMEM_BLOCK_MAX or (bn, tile, stages) in seen:
                        continue
                    seen.add((bn, tile, stages))
                    sch = dataclasses.replace(base, stages=stages,
                                              smem_bytes=smem)
                    tk.tiled_conv_schedule = lambda *_a, **_k: sch  # noqa
                    try:
                        rec = {"label": label, "sweep": name, "batch": b,
                               "bn": bn, "tile": tile, "stages": stages,
                               "fits_sm": sch.fits_sm,
                               "default": (bn, tile, stages) == (
                                   default.bn, default.tile,
                                   default.stages),
                               "f32_device_ms": device_ms(calls[0]),
                               "int8_device_ms": device_ms(calls[1])}
                    finally:
                        tk.tiled_conv_schedule = real
                    print(json.dumps(rec), flush=True)

    for name, batches, h, c, n, k, s, d, pads in c_sites(args.only):
        for b in batches:
            x, kern = randn(b, h, h, c), randn(k, k, c, n)
            xp = pad_or_crop(x, pads).contiguous()
            del x
            sp = kern.reshape(k * k * c, n)
            q, scale = quantize_int8_rows(sp)
            wd = dequantize_int8(q, scale)
            out_hw = tk.single_out_hw(xp.shape[1], xp.shape[2], (k, k),
                                      (s, s), (d, d))
            tile = tk.pick_block_tile_single(out_hw, (k, k), (s, s), (d, d),
                                             n)
            kw = dict(taps_hw=(k, k), strides=(s, s), rhs_dilation=(d, d))
            f32 = lambda: tk.untangled_conv2d_superpack(  # noqa: E731
                xp, sp, sp_tiles=tile, **kw)
            i8 = lambda: tk.untangled_conv2d_superpack(  # noqa: E731
                xp, q, scales=scale, sp_tiles=tile, **kw)
            y, y8 = f32(), i8()
            if not torch.equal(y8, tk.untangled_conv2d_superpack(
                    xp, wd, sp_tiles=tile, **kw)):
                raise RuntimeError(f"{name} B={b}: int8 is not bit-equal to "
                                   f"f32 on the dequantized superpack")
            if args.sweep:
                sweep(name, b, out_hw, k, s, d, c, n, (f32, i8))
                del xp, sp, q, scale, wd, y, y8
                torch.cuda.empty_cache()
                continue
            flops = 2 * y.numel() * k * k * c
            rec = {"label": label, "kernel": "C", "site": name, "batch": b,
                   "flops": flops,
                   "schedule": schedule_of(out_hw, k, s, d, c, n, tile),
                   "f32": {**timed(f32), **bound(
                       flops, 4 * (xp.numel() + sp.numel() + y.numel()))},
                   "int8": {**timed(i8), **bound(
                       flops, 4 * xp.numel() + q.numel()
                       + 4 * scale.numel() + 4 * y.numel())},
                   "kernel_B": timed(lambda: tk.untangled_conv2d_superpack(
                       xp, sp, **kw))}
            xl, wl, lkw = conv_library_args(xp, kern, (s, s), (d, d))
            rec["library"] = library(xl, wl, lkw, y)
            _, wl8, _ = conv_library_args(xp, wd.reshape(k, k, c, n),
                                          (s, s), (d, d))
            rec["library_int8"] = library(xl, wl8, lkw, y8)
            print(json.dumps(rec), flush=True)
            del xp, xl, sp, q, scale, wd, y, y8
            torch.cuda.empty_cache()
    if not (args.only or args.sweep):
        cfg = unet.UNetConfig("unet-512", image_hw=512, backend="cuda")
        plan = unet.unet_plans(cfg)["up0"]
        sp_ = plan.spec
        tile = plan.routes[0].sp_tiles
        packed = plan.pack(randn(*sp_.kernel_hw, sp_.in_c, sp_.out_c))
        for b in (1, 16):
            xg = pad_or_crop(randn(b, *sp_.in_hw, sp_.in_c),
                             plan.gpad).contiguous()
            call = lambda: tk.untangled_deconv2d(  # noqa: E731
                xg, packed, phases=plan.phases, out_hw=plan.out_hw,
                strides=sp_.strides, sum_uv=plan.sum_uv, sp_tiles=tile)
            print(json.dumps({"label": label, "kernel": "D",
                              "site": "unet512_up0", "batch": b,
                              "tile": tile, "f32": timed(call)}), flush=True)
            del xg
            torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
