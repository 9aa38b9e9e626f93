"""Times of kernel D (``untangled_deconv2d`` with ``sp_tiles=``, f32 and
int8 entries) on one GPU, for the ``repro_torch`` of the tree given by
``--src`` (default: this checkout's ``src``), so that two trees can be
timed in turns on one card.

At the U-Net's tiled transposed site — up0 of a 512 px image (256^2 ->
512^2, 64 -> 32 channels, k4 s2, pad (1, 3)) — at B = 1 and 16, on the
tile the tree's route carries: the kernel's time over 20 back-to-back calls
by CUDA events (``ms``) and its device time per call from
``torch.profiler`` (``device_ms``), the same two for the int8 entry
(bit-equal to the f32 entry on the dequantized superpack, checked), for
kernel A on the whole plane (f32) and for the library, ``F.conv_transpose2d``
at ``padding=0`` cropped to the pad (one call and a view; the NCHW input
and the (C, N, k, k) kernel made outside the timed call, TF32 off, checked
against the kernel first), the bound (the larger of bytes over 3.35 TB/s
and FP32 operations over 67 TFLOP/s; int8: 1 B a code and 4 B a scale
row) and, where the tree has one, the schedule.  Kernel C at fuse0 (B = 1
and 16) is the control.  One JSON object a line, the card's name and power
limit last:

    python tools/time_kernel_d.py [--src DIR] [--label NAME] [--only TEXT]
        [--sweep]

``--only`` keeps the sites whose name holds TEXT (or one of its
comma-separated parts; the control is then left out).  ``--sweep`` (trees
with ``tiled_deconv_schedule``) times instead, per site and batch, the f32
and int8 kernels' device time under every register split the kernel
instantiates at the site's tap loop and BN, every tile the schedule
considers for it, and 3 to 6 ring stages where they fit one block: the
measurements the schedule's choices come from.
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
BATCHES = (1, 16)


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
        print("time_kernel_d: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, ROOT)
    from chip_smoke import cropped_library_args
    from repro_torch.core.untangle import pad_or_crop
    from repro_torch.kernels import _build
    from repro_torch.kernels import untangled_conv as tk
    from repro_torch.models import unet
    from repro_torch.runtime.compress import (dequantize_int8,
                                              quantize_int8_rows)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _build.build(("untangled_deconv", "untangled_conv_tiled",
                  "untangled_deconv_tiled"))
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    label = args.label
    plans = unet.unet_plans(unet.UNetConfig("unet-512", image_hw=512,
                                            backend="cuda"))

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

    def schedule_of(plan, c, n, tile):
        if not hasattr(tk, "tiled_deconv_schedule"):
            return {"tile": tile}
        sch = tk.tiled_deconv_schedule(tuple(plan.phases), plan.out_hw, c,
                                       n, tile)
        return {"path": sch.path, "bn": sch.bn,
                "split": (sch.tm, sch.tp, sch.threads, sch.blocks_sm),
                "tile": sch.tile, "halo": sch.halo, "pitch": sch.pitch,
                "stages": sch.stages, "smem_bytes": sch.smem_bytes,
                "tiles": sch.tiles}

    def sweep(name, b, plan, c, n, calls):
        """Device ms of the f32 and int8 kernels under each candidate
        layout of one site (``tiled_deconv_schedule`` patched for the
        call)."""
        real = tk.tiled_deconv_schedule
        phases = tuple(plan.phases)
        default = real(phases, plan.out_hw, c, n)
        path, bn = default.path, default.bn
        uu, vv = phases[0].out_hw
        for variant in tk._TD_VARIANTS[(path, bn)]:
            tm, tp, threads, _ = variant
            ncg = (len(phases) // tp if path == 1 else 1) * (bn // 4)
            cap = threads // ncg // (1 if path == 1 else len(phases))
            for gpr in tk._pow2_tiles(cap):
                tile = (min(cap // gpr, uu), min(gpr * tm, vv))
                base = tk._td_schedule(tile, phases, c, bn, path, variant)
                if base is None:
                    continue
                for stages in (3, 4, 5, 6):
                    smem = max(tk.tiled_conv_smem_bytes(
                        bn, base.halo[0], base.pitch, base.taps, stages, i8)
                        for i8 in (False, True))
                    if smem > tk.SMEM_BLOCK_MAX:
                        continue
                    sch = dataclasses.replace(base, stages=stages,
                                              smem_bytes=smem)
                    tk.tiled_deconv_schedule = lambda *_a, **_k: sch  # noqa
                    try:
                        rec = {"label": label, "sweep": name, "batch": b,
                               "split": variant, "tile": tile,
                               "stages": stages, "fits_sm": sch.fits_sm,
                               "default": (variant, tile, stages) == (
                                   (default.tm, default.tp, default.threads,
                                    default.blocks_sm), default.tile,
                                   default.stages),
                               "f32_device_ms": device_ms(
                                   lambda: calls[0](tile)),
                               "int8_device_ms": device_ms(
                                   lambda: calls[1](tile))}
                    finally:
                        tk.tiled_deconv_schedule = real
                    print(json.dumps(rec), flush=True)

    only = args.only.split(",") if args.only else [""]
    sites = [(f"unet512_{name}", p) for name, p in plans.items()
             if p.spec.kind == "transposed"
             and p.routes[0].sp_tiles is not None]
    for name, plan in sites:
        if not any(t in name for t in only):
            continue
        sp_ = plan.spec
        c, n = sp_.in_c, sp_.out_c
        tile = plan.routes[0].sp_tiles
        kern = randn(*sp_.kernel_hw, c, n)
        packed = plan.pack(kern)
        q, scale = quantize_int8_rows(packed)
        wd = dequantize_int8(q, scale)
        for b in BATCHES:
            x = randn(b, *sp_.in_hw, c)
            xg = pad_or_crop(x, plan.gpad).contiguous()
            kw = dict(phases=plan.phases, out_hw=plan.out_hw,
                      strides=sp_.strides, sum_uv=plan.sum_uv)

            def f32(t=tile, w=packed):
                return tk.untangled_deconv2d(xg, w, sp_tiles=t, **kw)

            def i8(t=tile):
                return tk.untangled_deconv2d(xg, q, scales=scale,
                                             sp_tiles=t, **kw)
            y, y8 = f32(), i8()
            if not torch.equal(y8, f32(w=wd)):
                raise RuntimeError(f"{name} B={b}: int8 is not bit-equal to "
                                   f"f32 on the dequantized superpack")
            if args.sweep:
                sweep(name, b, plan, c, n, (f32, i8))
                del x, xg, y, y8
                torch.cuda.empty_cache()
                continue
            flops = 2 * sum(b * ex.out_hw[0] * ex.out_hw[1] * ex.taps[0]
                            * ex.taps[1] for ex in plan.phases) * c * n
            xl, wl, lkw, crop = cropped_library_args(x, kern, sp_.strides,
                                                     sp_.padding)
            _, wl8, _, _ = cropped_library_args(x, plan.unpack(wd),
                                                sp_.strides, sp_.padding)
            del x

            def library(w_=wl):
                return F.conv_transpose2d(xl, w_, **lkw)[:, :, crop[0],
                                                         crop[1]]
            lib_err = {}
            for tag, w_, y_ in (("f32", wl, y), ("int8", wl8, y8)):
                err = float((library(w_).permute(0, 2, 3, 1) - y_).abs()
                            .max())
                if err > 2e-4 * (1 + float(y_.abs().max())):
                    raise RuntimeError(f"library off by {err}")
                lib_err[tag] = err
            rec = {"label": label, "kernel": "D", "site": name, "batch": b,
                   "flops": flops, "schedule": schedule_of(plan, c, n, tile),
                   "f32": {**timed(f32), **bound(
                       flops, 4 * (xg.numel() + packed.numel()
                                   + y.numel()))},
                   "int8": {**timed(i8), **bound(
                       flops, 4 * xg.numel() + q.numel()
                       + 4 * scale.numel() + 4 * y.numel())},
                   "kernel_A": timed(lambda: tk.untangled_deconv2d(
                       xg, packed, **kw)),
                   "library": {**timed(library),
                               "max_abs_err": lib_err["f32"]},
                   "library_int8": {**timed(lambda: library(wl8)),
                                    "max_abs_err": lib_err["int8"]}}
            print(json.dumps(rec), flush=True)
            del xg, xl, y, y8
            torch.cuda.empty_cache()
    if not (args.only or args.sweep):
        plan = plans["fuse0"]
        sp_ = plan.spec
        (r, s), tile = sp_.kernel_hw, plan.routes[0].sp_tiles
        sp = randn(r * s * sp_.in_c, sp_.out_c)
        for b in BATCHES:
            xp = pad_or_crop(randn(b, *sp_.in_hw, sp_.in_c),
                             sp_.padding).contiguous()
            call = lambda: tk.untangled_conv2d_superpack(  # noqa: E731
                xp, sp, taps_hw=(r, s), strides=sp_.strides, sp_tiles=tile)
            print(json.dumps({"label": label, "kernel": "C",
                              "site": "unet512_fuse0", "batch": b,
                              "tile": tile, "f32": timed(call)}), flush=True)
            del xp
            torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
