"""Times of kernel B (``untangled_conv2d_superpack``, f32 and int8 entries)
on one GPU, for the ``repro_torch`` of the tree given by ``--src``
(default: this checkout's ``src``), so that two trees can be timed in
turns on one card.

Per DCGAN and cGAN discriminator site and per SegNet site at B = 1 and 64,
and per whole-plane kernel-B site of the U-Net at a 512 px image at B = 16:
the kernel's time over 20 back-to-back calls by CUDA events (``ms``; the
host's Python per call is inside it, and at B = 1 it sets the pace), its
device time per call from ``torch.profiler`` (``device_ms``: the sum of the
call's kernels, the GEMM and, where the schedule splits K, the reduction),
the same two for the int8 entry (bit-equal to the f32 entry on the
dequantized superpack, checked) and for ``F.conv2d`` on the same (f32 or
dequantized) weights (TF32 off), the bound (the larger of bytes over 3.35
TB/s and FP32 operations over 67 TFLOP/s; int8: 1 B a code and 4 B a scale
row) and, where the tree has one, the schedule.  Kernel A at the DCGAN
generator sites is the control.  One JSON object a line, the card's name
and power limit last:

    python tools/time_kernel_b.py [--src DIR] [--label NAME] [--only TEXT]
        [--sweep]

``--only`` keeps the sites whose name holds TEXT (or one of its
comma-separated parts).  ``--sweep`` (trees with
``conv_schedule``) times instead, per site, the f32 kernel's device time
under every tile of the site's BN and, for each, the unsplit schedule and
the splits that give about 132, 264 and 528 work units: the measurements
the schedule's rule is chosen from.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PEAK_FLOPS, PEAK_BW = 67e12, 3.35e12       # H100 SXM: fp32 FFMA, HBM
ITERS, WARMUP = 20, 3


def b_sites(only: str):
    """(name, batches, h, C, N, k, stride, dilation, pads) of every kernel-B
    site timed: the discriminators', the SegNet's and the 512 px U-Net's
    whole-plane ones."""
    from chip_smoke import disc_sites, seg_sites
    from repro_torch.models import unet
    out = [(name, (1, 64), h, c, n, k, s, 1, pads)
           for name, h, c, n, k, s, pads in disc_sites()]
    out += [(name, (1, 64), h, c, n, k, s, d, pads)
            for name, h, c, n, k, s, d, pads in seg_sites()]
    cfg = unet.UNetConfig("unet-512", image_hw=512, backend="cuda")
    for name, p in unet.unet_plans(cfg).items():
        sp = p.spec
        if sp.kind != "transposed" and p.routes[0].sp_tiles is None:
            out.append((f"unet512_{name}", (16,), sp.in_hw[0], sp.in_c,
                        sp.out_c, sp.kernel_hw[0], sp.strides[0],
                        sp.dilation[0], sp.padding))
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
        print("time_kernel_b: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, ROOT)
    from chip_smoke import conv_library_args
    from repro_torch.core.plan import ConvSpec, plan_conv
    from repro_torch.core.untangle import pad_or_crop
    from repro_torch.kernels import _build
    from repro_torch.kernels import untangled_conv as tk
    from repro_torch.models import gan
    from repro_torch.runtime.compress import (dequantize_int8,
                                              quantize_int8_rows)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _build.build(("untangled_deconv", "untangled_conv"))
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
        calls under the profiler, and the kernels a call launches."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(ITERS):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        return (sum(e.device_time_total for e in evs) / 1e3 / ITERS,
                len(evs) / ITERS)

    def timed(fn):
        ms = time_ms(fn)
        dms, kernels = device_ms(fn)
        return {"ms": ms, "device_ms": dms, "kernels_a_call": kernels}

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

    def sweep(name, b, xp, sp, kw, y):
        """The f32 kernel's device time under each candidate schedule of
        one site (``conv_schedule`` patched for the call)."""
        m, kk, n = y.shape[0] * y.shape[1] * y.shape[2], sp.shape[0], \
            sp.shape[1]
        chunks = -(-kk // tk._CONV_BK)
        default = tk.conv_schedule(m, kk, n)
        bn = default.tile[1]
        for config, (bm_, bn_, _) in enumerate(tk._CONV_CONFIGS):
            if bn_ != bn:
                continue
            tiles = -(-m // bm_) * -(-n // bn_)
            lengths = {chunks} | {-(-chunks // -(-t // tiles))
                                  for t in (132, 264, 528)
                                  if 2 <= -(-t // tiles) <= chunks}
            for length in sorted(lengths, reverse=True):
                sch = tk._conv_schedule(config, m, chunks, n, length)
                if sch.workspace_bytes > tk._WORKSPACE_MAX:
                    continue
                real = tk.conv_schedule
                tk.conv_schedule = lambda *_: sch  # noqa: E731
                try:
                    dms, _ = device_ms(lambda: tk.untangled_conv2d_superpack(
                        xp, sp, **kw))
                    ok = torch.equal(tk.untangled_conv2d_superpack(
                        xp, sp, **kw), y) or sch.slices != default.slices
                finally:
                    tk.conv_schedule = real
                print(json.dumps({
                    "label": label, "sweep": name, "batch": b,
                    "tile": sch.tile, "chunk_len": sch.chunk_len,
                    "slices": sch.slices, "units": sch.units,
                    "device_ms": dms, "default": sch == default,
                    "same_order_bit_equal": ok}), flush=True)

    for name, batches, h, c, n, k, s, d, pads in b_sites(args.only):
        for b in batches:
            x, kern = randn(b, h, h, c), randn(k, k, c, n)
            xp = pad_or_crop(x, pads).contiguous()
            del x
            sp = kern.reshape(k * k * c, n)
            q, scale = quantize_int8_rows(sp)
            wd = dequantize_int8(q, scale)
            kw = dict(taps_hw=(k, k), strides=(s, s), rhs_dilation=(d, d))
            y = tk.untangled_conv2d_superpack(xp, sp, **kw)
            y8 = tk.untangled_conv2d_superpack(xp, q, scales=scale, **kw)
            if not torch.equal(y8, tk.untangled_conv2d_superpack(xp, wd,
                                                                  **kw)):
                raise RuntimeError(f"{name} B={b}: int8 is not bit-equal to "
                                   f"f32 on the dequantized superpack")
            if args.sweep:
                sweep(name, b, xp, sp, kw, y)
                del xp, sp, q, scale, wd, y, y8
                torch.cuda.empty_cache()
                continue
            flops = 2 * y.numel() * k * k * c
            rec = {"label": label, "kernel": "B", "site": name, "batch": b,
                   "flops": flops,
                   "f32": {**timed(lambda: tk.untangled_conv2d_superpack(
                       xp, sp, **kw)), **bound(
                           flops, 4 * (xp.numel() + sp.numel()
                                       + y.numel()))},
                   "int8": {**timed(lambda: tk.untangled_conv2d_superpack(
                       xp, q, scales=scale, **kw)), **bound(
                           flops, 4 * xp.numel() + q.numel()
                           + 4 * scale.numel() + 4 * y.numel())}}
            xl, wl, lkw = conv_library_args(xp, kern, (s, s), (d, d))
            rec["library"] = library(xl, wl, lkw, y)
            _, wl8, _ = conv_library_args(xp, wd.reshape(k, k, c, n),
                                          (s, s), (d, d))
            rec["library_int8"] = library(xl, wl8, lkw, y8)
            if hasattr(tk, "conv_schedule"):
                sch = tk.conv_schedule(y.shape[0] * y.shape[1] * y.shape[2],
                                       k * k * c, n)
                rec["schedule"] = {"tile": sch.tile, "bk": sch.bk,
                                   "chunk_len": sch.chunk_len,
                                   "slices": sch.slices, "units": sch.units,
                                   "workspace_bytes": sch.workspace_bytes}
            print(json.dumps(rec), flush=True)
            del xp, xl, sp, q, scale, wd, y, y8
            torch.cuda.empty_cache()
    if not (args.only or args.sweep):
        for b in (1, 64):
            for i, l in enumerate(gan.DCGAN_LAYERS):
                pads = gan.deconv_padding(l.kernel, l.stride)
                plan = plan_conv(ConvSpec(
                    kind="transposed", in_hw=(l.in_hw, l.in_hw),
                    in_c=l.in_c, out_c=l.out_c,
                    kernel_hw=(l.kernel, l.kernel),
                    strides=(l.stride, l.stride), padding=pads,
                    backend="cuda"))
                xg = pad_or_crop(randn(b, l.in_hw, l.in_hw, l.in_c),
                                 plan.gpad).contiguous()
                packed = plan.pack(randn(l.kernel, l.kernel, l.in_c,
                                         l.out_c))
                call = lambda: tk.untangled_deconv2d(  # noqa: E731
                    xg, packed, phases=plan.phases, out_hw=plan.out_hw,
                    strides=plan.spec.strides, sum_uv=plan.sum_uv)
                print(json.dumps({"label": label, "kernel": "A",
                                  "site": f"DCGAN_DC{i + 1}", "batch": b,
                                  "f32": timed(call)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
