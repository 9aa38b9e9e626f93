"""Times of kernel A (``untangled_deconv2d``, f32 and int8 entries) on one
GPU, for the ``repro_torch`` of the tree given by ``--src`` (default: this
checkout's ``src``), so that two trees can be timed in turns on one card.

Per DCGAN and cGAN generator site at B = 1 and 64: the kernel's time over
20 back-to-back calls by CUDA events (``ms``; the host's Python per call
is inside it, and at B = 1 it sets the pace), its device time per call
from ``torch.profiler`` (``device_ms``: the sum of the call's kernels, the
GEMM and, where the schedule splits K, the reduction), the same two for
the int8 entry and for ``F.conv_transpose2d`` on the same inputs (TF32
off; none yet for the cGAN's pad, whose uncropped call has no form: the
cropped one, ``chip_smoke.cropped_library_args``, serves kernel D), the
bound (the larger of bytes over 3.35 TB/s and FP32 operations over 67
TFLOP/s) and, where the tree has one, the schedule.  Kernel B at the DCGAN
discriminator sites is the control.  Then the DCGAN generator forward per
bucket (CUDA events) and its device busy share at B = 1 and 64.  One JSON
object a line, the card's name and power limit last:

    python tools/time_kernel_a.py [--src DIR] [--label NAME]
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="this checkout")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("time_kernel_a: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, ROOT)
    from chip_smoke import conv_library_args, library_args
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

    layers = [(f"DCGAN_DC{i + 1}", l) for i, l in enumerate(gan.DCGAN_LAYERS)]
    layers += [(f"cGAN_DC{i + 1}", l) for i, l in enumerate(gan.CGAN_LAYERS)]
    for b in (1, 64):
        for name, l in layers:
            pads = gan.deconv_padding(l.kernel, l.stride)
            plan = plan_conv(ConvSpec(
                kind="transposed", in_hw=(l.in_hw, l.in_hw), in_c=l.in_c,
                out_c=l.out_c, kernel_hw=(l.kernel, l.kernel),
                strides=(l.stride, l.stride), padding=pads, backend="cuda"))
            x = randn(b, l.in_hw, l.in_hw, l.in_c)
            kern = randn(l.kernel, l.kernel, l.in_c, l.out_c)
            packed = plan.pack(kern)
            q, scale = quantize_int8_rows(packed)
            wd = dequantize_int8(q, scale)
            xg = pad_or_crop(x, plan.gpad).contiguous()
            kw = dict(phases=plan.phases, out_hw=plan.out_hw,
                      strides=plan.spec.strides, sum_uv=plan.sum_uv)
            y = tk.untangled_deconv2d(xg, packed, **kw)
            y8 = tk.untangled_deconv2d(xg, q, scales=scale, **kw)
            if not torch.equal(y8, tk.untangled_deconv2d(xg, wd, **kw)):
                raise RuntimeError(f"{name} B={b}: int8 is not bit-equal to "
                                   f"f32 on the dequantized superpack")
            flops = 2 * sum(b * ex.out_hw[0] * ex.out_hw[1] * ex.taps[0]
                            * ex.taps[1] for ex in plan.phases) \
                * l.in_c * l.out_c
            rec = {"label": args.label, "kernel": "A", "site": name,
                   "batch": b, "flops": flops,
                   "f32": {**timed(lambda: tk.untangled_deconv2d(
                       xg, packed, **kw)), **bound(
                           flops, 4 * (xg.numel() + packed.numel()
                                       + y.numel()))},
                   "int8": {**timed(lambda: tk.untangled_deconv2d(
                       xg, q, scales=scale, **kw)), **bound(
                           flops, 4 * xg.numel() + q.numel()
                           + 4 * scale.numel() + 4 * y.numel())}}
            try:
                xl, wl, lkw = library_args(x, kern, plan.spec.strides, pads)
            except ValueError:
                rec["library"] = None
            else:
                y_lib = F.conv_transpose2d(xl, wl, **lkw).permute(0, 2, 3, 1)
                err = float((y_lib - y).abs().max())
                if err > 2e-4 * (1 + float(y.abs().max())):
                    raise RuntimeError(f"{name} B={b}: library off by {err}")
                rec["library"] = timed(lambda: F.conv_transpose2d(xl, wl,
                                                                  **lkw))
            if hasattr(tk, "deconv_schedule"):
                sch = tk.deconv_schedule(tuple(plan.phases), b, l.in_c,
                                         l.out_c)
                rec["schedule"] = {"tile": sch.tile, "bk": sch.bk,
                                   "chunk_len": sch.chunk_len,
                                   "slices": sch.slices, "units": sch.units,
                                   "workspace_bytes": sch.workspace_bytes}
            print(json.dumps(rec), flush=True)
            del x, xg, packed, q, scale, wd, y, y8
        for i, l in enumerate(reversed(gan.DCGAN_LAYERS)):
            h, c, n, k, s = l.in_hw * l.stride, l.out_c, l.in_c, l.kernel, \
                l.stride
            x, kern = randn(b, h, h, c), randn(k, k, c, n)
            xp = pad_or_crop(x, ((k // 2, (k - 1) // 2),) * 2).contiguous()
            sp = kern.reshape(k * k * c, n)
            xl, wl, lkw = conv_library_args(xp, kern, (s, s), (1, 1))
            call = lambda: tk.untangled_conv2d_superpack(  # noqa: E731
                xp, sp, taps_hw=(k, k), strides=(s, s))
            print(json.dumps({"label": args.label, "kernel": "B",
                              "site": f"DCGAN_D{i + 1}", "batch": b,
                              "f32": timed(call), "library": timed(
                                  lambda: F.conv2d(xl, wl, **lkw))}),
                  flush=True)
    cfg = gan.GANConfig("dcgan", gan.DCGAN_LAYERS, backend="cuda")
    params = gan.generator_init(0, cfg, device=dev)
    fwd = {}
    with torch.inference_mode():
        for b in (1, 4, 16, 64):
            z = randn(b, cfg.z_dim)
            call = lambda: gan.generator_apply(params, z, cfg)  # noqa: E731
            fwd[b] = timed(call)
            fwd[b]["busy_share"] = fwd[b]["device_ms"] / fwd[b]["ms"]
    print(json.dumps({"label": args.label, "generator_forward": fwd}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
