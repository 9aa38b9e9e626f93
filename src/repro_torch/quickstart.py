"""Quickstart: one transposed convolution through the port's engine,
against the naive (DarkNet-style) zero-insertion engine and the library
oracle.

Counterpart of ``examples/quickstart.py``: the DCGAN's DC2 (8x8x512 ->
16x16x256, 5x5 kernel, stride 2) through ``huge_conv_transpose2d`` on the
``--backend`` route, the naive engine and ``F.conv2d`` on the zero-inserted
plane must agree; each engine's time per call is printed; then the same op
on the 'cuda' route (kernel A on the card, its plain version on the CPU).

    PYTHONPATH=src python -m repro_torch.quickstart [--backend cuda|torch]
        [--device cuda|cpu] [--iters 10]
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core import huge_conv_transpose2d, reference as ref
from repro_torch.core import resolve_device

TOL = 2e-4


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _check(name: str, got: torch.Tensor, want: torch.Tensor):
    err = float((got - want).abs().max())
    if err > TOL * (1 + float(want.abs().max())):
        raise RuntimeError(f"{name} differs from the oracle by {err:.3e}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", choices=("torch", "cuda"), default="cuda")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    gen = torch.Generator().manual_seed(0)
    x = torch.randn((1, 8, 8, 512), generator=gen).to(dev)
    k = torch.randn((5, 5, 512, 256), generator=gen).to(dev)
    strides, pad = (2, 2), ((2, 3), (2, 3))

    def huge():
        with torch.inference_mode():
            return huge_conv_transpose2d(x, k, strides, pad, args.backend)

    def naive():
        return ref.naive_conv_transpose2d(x, k, strides=strides,
                                          padding=pad)

    y_o = ref.oracle_conv_transpose2d(x, k, strides=strides, padding=pad)
    y_h, y_n = huge(), naive()
    _check("HUGE2", y_h, y_o)
    _check("naive", y_n, y_o)
    print(f"output {tuple(y_h.shape)} — HUGE2 == naive == oracle  ✓")

    times = {}
    for name, fn in (("naive(zero-insert+im2col)", naive), ("HUGE2", huge)):
        fn()
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(args.iters):
            fn()
        _sync(dev)
        times[name] = (time.perf_counter() - t0) / max(1, args.iters) * 1e3
        print(f"{name:28s} {times[name]:7.2f} ms/call (device {dev})")

    with torch.inference_mode():
        y_k = huge_conv_transpose2d(x, k, strides, pad, "cuda")
    _check("the 'cuda' route", y_k, y_o)
    what = "kernel A" if dev.type == "cuda" else "kernel A's plain version"
    print(f"'cuda' route ({what}) matches  ✓")
    return times


if __name__ == "__main__":
    main()
