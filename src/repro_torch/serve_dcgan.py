"""Serve the DCGAN generator on the port: model load, bucket warmup, an
open-loop drive through ``DynamicImageBatcher`` and the latency report.

Counterpart of ``examples/serve_dcgan.py`` without the control plane (its
SLO admission, fault replay and autotune cache come with later slices).
Latent requests arrive at ``--rate`` req/s (0 = one burst); the batcher
coalesces them into the plan batch buckets (1/4/16/64).

    PYTHONPATH=src python -m repro_torch.serve_dcgan [--requests 64]
        [--rate 0] [--max-wait-ms 2] [--backend cuda|torch] [--small]
        [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.models import gan
from repro_torch.serving.image_batcher import DynamicImageBatcher
from repro_torch.serving.metrics import format_stats

SMALL_LAYERS = (
    gan.DeconvLayer(4, 128, 64, 5, 2),
    gan.DeconvLayer(8, 64, 32, 5, 2),
    gan.DeconvLayer(16, 32, 3, 5, 2),
)


def load_model(*, small: bool, backend: str, device, seed: int = 0):
    """Build every conv plan and pack the weights once: (cfg, params)."""
    layers = SMALL_LAYERS if small else gan.DCGAN_LAYERS
    cfg = gan.GANConfig("dcgan", layers, backend=backend)
    gan.generator_plans(cfg)
    return cfg, gan.generator_init(seed, cfg, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--rate", type=float, default=0.0,
                    help="arrival rate in req/s (0 = submit all at once)")
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--backend", choices=("torch", "cuda"), default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="reduced 32px generator")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    t_load = time.perf_counter()
    cfg, params = load_model(small=args.small, backend=args.backend,
                             device=args.device)
    plans = gan.generator_plans(cfg)
    t_load = time.perf_counter() - t_load
    print(f"model load: {len(plans)} conv plans built + weights packed "
          f"in {t_load * 1e3:.1f} ms "
          f"(plan build {sum(p.build_ms for p in plans):.2f} ms; routes "
          f"{[p.path for p in plans]})")

    batcher = DynamicImageBatcher(
        lambda z: gan.generator_apply(params, z, cfg),
        max_wait_ms=args.max_wait_ms, device=args.device)
    proto = np.zeros((cfg.z_dim,), np.float32)
    t0 = time.perf_counter()
    batcher.warmup(proto)
    print(f"warmup: buckets {batcher.buckets} run and timed in "
          f"{time.perf_counter() - t0:.2f} s "
          f"(ms {[round(batcher.bucket_cost_s[b] * 1e3, 3) for b in batcher.buckets]})")

    rng = np.random.default_rng(0)
    payloads = [rng.standard_normal(cfg.z_dim).astype(np.float32)
                for _ in range(args.requests)]
    done = batcher.drive_open_loop(lambda i: payloads[i], args.requests,
                                   rate=args.rate)
    st = batcher.stats()
    print(f"served {st['completed']} of {args.requests} "
          f"({st['launches']} launches, pad fraction "
          f"{st['pad_fraction']:.2f}, buckets {st['bucket_histogram']})")
    print(format_stats(st, unit="img"))
    rids = [r.rid for r in done]
    if sorted(rids) != list(range(args.requests)):
        raise RuntimeError("a request was dropped or answered twice")
    if not all(np.isfinite(r.out).all() for r in done):
        raise RuntimeError("non-finite output")
    if done:
        print(f"output image shape: {done[-1].out.shape} "
              f"({'32x32x3 reduced' if args.small else '64x64x3 from Table 1'}"
              f"; device {torch.device(args.device)})")
    return st


if __name__ == "__main__":
    main()
