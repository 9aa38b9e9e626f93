"""Serve semantic segmentation on the port: model load, the int8 gate,
bucket warmup, an open-loop drive through ``DynamicImageBatcher`` and the
latency report.

Counterpart of ``examples/serve_segnet.py`` without the control plane (its
SLO admission, priority classes and fault replay come with the serving
slice).  ``--autotune cache|measure`` and ``--route-cache PATH`` are
``serve_dcgan``'s: measured routes and bucket costs from the per-host
route cache.  Image requests
arrive at ``--rate`` req/s (0 = one burst); the batcher coalesces them into
the plan batch buckets (1/4/16/64), and each launch is one SegNet forward
plus the per-pixel argmax.

``--wdtype int8`` serves quantized superpacks and, before serving, holds
the logits to those of an f32 twin from the same init seed: rel L∞ ≤ L/127
for the L conv layers (each contributes at most about half an int8 grid
step of relative weight error, and the ReLU cascade compounds at worst
additively).

    PYTHONPATH=src python -m repro_torch.serve_segnet [--requests 32]
        [--rate 0] [--max-wait-ms 2] [--full] [--wdtype float32|int8]
        [--backend cuda|torch] [--device cuda|cpu]
        [--autotune off|cache|measure] [--route-cache PATH]

``--full`` serves the 64 px, width-128 edge config ``SEGNET``; the default
is the tiny config.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import autotune as at
from repro_torch.core import resolve_device
from repro_torch.core.plan import QuantizedSuperpack
from repro_torch.models import segnet
from repro_torch.serving.image_batcher import DynamicImageBatcher
from repro_torch.serving.metrics import format_stats


def load_model(*, full: bool, backend: str, wdtype: str, device,
               seed: int = 0, autotune=None):
    """Build every conv plan (under the ``autotune`` policy, if any) and
    pack the weights once: (cfg, params)."""
    base = segnet.SEGNET if full else segnet.SEGNET_TINY
    cfg = dataclasses.replace(base, backend=backend, wdtype=wdtype,
                              autotune=autotune)
    segnet.segnet_plans(cfg)
    return cfg, segnet.segnet_init(seed, cfg, device=device)


def weight_bytes(params: dict) -> int:
    """Stored bytes of the conv weights (codes + scale rows for int8)."""
    return sum(w.nbytes() if isinstance(w, QuantizedSuperpack)
               else w.numel() * w.element_size()
               for k, w in params.items() if k.startswith("w"))


def int8_gate(cfg: segnet.SegNetConfig, params: dict, device,
              seed: int = 0) -> dict:
    """The quantized-serving gate: an f32 twin from the same init seed, the
    logits of both on one random batch of 4, and the bound L/127.  Returns
    ``{'rel_err', 'bound', 'int8_bytes', 'f32_bytes'}``; raises when the
    error is over the bound."""
    twin = dataclasses.replace(cfg, name=cfg.name + "-f32twin",
                               wdtype="float32")
    params_f = segnet.segnet_init(seed, twin, device=device)
    xq = torch.from_numpy(np.random.default_rng(7).uniform(
        -1.0, 1.0, (4, cfg.in_hw, cfg.in_hw, cfg.in_c)).astype(np.float32))
    xq = xq.to(resolve_device(device))
    with torch.inference_mode():
        lq = segnet.segnet_apply(params, xq, cfg)
        lf = segnet.segnet_apply(params_f, xq, twin)
    gate = {"rel_err": float((lq - lf).abs().max() / lf.abs().max()),
            "bound": len(cfg.layers) / 127.0,
            "int8_bytes": weight_bytes(params),
            "f32_bytes": weight_bytes(params_f)}
    if not gate["rel_err"] <= gate["bound"]:
        raise RuntimeError(f"int8 logits off their f32 twin: {gate}")
    return gate


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--rate", type=float, default=0.0,
                    help="arrival rate in req/s (0 = submit all at once)")
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--full", action="store_true",
                    help="64px width-128 config instead of the tiny one")
    ap.add_argument("--wdtype", choices=("float32", "int8"),
                    default="float32",
                    help="weight storage dtype: 'int8' serves quantized "
                         "superpacks and gates the logits against an f32 "
                         "twin first")
    ap.add_argument("--backend", choices=("torch", "cuda"), default="cuda")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--autotune", choices=("off", "cache", "measure"),
                    default="off",
                    help="measured routes: 'cache' = cached winners only, "
                         "'measure' = microbenchmark on a cache miss")
    ap.add_argument("--route-cache", default=None,
                    help="route/bucket-cost cache path (default "
                         "$HUGE2_ROUTE_CACHE or ~/.cache/huge2)")
    args = ap.parse_args(argv)

    policy = cache = None
    if args.autotune != "off":
        policy = at.AutotunePolicy(mode=args.autotune,
                                   cache_path=args.route_cache)
        cache = at.open_cache(args.route_cache)
    t_load = time.perf_counter()
    cfg, params = load_model(full=args.full, backend=args.backend,
                             wdtype=args.wdtype, device=args.device,
                             autotune=policy)
    plans = segnet.segnet_plans(cfg)
    t_load = time.perf_counter() - t_load
    print(f"model load: {cfg.name} (wdtype={cfg.wdtype}), {len(plans)} "
          f"planned conv sites "
          f"({sum(1 for p in plans if p.spec.kind == 'dilated')} dilated) "
          f"in {t_load * 1e3:.1f} ms (routes {[p.path for p in plans]})")
    gate = None
    if args.wdtype == "int8":
        gate = int8_gate(cfg, params, args.device)
        print(f"int8 weights: {gate['int8_bytes'] / gate['f32_bytes']:.2f}x "
              f"f32 bytes ({gate['int8_bytes']} vs {gate['f32_bytes']}); "
              f"logit rel err {gate['rel_err']:.4f} (bound "
              f"{gate['bound']:.4f} = {len(plans)} layers / 127)")

    def serve_fn(x):
        # logits -> per-pixel class ids
        return torch.argmax(segnet.segnet_apply(params, x, cfg), dim=-1)

    batcher = DynamicImageBatcher(
        serve_fn, max_wait_ms=args.max_wait_ms, device=args.device,
        cache=cache, cache_key=f"serve_segnet/{cfg.name}/{cfg.wdtype}")
    proto = np.zeros((cfg.in_hw, cfg.in_hw, cfg.in_c), np.float32)
    t0 = time.perf_counter()
    timed = batcher.warmup(proto)
    print(f"warmup: buckets {batcher.buckets} run in "
          f"{time.perf_counter() - t0:.2f} s, {len(timed)} timed / "
          f"{len(batcher.buckets) - len(timed)} from the cache (ms "
          f"{[round(batcher.bucket_cost_s[b] * 1e3, 3) for b in batcher.buckets]})")

    rng = np.random.default_rng(0)
    payloads = [rng.uniform(-1, 1, (cfg.in_hw, cfg.in_hw, cfg.in_c))
                .astype(np.float32) for _ in range(args.requests)]
    done = batcher.drive_open_loop(lambda i: payloads[i], args.requests,
                                   rate=args.rate)
    st = batcher.stats()
    print(f"served {st['completed']} of {args.requests} "
          f"({st['launches']} launches, pad fraction "
          f"{st['pad_fraction']:.2f}, buckets {st['bucket_histogram']})")
    print(format_stats(st, unit="img"))
    if sorted(r.rid for r in done) != list(range(args.requests)):
        raise RuntimeError("a request was dropped or answered twice")
    for r in done:
        if r.out.shape != (cfg.out_hw, cfg.out_hw) or r.out.min() < 0 \
                or r.out.max() >= cfg.num_classes:
            raise RuntimeError(f"request {r.rid}: bad segmentation map "
                               f"{r.out.shape}")
    if done:
        seg = done[-1].out
        print(f"segmentation map: {seg.shape} {seg.dtype}, classes used "
              f"{np.unique(seg).size}/{cfg.num_classes} (device "
              f"{torch.device(args.device)})")
    st["int8_gate"] = gate
    st["warmup_timed"] = timed
    return st


if __name__ == "__main__":
    main()
