"""Serve semantic segmentation on the port through the SLO-aware control
plane: model load, the int8 gate, bucket warmup, an open-loop drive and
the latency report.

Counterpart of ``examples/serve_segnet.py``, on ``serve_dcgan``'s control
plane helpers: image requests arrive at ``--rate`` req/s (0 = one burst)
with a priority class (``--priority``) and an optional deadline
(``--slo-ms``); the control plane admits, coalesces them into the plan
batch buckets (1/4/16/64; on the card one CUDA graph per bucket) and sheds
the expired, and each launch is one SegNet forward plus the per-pixel
argmax.  ``--inject-fault-at N`` kills the N-th launch and checks the
replay (for a burst, answers bit-equal to a fault-free pass).
``--autotune cache|measure`` and ``--route-cache PATH`` are
``serve_dcgan``'s: measured routes and bucket costs from the per-host
route cache.

``--wdtype int8`` serves quantized superpacks and, before serving, holds
the logits to those of an f32 twin from the same init seed: rel L∞ ≤ L/127
for the L conv layers (each contributes at most about half an int8 grid
step of relative weight error, and the ReLU cascade compounds at worst
additively).

    PYTHONPATH=src python -m repro_torch.serve_segnet [--requests 32]
        [--rate 0] [--max-wait-ms 2] [--full] [--wdtype float32|int8]
        [--backend cuda|torch] [--device cuda|cpu]
        [--slo-ms 0] [--priority interactive|batch] [--inject-fault-at 0]
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
from repro_torch.serve_dcgan import (build_control_plane, check_replay,
                                     drive, report)


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
    ap.add_argument("--slo-ms", type=float, default=0.0,
                    help="per-request SLO in ms (0 = no deadline); blown "
                         "backlogs reject at admission, expired requests "
                         "shed before launch")
    ap.add_argument("--priority", choices=("interactive", "batch"),
                    default="interactive")
    ap.add_argument("--inject-fault-at", type=int, default=0,
                    help="kill the N-th launch mid-batch with a "
                         "NodeFailure (0 = off) and check the replay")
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

    proto = np.zeros((cfg.in_hw, cfg.in_hw, cfg.in_c), np.float32)
    cache_key = f"serve_segnet/{cfg.name}/{cfg.wdtype}"
    cp, be = build_control_plane(serve_fn, proto,
                                 max_wait_ms=args.max_wait_ms, cache=cache,
                                 cache_key=cache_key, device=args.device,
                                 fault_at=args.inject_fault_at,
                                 model="segnet")
    batcher = be.batcher
    t0 = time.perf_counter()
    timed = be.warmup()
    print(f"warmup: buckets {batcher.buckets} "
          f"{'captured as CUDA graphs' if batcher.graphed else 'run'} in "
          f"{time.perf_counter() - t0:.2f} s, {len(timed)} timed / "
          f"{len(batcher.buckets) - len(timed)} from the cache (ms "
          f"{[round(batcher.bucket_cost_s[b] * 1e3, 3) for b in batcher.buckets]})")

    rng = np.random.default_rng(0)
    payloads = [rng.uniform(-1, 1, (cfg.in_hw, cfg.in_hw, cfg.in_c))
                .astype(np.float32) for _ in range(args.requests)]
    drive(cp, payloads, rate=args.rate, priority=args.priority,
          slo_ms=args.slo_ms, model="segnet")
    st = report(cp, args, "segnet")
    for r in cp.done:
        if r.out.shape != (cfg.out_hw, cfg.out_hw) or r.out.min() < 0 \
                or r.out.max() >= cfg.num_classes:
            raise RuntimeError(f"request {r.rid}: bad segmentation map "
                               f"{r.out.shape}")
    if args.inject_fault_at > 0:
        print(check_replay(cp, be, payloads, args, serve_fn=serve_fn,
                           proto=proto, cache=cache, cache_key=cache_key,
                           model="segnet"))
    if cp.done:
        seg = cp.done[-1].out
        print(f"segmentation map: {seg.shape} {seg.dtype}, classes used "
              f"{np.unique(seg).size}/{cfg.num_classes} (device "
              f"{torch.device(args.device)})")
    st["int8_gate"] = gate
    st["warmup_timed"] = timed
    return st


if __name__ == "__main__":
    main()
