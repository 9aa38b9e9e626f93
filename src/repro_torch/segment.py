"""Semantic segmentation on the port: the paper's dilated-conv scenario
end to end.

Counterpart of ``examples/segment.py``.  Builds the DilatedNet-style SegNet
(``models/segnet.py``) with every conv site planned once at load and every
weight in the tap-major (R·S·C, N) superpack, runs an inference pass and
``--steps`` SGD steps on the pixel cross-entropy (through the §3.2.3
backwards on the superpack), printing plan-build cost and time per batch;
the loss must fall.

    PYTHONPATH=src python -m repro_torch.segment [--steps N] [--full]
        [--backend cuda|torch] [--device cuda|cpu]

``--full`` uses the 64 px, width-128 ``SEGNET``; the default is the tiny
config.  On the 'cuda' backend every site is one launch of kernel B.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import time

import torch

from repro_torch.core import resolve_device
from repro_torch.models import segnet


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1)
    ap.add_argument("--full", action="store_true",
                    help="64px width-128 config instead of the tiny one")
    ap.add_argument("--backend", choices=("torch", "cuda"), default="cuda")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = dataclasses.replace(
        segnet.SEGNET if args.full else segnet.SEGNET_TINY,
        backend=args.backend)

    t0 = time.perf_counter()
    params = segnet.segnet_init(0, cfg, device=dev)
    plans = segnet.segnet_plans(cfg)
    load_ms = (time.perf_counter() - t0) * 1e3
    print(f"[load] {cfg.name}: {len(plans)} planned conv sites "
          f"({sum(1 for p in plans if p.spec.kind == 'dilated')} dilated), "
          f"plan build {sum(p.build_ms for p in plans):.1f} ms, init total "
          f"{load_ms:.1f} ms")
    print(f"[load] paths: {[p.path for p in plans]}")

    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, cfg.in_hw, cfg.in_hw, cfg.in_c), generator=gen) \
        .to(dev)
    labels = torch.randint(0, cfg.num_classes, (2, cfg.out_hw, cfg.out_hw),
                           generator=gen).to(dev)

    with torch.inference_mode():
        logits = segnet.segnet_apply(params, x, cfg)
        if logits.shape != (2, cfg.out_hw, cfg.out_hw, cfg.num_classes) \
                or not bool(torch.isfinite(logits).all()):
            raise RuntimeError(f"bad logits {tuple(logits.shape)}")
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(5):
            segnet.segnet_apply(params, x, cfg)
        _sync(dev)
    up = segnet.upsample_logits(logits)
    print(f"[infer] logits {tuple(logits.shape)} (upsampled "
          f"{tuple(up.shape)}), {(time.perf_counter() - t0) / 5 * 1e3:.2f} "
          f"ms/batch (device {dev})")

    def loss_and_grads(p):
        leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
        loss = segnet.segnet_loss(leaves, x, labels, cfg)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return float(loss.detach()), dict(zip(leaves, grads))

    loss0 = None
    for i in range(args.steps):
        loss, grads = loss_and_grads(params)
        params = {k: (v - 0.1 * grads[k]).detach() for k, v in params.items()}
        loss0 = loss if loss0 is None else loss0
        print(f"[train] step {i}: loss {loss:.4f}")
    final = loss_and_grads(params)[0]
    if not math.isfinite(final):
        raise RuntimeError(f"non-finite loss {final}")
    if args.steps >= 1:
        if not final < loss0:
            raise RuntimeError(f"the loss did not fall: {loss0} -> {final}")
        print(f"[train] loss {loss0:.4f} -> {final:.4f} (planned backwards "
              f"on the superpack)")
    return {"loss0": loss0, "final": final}


if __name__ == "__main__":
    main()
