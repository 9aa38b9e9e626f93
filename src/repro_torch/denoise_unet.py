"""The diffusion U-Net on the port: every conv kind in one model.

Counterpart of ``examples/denoise_unet.py``.  Builds the U-Net
(``models/unet.py``) with every site planned once at load and every weight
in a tap-major superpack, prints each site's route, runs one
denoising-score-matching training step (loss and gradients through the
planned backwards, the skip-concat cotangent split included) and an Euler
denoising loop, printing the time per step.

    PYTHONPATH=src python -m repro_torch.denoise_unet [--steps N] [--full]
        [--backend cuda|torch] [--device cuda|cpu]

``--full`` uses the 32 px config ``UNET``; the default is the tiny one.  On
the 'cuda' backend every site is one kernel launch (kernel B at the
correlation sites, kernel A at the ups; C and D where the plane is tiled);
on the 'torch' backend the ups take the sub-pixel route.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import time

import torch

from repro_torch.core import resolve_device
from repro_torch.models import unet


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=8,
                    help="Euler denoising steps (CI smoke uses 2)")
    ap.add_argument("--full", action="store_true",
                    help="32px base-32 config instead of the tiny one")
    ap.add_argument("--backend", choices=("torch", "cuda"), default="cuda")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = dataclasses.replace(unet.UNET if args.full else unet.UNET_TINY,
                              backend=args.backend)

    t0 = time.perf_counter()
    params = unet.unet_init(0, cfg, device=dev)
    t_build = time.perf_counter() - t0

    # one model, every conv kind: the plan inspection the "untangled"
    # claim rests on
    routes = unet.unet_route_summary(cfg)
    kinds = {k for k, _ in routes.values()}
    paths = {p for _, p in routes.values()}
    if kinds != {"conv", "dilated", "transposed"}:
        raise RuntimeError(f"conv kinds planned: {kinds}")
    want = {"cuda"} if args.backend == "cuda" else None
    if want is not None and paths != want:
        raise RuntimeError(f"sites off the cuda route: {routes}")
    if want is None and "pixel_shuffle" not in paths:
        raise RuntimeError(f"no site on the sub-pixel route: {routes}")
    plans = unet.unet_plans(cfg)
    for site, (kind, path) in routes.items():
        sp = plans[site].route_for_batch(1).sp_tiles
        print(f"  {site:6s} {kind:10s} -> {path}"
              + (f" (tiled, block tile {sp})" if sp else ""))
    print(f"{len(routes)} sites planned in {t_build:.2f}s; routes "
          f"{sorted(paths)}")

    # one DSM training step through the planned backwards
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((2, cfg.image_hw, cfg.image_hw, cfg.in_c),
                    generator=gen).to(dev)
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    loss = unet.unet_loss(leaves, x, gen, cfg)
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    loss = float(loss.detach())
    n_zero = sum(int(not bool(g.ne(0).any())) for g in grads.values())
    if not (math.isfinite(loss) and n_zero == 0):
        raise RuntimeError(f"DSM loss {loss}, {n_zero} zero gradient "
                           f"leaves")
    print(f"DSM loss {loss:.4f}; all {len(grads)} grad leaves nonzero")

    # Euler denoising loop: args.steps sequential U-Net calls
    xt = torch.randn(tuple(x.shape), generator=gen).to(dev)
    with torch.inference_mode():
        unet.denoise_loop(params, xt, cfg, 1)          # warm-up
        _sync(dev)
        t0 = time.perf_counter()
        out = unet.denoise_loop(params, xt, cfg, args.steps)
        _sync(dev)
        dt = time.perf_counter() - t0
    if out.shape != x.shape or not bool(torch.isfinite(out).all()):
        raise RuntimeError(f"denoised output {tuple(out.shape)} is not "
                           f"finite or of the input's shape")
    ms_per_step = dt / max(1, args.steps) * 1e3
    print(f"denoised {tuple(out.shape)} in {args.steps} steps "
          f"({ms_per_step:.1f} ms/step, device {dev})")
    return {"loss": loss, "routes": routes, "ms_per_step": ms_per_step,
            "out": out}


if __name__ == "__main__":
    main()
