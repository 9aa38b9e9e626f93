"""Train the convolutional VAE on the port: encoder strided convs and
decoder transposed convs run the planned forward on their superpacks, and
the ELBO's gradients go through the §3.2.3 backwards of both halves.

Counterpart of ``examples/vae_train.py``.  Each step draws a batch of
smooth synthetic images and the reparameterization noise from a CPU
generator, takes one SGD step, and at the end the −ELBO of a fixed batch
with fixed noise must have fallen.

    PYTHONPATH=src python -m repro_torch.vae_train [--steps 100] [--full]
        [--batch 16] [--lr 1e-3] [--backend cuda|torch] [--device cuda|cpu]

``--full`` trains the 32 px width-(64, 128) ``VAE``; the default is the
tiny 16 px config.  On the 'cuda' backend the encoder sites are kernel B
and the decoder sites kernel A.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import time

import numpy as np
import torch

from repro_torch.core import resolve_device
from repro_torch.models import vae


def batch_at(cfg, batch: int, step: int, seed: int = 0) -> np.ndarray:
    """Synthetic smooth images in [-1, 1] (low-frequency mixtures, so the
    ELBO has structure to learn), deterministic by (seed, step)."""
    rng = np.random.default_rng((seed, step))
    hw = cfg.image_hw
    yy, xx = np.mgrid[0:hw, 0:hw] / hw
    freq = rng.uniform(1.0, 4.0, (batch, cfg.in_c, 2, 1, 1))
    phase = rng.uniform(0, 2 * np.pi, (batch, cfg.in_c, 2, 1, 1))
    img = np.sin(2 * np.pi * freq[:, :, 0] * yy + phase[:, :, 0]) \
        * np.sin(2 * np.pi * freq[:, :, 1] * xx + phase[:, :, 1])
    return np.moveaxis(img, 1, -1).astype(np.float32)


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def sgd_step(params: dict, x: torch.Tensor, gen: torch.Generator, cfg,
             lr: float):
    """One −ELBO value and gradient through the planned backwards, then
    ``p - lr·g`` on every leaf: (new params, loss)."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss = vae.elbo_loss(leaves, x, gen, cfg)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    new = {k: (v - lr * g).detach()
           for (k, v), g in zip(leaves.items(), grads)}
    return new, float(loss.detach())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--full", action="store_true",
                    help="32px width-(64,128) config instead of the tiny one")
    ap.add_argument("--backend", choices=("torch", "cuda"), default="cuda")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = dataclasses.replace(vae.VAE if args.full else vae.VAE_TINY,
                              backend=args.backend)

    t0 = time.perf_counter()
    params = vae.vae_init(0, cfg, device=dev)
    plans = vae.vae_plans(cfg)
    print(f"[load] {cfg.name}: {len(plans)} planned conv sites "
          f"({sum(1 for p in plans if p.spec.kind == 'transposed')} "
          f"transposed in the decoder), plan build "
          f"{sum(p.build_ms for p in plans):.2f} ms, init total "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    print(f"[load] paths: {[p.path for p in plans]}")

    # fixed evaluation: the same batch and noise before and after training,
    # so the check measures the params only
    x0 = torch.from_numpy(batch_at(cfg, args.batch, 0)).to(dev)
    eps0 = torch.randn((args.batch, cfg.latent_dim),
                       generator=torch.Generator().manual_seed(1)).to(dev)

    def eval_loss(p):
        with torch.no_grad():
            return float(vae.elbo_loss(p, x0, None, cfg, eps=eps0))

    before = eval_loss(params)
    gen = torch.Generator().manual_seed(0)
    losses = []
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(args.steps):
        x = torch.from_numpy(batch_at(cfg, args.batch, i)).to(dev)
        params, loss = sgd_step(params, x, gen, cfg, args.lr)
        losses.append(loss)
        if i % 20 == 0:
            print(f"[train] step {i:4d}: -ELBO {loss:.2f}")
    _sync(dev)
    dt = time.perf_counter() - t0
    print(f"[train] {args.steps} steps in {dt:.1f}s "
          f"({dt / max(1, args.steps) * 1e3:.0f} ms/step, device {dev})")
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"non-finite -ELBO: {losses}")
    final = eval_loss(params)
    if not final < before:
        raise RuntimeError(f"the fixed-batch -ELBO did not fall: {before} "
                           f"-> {final}")
    print(f"[train] -ELBO {before:.2f} -> {final:.2f} (fixed eval batch; "
          f"planned backwards through encoder AND decoder)")
    with torch.no_grad():
        imgs = vae.sample(params, torch.Generator().manual_seed(2), cfg,
                          n=4)
    if not bool(torch.isfinite(imgs).all()):
        raise RuntimeError("non-finite prior samples")
    print(f"[sample] prior draws decoded: {tuple(imgs.shape)}")
    return {"before": before, "final": final, "losses": losses,
            "ms_per_step": dt / max(1, args.steps) * 1e3}


if __name__ == "__main__":
    main()
