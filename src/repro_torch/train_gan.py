"""Train a DCGAN through the port's engine: every forward convolution runs
a planned route (kernels A and B on ``--backend cuda``), every backward the
paper's §3.2.3 formulation on the superpacks.

Counterpart of ``examples/train_gan.py``: plain SGD on the non-saturating
loss pair, the d-grads and the g-grads each from their own forward pass,
both from the old params.  The default is the full Table-1 DCGAN at 64×64;
``--small`` is the example's reduced 32×32 one.

    PYTHONPATH=src python -m repro_torch.train_gan [--steps 10] [--batch 16]
        [--lr 2e-4] [--backend cuda|torch] [--device cuda|cpu] [--small]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import resolve_device
from repro_torch.models import gan
from repro_torch.train.data import GANPipeline

# a reduced DCGAN (same family, CIFAR-scale 32x32 output), as in the example
SMALL_LAYERS = (
    gan.DeconvLayer(4, 128, 64, 5, 2),
    gan.DeconvLayer(8, 64, 32, 5, 2),
    gan.DeconvLayer(16, 32, 3, 5, 2),
)


def _grads(loss_of, params: dict) -> tuple[torch.Tensor, dict]:
    """Gradient of ``loss_of(params)`` w.r.t. every entry of ``params``:
    ``(loss, grads)``, as ``jax.value_and_grad`` gives them."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss = loss_of(leaves)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def step_grads(gp: dict, dp: dict, z: torch.Tensor, real: torch.Tensor,
               cfg: gan.GANConfig):
    """``(g_loss, d_loss, g_grad, d_grad)`` of one step, as in JAX: the
    d-grads are those of ``gan_losses(...)[1]`` w.r.t. ``dp`` and the
    g-grads those of ``gan_losses(...)[0]`` w.r.t. ``gp`` — two separate
    forward passes (each one generator and two discriminator forwards),
    both from the given params."""
    gp0 = {k: v.detach() for k, v in gp.items()}
    dp0 = {k: v.detach() for k, v in dp.items()}
    d_loss, d_grad = _grads(
        lambda d: gan.gan_losses(gp0, d, z, real, cfg)[1], dp0)
    g_loss, g_grad = _grads(
        lambda g: gan.gan_losses(g, dp0, z, real, cfg)[0], gp0)
    return g_loss, d_loss, g_grad, d_grad


def train_step(gp: dict, dp: dict, z: torch.Tensor, real: torch.Tensor,
               cfg: gan.GANConfig, lr: float):
    """One plain-SGD step of both players from ``step_grads``:
    ``(gp', dp', g_loss, d_loss)``."""
    g_loss, d_loss, g_grad, d_grad = step_grads(gp, dp, z, real, cfg)
    with torch.no_grad():
        gp2 = {k: v - lr * g_grad[k] for k, v in gp.items()}
        dp2 = {k: v - lr * d_grad[k] for k, v in dp.items()}
    return gp2, dp2, g_loss, d_loss


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--backend", choices=("torch", "cuda"), default="cuda")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="reduced 32px DCGAN (examples/train_gan.py's)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = gan.GANConfig("dcgan-small" if args.small else "dcgan",
                        SMALL_LAYERS if args.small else gan.DCGAN_LAYERS,
                        backend=args.backend)
    gp = gan.generator_init(0, cfg, device=dev)
    dp = gan.discriminator_init(1, cfg, device=dev)
    plans = gan.generator_plans(cfg) + gan.discriminator_plans(cfg)
    print(f"planned {len(cfg.layers)} deconv + {len(cfg.layers)} conv sites "
          f"({sum(p.build_ms for p in plans):.2f} ms plan build; routes at "
          f"B={args.batch}: "
          f"{[p.route_for_batch(args.batch).path for p in plans]})")
    pipe = GANPipeline(cfg, args.batch,
                       image_hw=cfg.layers[-1].in_hw * cfg.layers[-1].stride)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    g_hist, d_hist, step_ms = [], [], []
    for s in range(args.steps):
        b = pipe.batch_at(s)
        z = torch.from_numpy(b["z"]).to(dev)
        real = torch.from_numpy(b["real"]).to(dev)
        sync()
        t0 = time.perf_counter()
        gp, dp, gl, dl = train_step(gp, dp, z, real, cfg, args.lr)
        g_hist.append(float(gl))      # reads the losses: synchronizes
        d_hist.append(float(dl))
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        print(f"step {s:4d}  g_loss {g_hist[-1]:.4f}  d_loss "
              f"{d_hist[-1]:.4f}  {step_ms[-1]:.1f} ms")
    if not (np.isfinite(g_hist).all() and np.isfinite(d_hist).all()):
        raise RuntimeError("non-finite loss")
    steady = step_ms[1:] or step_ms
    print(f"{args.steps} steps, {float(np.median(steady)):.2f} ms/step "
          f"(median after the first; B={args.batch}, backend "
          f"{args.backend}, device {dev})")
    return {"g_loss": g_hist, "d_loss": d_hist, "step_ms": step_ms,
            "gp": gp, "dp": dp}


if __name__ == "__main__":
    main()
