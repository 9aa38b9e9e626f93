"""DCGAN / cGAN (paper Table 1) on the port's plan/executor engine.

Counterpart of ``repro.models.gan``.  Generators stack the Table-1
transposed convs; discriminators mirror them with strided convs.  Every
conv site gets a ``ConvPlan`` once at model load (``generator_plans`` /
``discriminator_plans``, backed by the plan cache), and its weights are
stored superpacked — one tap-major buffer per layer, row for row the JAX
package's — so ``params_from_jax`` / ``dparams_from_jax`` carry JAX weights
across as plain arrays (int8 superpacks as their codes and scales).  Both halves train through the plans' §3.2.3
backwards (``ConvPlan.apply``'s autograd Functions); ``gan_losses`` is the
non-saturating loss pair.

``GANConfig.backend`` is the plan policy ('torch' | 'cuda' | 'auto');
``GANConfig.autotune`` an optional ``AutotunePolicy`` (measured routes,
resolved once at model load); ``GANConfig.wdtype='int8'`` stores every conv weight as a
``QuantizedSuperpack`` (quantized at pack), which the 'cuda' route runs on
the kernels' int8 entries.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import resolve_device
from repro_torch.core.autotune import AutotunePolicy
from repro_torch.core.plan import ConvPlan, ConvSpec, dtype_name, plan_conv
from repro_torch.models import params_from_numpy


@dataclasses.dataclass(frozen=True)
class DeconvLayer:
    in_hw: int
    in_c: int
    out_c: int
    kernel: int
    stride: int


# paper Table 1
DCGAN_LAYERS = (
    DeconvLayer(4, 1024, 512, 5, 2),
    DeconvLayer(8, 512, 256, 5, 2),
    DeconvLayer(16, 256, 128, 5, 2),
    DeconvLayer(32, 128, 3, 5, 2),
)
CGAN_LAYERS = (
    DeconvLayer(8, 256, 128, 4, 2),
    DeconvLayer(16, 128, 3, 4, 2),
)


def deconv_padding(kernel: int, stride: int):
    """'SAME'-style transposed padding: out = stride * in.

    out = (h-1)*s + pl + ph - k + 2 == s*h  =>  pl + ph = k + s - 2.
    """
    total = kernel + stride - 2
    pl = max(0, (kernel - stride + 1) // 2)
    ph = total - pl
    return ((pl, ph), (pl, ph))


@dataclasses.dataclass(frozen=True)
class GANConfig:
    """GAN config: float32 activations, one device."""

    name: str
    layers: tuple[DeconvLayer, ...]
    z_dim: int = 100
    backend: str = "torch"          # plan policy: 'torch' | 'cuda' | 'auto'
    # measured-route policy (None = heuristic routes); model load pays any
    # cache-miss microbenchmarks once, apply only sees tuned plans
    autotune: Optional[AutotunePolicy] = None
    # weight storage dtype for every conv site: 'float32' (dense) or 'int8'
    # (quantized superpacks, ``ConvSpec.wdtype``); activations stay f32
    wdtype: str = "float32"


DCGAN = GANConfig("dcgan", DCGAN_LAYERS)
CGAN = GANConfig("cgan", CGAN_LAYERS, z_dim=110)   # z + 10-class condition


def generator_plans(cfg: GANConfig,
                    dtype=torch.float32) -> tuple[ConvPlan, ...]:
    """Plans for every generator deconv site (cached; built once)."""
    return tuple(plan_conv(ConvSpec(
        kind="transposed", in_hw=(l.in_hw, l.in_hw), in_c=l.in_c,
        out_c=l.out_c, kernel_hw=(l.kernel, l.kernel),
        strides=(l.stride, l.stride),
        padding=deconv_padding(l.kernel, l.stride),
        dtype=dtype_name(dtype), backend=cfg.backend,
        wdtype=cfg.wdtype), autotune=cfg.autotune) for l in cfg.layers)


def discriminator_plans(cfg: GANConfig,
                        dtype=torch.float32) -> tuple[ConvPlan, ...]:
    """Plans for the mirrored strided-conv sites (image -> features)."""
    plans = []
    for l in reversed(cfg.layers):
        k = l.kernel
        plans.append(plan_conv(ConvSpec(
            kind="conv", in_hw=(l.in_hw * l.stride, l.in_hw * l.stride),
            in_c=l.out_c, out_c=l.in_c, kernel_hw=(k, k),
            strides=(l.stride, l.stride),
            padding=((k // 2, (k - 1) // 2), (k // 2, (k - 1) // 2)),
            dtype=dtype_name(dtype), backend=cfg.backend,
            wdtype=cfg.wdtype), autotune=cfg.autotune))
    return tuple(plans)


def _cpu_generator(seed_or_generator) -> torch.Generator:
    if isinstance(seed_or_generator, torch.Generator):
        return seed_or_generator
    return torch.Generator().manual_seed(int(seed_or_generator))


def generator_init(seed_or_generator, cfg: GANConfig, device="cuda"):
    """Random generator params with the deconv weights already packed.

    ``seed_or_generator`` is an int seed or a CPU ``torch.Generator``; the
    draws are made on the CPU (so a seed gives the same weights on every
    device) and moved to ``device``.  Returns ``{'proj', 'dc{i}', 'b{i}'}``.
    """
    dev = resolve_device(device)
    gen = _cpu_generator(seed_or_generator)
    plans = generator_plans(cfg)
    l0 = cfg.layers[0]
    p = {"proj": torch.randn((cfg.z_dim, l0.in_hw * l0.in_hw * l0.in_c),
                             generator=gen) * 0.02}
    for i, l in enumerate(cfg.layers):
        kernel = torch.randn((l.kernel, l.kernel, l.in_c, l.out_c),
                             generator=gen) * 0.02
        p[f"dc{i}"] = plans[i].pack(kernel)
        p[f"b{i}"] = torch.zeros((l.out_c,))
    return {k: v.to(dev) for k, v in p.items()}


def discriminator_init(seed_or_generator, cfg: GANConfig, device="cuda"):
    """Random discriminator params: ``c{i}`` the mirrored strided convs'
    (R·S·C, N) superpacks, ``head`` the (features, 1) logit projection.
    Draws are made on the CPU, as in ``generator_init``."""
    dev = resolve_device(device)
    gen = _cpu_generator(seed_or_generator)
    plans = discriminator_plans(cfg)
    layers = tuple(reversed(cfg.layers))
    p = {}
    for i, l in enumerate(layers):
        kernel = torch.randn((l.kernel, l.kernel, l.out_c, l.in_c),
                             generator=gen) * 0.02
        p[f"c{i}"] = plans[i].pack(kernel)
    p["head"] = torch.randn((_head_features(cfg), 1), generator=gen) * 0.02
    return {k: v.to(dev) for k, v in p.items()}


def _head_features(cfg: GANConfig) -> int:
    first = cfg.layers[0]
    return first.in_hw * first.in_hw * first.in_c


def params_from_jax(np_params: dict, cfg: GANConfig, device="cuda"):
    """Map JAX ``generator_init`` params (converted to numpy) onto the
    port's: ``proj``, ``dc{i}`` (the superpack, as is — the row order is
    shared; an int8 one as its codes and scales) and ``b{i}``."""
    dev = resolve_device(device)
    plans = generator_plans(cfg)
    l0 = cfg.layers[0]
    want = {"proj": (cfg.z_dim, l0.in_hw * l0.in_hw * l0.in_c)}
    for i, (l, plan) in enumerate(zip(cfg.layers, plans)):
        want[f"dc{i}"] = (plan.total_taps * l.in_c, l.out_c)
        want[f"b{i}"] = (l.out_c,)
    return params_from_numpy(np_params, want, dev)


def dparams_from_jax(np_params: dict, cfg: GANConfig, device="cuda"):
    """Map JAX ``discriminator_init`` params (converted to numpy) onto the
    port's: ``c{i}`` (the (R·S·C, N) superpack, as is; an int8 one as its
    codes and scales) and ``head``."""
    dev = resolve_device(device)
    want = {f"c{i}": (plan.total_taps * plan.spec.in_c, plan.spec.out_c)
            for i, plan in enumerate(discriminator_plans(cfg))}
    want["head"] = (_head_features(cfg), 1)
    return params_from_numpy(np_params, want, dev)


def generator_apply(p, z: torch.Tensor, cfg: GANConfig) -> torch.Tensor:
    """Latents (B, z_dim) -> images (B, H, W, 3) in [-1, 1], NHWC."""
    plans = generator_plans(cfg, z.dtype)      # cache hits after model load
    l0 = cfg.layers[0]
    x = torch.relu(torch.matmul(z, p["proj"]))
    x = x.reshape(z.shape[0], l0.in_hw, l0.in_hw, l0.in_c)
    for i, plan in enumerate(plans):
        x = plan.apply(x, p[f"dc{i}"]) + p[f"b{i}"]
        x = torch.tanh(x) if i == len(plans) - 1 else torch.relu(x)
    return x


def generator_unpack(p, cfg: GANConfig):
    """Packed generator params -> full (R,S,C,N) HWIO kernels (offline)."""
    plans = generator_plans(cfg)
    out = dict(p)
    for i, plan in enumerate(plans):
        out[f"dc{i}"] = plan.unpack(p[f"dc{i}"])
    return out


def discriminator_apply(p, x: torch.Tensor, cfg: GANConfig) -> torch.Tensor:
    """Images (B, H, W, 3) NHWC -> logits (B, 1)."""
    plans = discriminator_plans(cfg, x.dtype)
    for i, plan in enumerate(plans):
        x = F.leaky_relu(plan.apply(x, p[f"c{i}"]), 0.2)
    return torch.matmul(x.reshape(x.shape[0], -1), p["head"])


def discriminator_unpack(p, cfg: GANConfig):
    """Packed discriminator params -> full (R,S,C,N) HWIO kernels."""
    plans = discriminator_plans(cfg)
    out = dict(p)
    for i, plan in enumerate(plans):
        out[f"c{i}"] = plan.unpack(p[f"c{i}"])
    return out


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``log(1 + e^x)`` as ``logaddexp(x, 0)``, exact
    at every x (``F.softplus`` switches to the identity above 20)."""
    return torch.logaddexp(x, x.new_zeros(()))


def gan_losses(gp, dp, z: torch.Tensor, real: torch.Tensor,
               cfg: GANConfig):
    """Non-saturating GAN loss pair ``(g_loss, d_loss)``: one generator
    forward, two discriminator forwards (fake, then real)."""
    fake = generator_apply(gp, z, cfg)
    d_fake = discriminator_apply(dp, fake, cfg)
    d_real = discriminator_apply(dp, real, cfg)
    d_loss = (softplus(-d_real) + softplus(d_fake)).mean()
    g_loss = softplus(-d_fake).mean()
    return g_loss, d_loss
