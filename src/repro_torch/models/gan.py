"""DCGAN / cGAN generators (paper Table 1) on the port's plan/executor engine.

Counterpart of the generator half of ``repro.models.gan``.  Every deconv
site gets a ``ConvPlan`` once at model load (``generator_plans``, backed by
the plan cache), and its weights are stored superpacked — one tap-major
``(Σ T_h·T_w·C, N)`` buffer per layer, row for row the JAX package's — so
``params_from_jax`` carries JAX weights across as plain arrays.  The
discriminator and ``gan_losses`` come with the training slice.

``GANConfig.backend`` is the plan policy ('torch' | 'cuda' | 'auto').
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import resolve_device
from repro_torch.core.plan import ConvPlan, ConvSpec, dtype_name, plan_conv


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
    """Generator config: float32 weights and activations, one device."""

    name: str
    layers: tuple[DeconvLayer, ...]
    z_dim: int = 100
    backend: str = "torch"          # plan policy: 'torch' | 'cuda' | 'auto'


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
        dtype=dtype_name(dtype), backend=cfg.backend)) for l in cfg.layers)


def generator_init(seed_or_generator, cfg: GANConfig, device="cuda"):
    """Random generator params with the deconv weights already packed.

    ``seed_or_generator`` is an int seed or a CPU ``torch.Generator``; the
    draws are made on the CPU (so a seed gives the same weights on every
    device) and moved to ``device``.  Returns ``{'proj', 'dc{i}', 'b{i}'}``.
    """
    dev = resolve_device(device)
    gen = seed_or_generator
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator().manual_seed(int(seed_or_generator))
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


def params_from_jax(np_params: dict, cfg: GANConfig, device="cuda"):
    """Map JAX ``generator_init`` params (converted to numpy) onto the
    port's: ``proj``, ``dc{i}`` (the superpack, as is — the row order is
    shared) and ``b{i}``."""
    dev = resolve_device(device)
    plans = generator_plans(cfg)
    l0 = cfg.layers[0]
    want = {"proj": (cfg.z_dim, l0.in_hw * l0.in_hw * l0.in_c)}
    for i, (l, plan) in enumerate(zip(cfg.layers, plans)):
        want[f"dc{i}"] = (plan.total_taps * l.in_c, l.out_c)
        want[f"b{i}"] = (l.out_c,)
    out = {}
    for name, shape in want.items():
        arr = np.asarray(np_params[name], np.float32)
        if arr.shape != shape:
            raise ValueError(f"{name}: shape {arr.shape}, config wants "
                             f"{shape}")
        out[name] = torch.from_numpy(arr.copy()).to(dev)
    return out


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
