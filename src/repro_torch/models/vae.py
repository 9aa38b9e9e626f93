"""Convolutional VAE (paper Fig. 1) on the port's plan/executor engine.

Counterpart of ``repro.models.vae``: an encoder of strided 'conv' sites
(k4 s2, the DCGAN discriminator's mirror) down to a small feature plane and
dense heads for ``mu`` / ``logvar``; a decoder of a dense projection back
to that plane and transposed-conv sites up to the image, the part HUGE²
untangles.  Every site gets a ``ConvPlan`` once at model load
(``vae_plans``) and its weights are stored superpacked, row for row the JAX
package's, so ``params_from_jax`` carries JAX weights across as plain
arrays (int8 superpacks as their codes and scales).  Training maximizes
the ELBO (MSE reconstruction + KL to the unit prior) through the plans'
§3.2.3 backwards in both halves.

On the 'cuda' route each site is one kernel launch: kernel B at the two
encoder sites, kernel A at the two decoder sites (A's thin-N tile at the
RGB head); ``wdtype='int8'`` takes their int8 entries (kernel E).  The
flatten before the heads is NHWC, as in JAX, so the dense heads carry
across unpermuted.

Random draws: ``jax.random`` and torch's generators give different numbers
from one seed, so ``reparameterize``, ``vae_apply`` and ``elbo_loss`` take
a CPU ``torch.Generator`` *or* an explicit ``eps``, and ``sample`` a
generator or an explicit ``z`` (the tests hand both packages the same
draws).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import resolve_device
from repro_torch.core.autotune import AutotunePolicy
from repro_torch.core.plan import ConvPlan, ConvSpec, dtype_name, plan_conv
from repro_torch.models import params_from_numpy
from repro_torch.models.gan import DeconvLayer, _cpu_generator, deconv_padding


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    name: str
    image_hw: int = 32
    in_c: int = 3
    widths: tuple[int, ...] = (64, 128)   # one stride-2 stage per width
    latent_dim: int = 64
    kernel: int = 4
    backend: str = "torch"          # plan policy: 'torch' | 'cuda' | 'auto'
    # measured-route policy (None = heuristic routes)
    autotune: Optional[AutotunePolicy] = None
    # device tiling: only (1, 1) is ported (plan_conv refuses the rest)
    spatial: tuple[int, int] = (1, 1)
    # weight storage dtype for every conv site: 'float32' (dense) or 'int8'
    # (quantized superpacks, ``ConvSpec.wdtype``); activations stay f32
    wdtype: str = "float32"

    @property
    def feat_hw(self) -> int:
        return self.image_hw // (2 ** len(self.widths))

    @property
    def feat_c(self) -> int:
        return self.widths[-1]

    @property
    def encoder_layers(self) -> tuple[DeconvLayer, ...]:
        """Strided 'conv' stages, image -> feature plane (``in_hw`` is the
        stage's input resolution)."""
        chans = (self.in_c,) + self.widths
        return tuple(
            DeconvLayer(self.image_hw // 2 ** i, chans[i], chans[i + 1],
                        self.kernel, 2)
            for i in range(len(self.widths)))

    @property
    def decoder_layers(self) -> tuple[DeconvLayer, ...]:
        """Transposed stages, feature plane -> image: the encoder's
        mirror."""
        chans = (self.in_c,) + self.widths
        return tuple(
            DeconvLayer(self.image_hw // 2 ** (i + 1), chans[i + 1],
                        chans[i], self.kernel, 2)
            for i in reversed(range(len(self.widths))))


VAE = VAEConfig("vae")                                       # 32px CIFAR-ish
VAE_TINY = VAEConfig("vae-tiny", image_hw=16, widths=(16, 32), latent_dim=8)


# ---------------------------------------------------------------------------
# load-time planning: one ConvPlan per site, both halves
# ---------------------------------------------------------------------------

def encoder_plans(cfg: VAEConfig,
                  dtype=torch.float32) -> tuple[ConvPlan, ...]:
    plans = []
    for l in cfg.encoder_layers:
        k = l.kernel
        plans.append(plan_conv(ConvSpec(
            kind="conv", in_hw=(l.in_hw, l.in_hw), in_c=l.in_c,
            out_c=l.out_c, kernel_hw=(k, k), strides=(l.stride, l.stride),
            padding=((k // 2, (k - 1) // 2), (k // 2, (k - 1) // 2)),
            dtype=dtype_name(dtype), backend=cfg.backend,
            spatial=cfg.spatial, wdtype=cfg.wdtype),
            autotune=cfg.autotune))
    return tuple(plans)


def decoder_plans(cfg: VAEConfig,
                  dtype=torch.float32) -> tuple[ConvPlan, ...]:
    plans = []
    for l in cfg.decoder_layers:
        plans.append(plan_conv(ConvSpec(
            kind="transposed", in_hw=(l.in_hw, l.in_hw), in_c=l.in_c,
            out_c=l.out_c, kernel_hw=(l.kernel, l.kernel),
            strides=(l.stride, l.stride),
            padding=deconv_padding(l.kernel, l.stride),
            dtype=dtype_name(dtype), backend=cfg.backend,
            spatial=cfg.spatial, wdtype=cfg.wdtype),
            autotune=cfg.autotune))
    return tuple(plans)


def vae_plans(cfg: VAEConfig, dtype=torch.float32) -> tuple[ConvPlan, ...]:
    return encoder_plans(cfg, dtype) + decoder_plans(cfg, dtype)


# ---------------------------------------------------------------------------
# params: every conv weight superpacked, dense heads for the latent
# ---------------------------------------------------------------------------

def _dense_shapes(cfg: VAEConfig) -> dict:
    fdim = cfg.feat_hw * cfg.feat_hw * cfg.feat_c
    return {"mu_w": (fdim, cfg.latent_dim), "mu_b": (cfg.latent_dim,),
            "lv_w": (fdim, cfg.latent_dim), "lv_b": (cfg.latent_dim,),
            "proj": (cfg.latent_dim, fdim), "projb": (fdim,)}


def vae_init(seed_or_generator, cfg: VAEConfig, device="cuda"):
    """Random params with every conv weight superpacked: ``enc{i}`` /
    ``dec{i}`` the superpacks (``QuantizedSuperpack`` under
    ``wdtype='int8'``), ``encb{i}`` / ``decb{i}`` zeros, the dense heads
    ``mu_w``/``lv_w`` (features, latent) and ``proj`` (latent, features)
    with zero biases.  Draws in JAX's order, on the CPU from an int seed or
    a CPU ``torch.Generator``, then moved to ``device``.  The logical
    sharding specs JAX returns beside the params wait for the
    data-parallel slice."""
    dev = resolve_device(device)
    gen = _cpu_generator(seed_or_generator)
    enc, dec = encoder_plans(cfg), decoder_plans(cfg)
    p = {}
    for i, (l, plan) in enumerate(zip(cfg.encoder_layers, enc)):
        fan_in = l.kernel * l.kernel * l.in_c
        kernel = torch.randn((l.kernel, l.kernel, l.in_c, l.out_c),
                             generator=gen) * (2.0 / fan_in) ** 0.5
        p[f"enc{i}"] = plan.pack(kernel)
        p[f"encb{i}"] = torch.zeros((l.out_c,))
    fdim = cfg.feat_hw * cfg.feat_hw * cfg.feat_c
    for head in ("mu", "lv"):
        p[f"{head}_w"] = torch.randn((fdim, cfg.latent_dim),
                                     generator=gen) * fdim ** -0.5
        p[f"{head}_b"] = torch.zeros((cfg.latent_dim,))
    p["proj"] = torch.randn((cfg.latent_dim, fdim),
                            generator=gen) * cfg.latent_dim ** -0.5
    p["projb"] = torch.zeros((fdim,))
    for i, (l, plan) in enumerate(zip(cfg.decoder_layers, dec)):
        kernel = torch.randn((l.kernel, l.kernel, l.in_c, l.out_c),
                             generator=gen) * 0.02
        p[f"dec{i}"] = plan.pack(kernel)
        p[f"decb{i}"] = torch.zeros((l.out_c,))
    return {k: v.to(dev) for k, v in p.items()}


def params_from_jax(np_params: dict, cfg: VAEConfig, device="cuda"):
    """Map JAX ``vae_init`` params (converted to numpy) onto the port's:
    the superpacks as they are (the row order is shared; an int8 one as
    its codes and scales), the dense heads unpermuted (both flatten
    NHWC)."""
    dev = resolve_device(device)
    want = _dense_shapes(cfg)
    for half, layers, plans in (("enc", cfg.encoder_layers,
                                 encoder_plans(cfg)),
                                ("dec", cfg.decoder_layers,
                                 decoder_plans(cfg))):
        for i, (l, plan) in enumerate(zip(layers, plans)):
            want[f"{half}{i}"] = (plan.total_taps * l.in_c, l.out_c)
            want[f"{half}b{i}"] = (l.out_c,)
    return params_from_numpy(np_params, want, dev)


# ---------------------------------------------------------------------------
# apply: planned execution on the superpacks, end to end
# ---------------------------------------------------------------------------

def encode(p, x: torch.Tensor, cfg: VAEConfig):
    """x (B, H, W, C) -> (mu, logvar), each (B, latent_dim)."""
    for i, plan in enumerate(encoder_plans(cfg, x.dtype)):
        x = torch.relu(plan.apply(x, p[f"enc{i}"]) + p[f"encb{i}"])
    h = x.reshape(x.shape[0], -1)
    return (torch.matmul(h, p["mu_w"]) + p["mu_b"],
            torch.matmul(h, p["lv_w"]) + p["lv_b"])


def decode(p, z: torch.Tensor, cfg: VAEConfig) -> torch.Tensor:
    """z (B, latent_dim) -> recon (B, H, W, C) in [-1, 1]: every transposed
    conv one planned launch on its superpack."""
    plans = decoder_plans(cfg, z.dtype)
    h = torch.relu(torch.matmul(z, p["proj"]) + p["projb"])
    x = h.reshape(z.shape[0], cfg.feat_hw, cfg.feat_hw, cfg.feat_c)
    for i, plan in enumerate(plans):
        x = plan.apply(x, p[f"dec{i}"]) + p[f"decb{i}"]
        x = torch.tanh(x) if i == len(plans) - 1 else torch.relu(x)
    return x


def reparameterize(gen: Optional[torch.Generator], mu: torch.Tensor,
                   logvar: torch.Tensor, *,
                   eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``mu + exp(logvar / 2) · eps``, ``eps`` standard normal drawn from
    the CPU generator ``gen`` unless given."""
    if eps is None:
        eps = torch.randn(tuple(mu.shape), generator=gen,
                          dtype=mu.dtype).to(mu.device)
    return mu + torch.exp(0.5 * logvar) * eps


def vae_apply(p, x: torch.Tensor, gen: Optional[torch.Generator],
              cfg: VAEConfig, *, eps: Optional[torch.Tensor] = None):
    """(recon, mu, logvar) of one pass through both halves."""
    mu, logvar = encode(p, x, cfg)
    z = reparameterize(gen, mu, logvar, eps=eps)
    return decode(p, z, cfg), mu, logvar


def elbo_loss(p, x: torch.Tensor, gen: Optional[torch.Generator],
              cfg: VAEConfig, beta: float = 1.0, *,
              eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Negative ELBO: Gaussian reconstruction (unit-variance MSE) + beta ·
    KL to the unit prior, both per-image sums averaged over the batch."""
    recon, mu, logvar = vae_apply(p, x, gen, cfg, eps=eps)
    se = torch.square(recon - x).sum(dim=(1, 2, 3))
    kl = -0.5 * (1.0 + logvar - torch.square(mu)
                 - torch.exp(logvar)).sum(dim=-1)
    return (se + beta * kl).mean()


def sample(p, gen: Optional[torch.Generator], cfg: VAEConfig, n: int = 16,
           *, z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Decode ``n`` draws from the prior, made on the CPU generator
    ``gen`` unless ``z`` (n, latent_dim) is given, on the params'
    device."""
    if z is None:
        z = torch.randn((n, cfg.latent_dim), generator=gen)
    return decode(p, z.to(p["proj"].device), cfg)
