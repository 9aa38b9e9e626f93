"""Latent-diffusion-style U-Net on the port's plan/executor engine.

Counterpart of ``repro.models.unet``: a strided 'conv' encoder, a dilated
bottleneck, a transposed decoder and skip concatenations, so one forward
runs every conv kind the engine plans.  Each site gets a ``ConvPlan`` once
at model load (``unet_plans``) and its weights are stored superpacked, row
for row the JAX package's (``wdtype='int8'`` flips every site to quantized
superpacks), so ``params_from_jax`` carries JAX weights across as plain
arrays.  Training differentiates through the plans' §3.2.3 backwards, and
the skip concatenations split their cotangents into both halves.

On the 'cuda' route each site is one kernel launch: at the 32 px ``UNET``
every correlation site takes kernel B and both ups kernel A; at a 512 px
image the stem, down0, fuse0 and head take the spatially tiled kernel C
and up0 the tiled kernel D, where the reference tiles them too.

Denoising: ``unet_apply(p, x_t, t, cfg)`` predicts the noise given the
corrupted image and a timestep in ``[0, 1]``; ``unet_loss`` is the
denoising score matching MSE under a cosine ``alpha_bar``;
``denoise_loop`` the sequential Euler refinement.

``UNetConfig.backend`` is the plan policy ('torch' | 'cuda' | 'auto');
``autotune`` an optional ``AutotunePolicy`` (measured routes); ``spatial``
the device tiling every site requests (``core.spatial``): under a bound
spatial mesh each site whose bucket carries a ``dev_tiles`` verdict runs
split over the mesh's ranks, the rest on one rank; between split sites
the activations and skips stay split (``spatial.PlaneBlocks``), and
``unet_apply`` gathers its output.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.core import resolve_device
from repro_torch.core.autotune import AutotunePolicy
from repro_torch.core.plan import ConvPlan, ConvSpec, dtype_name, plan_conv
from repro_torch.core.spatial import gather_plane
from repro_torch.models import dense_cols, params_from_numpy, shard
from repro_torch.models.gan import deconv_padding
from repro_torch.models.segnet import atrous_padding
from repro_torch.sharding import SUPERPACK_SPEC, Spec


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    name: str
    image_hw: int = 32
    in_c: int = 3
    base: int = 32                  # encoder widths: base · 2^level
    depth: int = 2                  # stride-2 down/up stages
    mid_dilations: tuple[int, ...] = (1, 2)   # bottleneck 'dilated' sites
    kernel: int = 3                 # stem / down / fuse / head kernel
    up_kernel: int = 4              # transposed up kernel; % stride == 0
    time_dim: int = 64              # sinusoidal timestep embedding width
    backend: str = "torch"          # plan policy: 'torch' | 'cuda' | 'auto'
    autotune: Optional[AutotunePolicy] = None
    spatial: tuple[int, int] = (1, 1)
    wdtype: str = "float32"         # 'float32' | 'int8' superpacks

    def width(self, level: int) -> int:
        return self.base * (2 ** level)

    def hw(self, level: int) -> int:
        return self.image_hw // (2 ** level)


UNET = UNetConfig("unet")                                    # 32px latents
UNET_TINY = UNetConfig("unet-tiny", image_hw=16, base=8, time_dim=16)


# ---------------------------------------------------------------------------
# sites: every conv in forward order, as (name, ConvSpec)
# ---------------------------------------------------------------------------

def unet_sites(cfg: UNetConfig,
               dtype="float32") -> tuple[tuple[str, ConvSpec], ...]:
    """(name, ConvSpec) for every conv site, forward order; one list drives
    planning, init and apply."""
    k = cfg.kernel
    same = ((k // 2, (k - 1) // 2), (k // 2, (k - 1) // 2))

    def spec(kind, hw, c_in, c_out, kernel, stride=1, dilation=1,
             padding=None):
        return ConvSpec(
            kind=kind, in_hw=(hw, hw), in_c=c_in, out_c=c_out,
            kernel_hw=(kernel, kernel), strides=(stride, stride),
            padding=padding if padding is not None else same,
            dilation=(dilation, dilation), dtype=dtype_name(dtype),
            backend=cfg.backend, spatial=cfg.spatial, wdtype=cfg.wdtype)

    sites = [("stem", spec("conv", cfg.image_hw, cfg.in_c, cfg.base, k))]
    for i in range(cfg.depth):
        sites.append((f"down{i}", spec(
            "conv", cfg.hw(i), cfg.width(i), cfg.width(i + 1), k, stride=2)))
    for j, d in enumerate(cfg.mid_dilations):
        sites.append((f"mid{j}", spec(
            "dilated", cfg.hw(cfg.depth), cfg.width(cfg.depth),
            cfg.width(cfg.depth), k, dilation=d,
            padding=atrous_padding(k, d))))
    for i in reversed(range(cfg.depth)):
        sites.append((f"up{i}", spec(
            "transposed", cfg.hw(i + 1), cfg.width(i + 1), cfg.width(i),
            cfg.up_kernel, stride=2,
            padding=deconv_padding(cfg.up_kernel, 2))))
        sites.append((f"fuse{i}", spec(
            "conv", cfg.hw(i), 2 * cfg.width(i), cfg.width(i), k)))
    sites.append(("head", spec("conv", cfg.image_hw, cfg.base, cfg.in_c, k)))
    return tuple(sites)


def unet_plans(cfg: UNetConfig,
               dtype=torch.float32) -> dict[str, ConvPlan]:
    """Plans of every site (cached; built once at model load)."""
    return {name: plan_conv(s, autotune=cfg.autotune)
            for name, s in unet_sites(cfg, dtype_name(dtype))}


def unet_route_summary(cfg: UNetConfig, batch: int = 1,
                       dtype=torch.float32) -> dict[str, tuple[str, str]]:
    """{site: (conv kind, route path at ``batch``)}."""
    return {name: (plan.spec.kind, plan.route_for_batch(batch).path)
            for name, plan in unet_plans(cfg, dtype).items()}


# ---------------------------------------------------------------------------
# params: superpacked conv weights + timestep-embedding projections
# ---------------------------------------------------------------------------

def _tproj_width(cfg: UNetConfig, i: int) -> int:
    # tproj{i} is added right after down{i} (channels width(i+1)); the last
    # one conditions the bottleneck entry at width(depth)
    return cfg.width(min(i + 1, cfg.depth))


def unet_specs(cfg: UNetConfig) -> dict:
    """JAX's ``unet_init`` specs: every superpack ``SUPERPACK_SPEC``, its
    bias ``("conv_out",)``, ``tproj{i}`` ``(None, "conv_out")``, the
    timestep MLP replicated."""
    s = {}
    for name, _ in unet_sites(cfg):
        s[name] = SUPERPACK_SPEC
        s[f"{name}_b"] = Spec("conv_out")
    s["temb_w"] = Spec(None, None)
    s["temb_b"] = Spec(None)
    for i in range(cfg.depth + 1):
        s[f"tproj{i}"] = Spec(None, "conv_out")
    return s


def unet_init(seed_or_generator, cfg: UNetConfig, device="cuda", dist=None):
    """Random params with every conv weight superpacked: He-normal for the
    correlation sites, the zoo's 0.02 normal for the transposed ups, zero
    biases, the timestep MLP ``temb_w``/``temb_b`` and one projection
    ``tproj{i}`` per encoder level.  ``seed_or_generator`` is an int seed
    or a CPU ``torch.Generator``; the draws are made on the CPU in site
    order, so a seed gives the same weights on every device and the f32 and
    int8 twins of one seed quantize the same draw.  Returns the params
    (this rank's blocks under ``dist``; their specs are ``unet_specs``)."""
    dev = resolve_device(device)
    gen = seed_or_generator if isinstance(seed_or_generator,
                                          torch.Generator) \
        else torch.Generator().manual_seed(int(seed_or_generator))
    plans = unet_plans(cfg)
    p = {}
    for name, spec in unet_sites(cfg):
        r, c, n = spec.kernel_hw[0], spec.in_c, spec.out_c
        scale = 0.02 if spec.kind == "transposed" \
            else (2.0 / (r * r * c)) ** 0.5
        kernel = torch.randn((r, r, c, n), generator=gen) * scale
        p[name] = plans[name].pack(kernel)
        p[f"{name}_b"] = torch.zeros((n,))
    p["temb_w"] = torch.randn((cfg.time_dim, cfg.time_dim),
                              generator=gen) * cfg.time_dim ** -0.5
    p["temb_b"] = torch.zeros((cfg.time_dim,))
    for i in range(cfg.depth + 1):
        p[f"tproj{i}"] = torch.randn((cfg.time_dim, _tproj_width(cfg, i)),
                                     generator=gen) * cfg.time_dim ** -0.5
    return shard({k: v.to(dev) for k, v in p.items()}, unet_specs(cfg), dist)


def params_from_jax(np_params: dict, cfg: UNetConfig, device="cuda"):
    """Map JAX ``unet_init`` params (converted to numpy) onto the port's:
    every site's superpack as is (an int8 one as its codes and scales) and
    bias, ``temb_w``/``temb_b`` and ``tproj{i}``."""
    dev = resolve_device(device)
    want = {}
    for name, plan in unet_plans(cfg).items():
        want[name] = (plan.total_taps * plan.spec.in_c, plan.spec.out_c)
        want[f"{name}_b"] = (plan.spec.out_c,)
    want["temb_w"] = (cfg.time_dim, cfg.time_dim)
    want["temb_b"] = (cfg.time_dim,)
    for i in range(cfg.depth + 1):
        want[f"tproj{i}"] = (cfg.time_dim, _tproj_width(cfg, i))
    return params_from_numpy(np_params, want, dev)


# ---------------------------------------------------------------------------
# apply: planned execution on the superpacks, end to end
# ---------------------------------------------------------------------------

def time_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding of ``t`` in [0, 1] -> (B, dim)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=t.dtype, device=t.device)
                      / max(1, half - 1))
    ang = (t * 1000.0)[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def unet_apply(p, x: torch.Tensor, t: torch.Tensor,
               cfg: UNetConfig, dist=None) -> torch.Tensor:
    """(x_t (B,H,W,C), t (B,) in [0,1]) -> predicted noise eps (B,H,W,C).

    Encoder activations are kept as skips and concatenated after each
    transposed up; the fuse conv contracts the doubled channels, so the
    concat's cotangent splits into both halves through the planned
    backwards.  ``dist``: the params are each rank's blocks (split
    superpacks run as tensor-parallel sites, the ``tproj`` column blocks
    are gathered)."""
    plans = unet_plans(cfg, x.dtype)           # cache hits after model load

    def conv(name, h):
        return plans[name].apply(h, p[name], bias=p[f"{name}_b"])

    def tproj(i):
        y = dense_cols(emb, p[f"tproj{i}"], dist, _tproj_width(cfg, i))
        return y[:, None, None, :]

    emb = torch.nn.functional.silu(
        time_embedding(t.to(x.dtype), cfg.time_dim) @ p["temb_w"]
        + p["temb_b"])

    h = torch.relu(conv("stem", x))
    skips = []
    for i in range(cfg.depth):
        skips.append(h)
        h = torch.relu(conv(f"down{i}", h) + tproj(i))
    h = h + tproj(cfg.depth)
    for j in range(len(cfg.mid_dilations)):
        h = torch.relu(conv(f"mid{j}", h))
    for i in reversed(range(cfg.depth)):
        h = torch.relu(conv(f"up{i}", h))
        h = torch.cat([h, skips[i]], dim=-1)
        h = torch.relu(conv(f"fuse{i}", h))
    return gather_plane(conv("head", h))


# ---------------------------------------------------------------------------
# denoising: cosine schedule, DSM loss, sequential refinement loop
# ---------------------------------------------------------------------------

def alpha_bar(t: torch.Tensor) -> torch.Tensor:
    """Cosine noise schedule (Nichol & Dhariwal): abar(t), t in [0, 1]."""
    return torch.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2


def unet_loss(p, x0: torch.Tensor, gen: torch.Generator | None,
              cfg: UNetConfig, *, t: torch.Tensor | None = None,
              noise: torch.Tensor | None = None) -> torch.Tensor:
    """Denoising score matching: corrupt ``x0`` at a uniform timestep,
    predict the noise, MSE.  ``t`` (B,) and ``noise`` (like ``x0``) are
    drawn from the CPU generator ``gen`` unless given (the tests hand both
    packages the same draws: JAX's ``jax.random`` and torch's generators
    give different numbers from one seed)."""
    b = x0.shape[0]
    if t is None:
        t = torch.rand((b,), generator=gen, dtype=x0.dtype).to(x0.device)
    if noise is None:
        noise = torch.randn(tuple(x0.shape), generator=gen,
                            dtype=x0.dtype).to(x0.device)
    ab = alpha_bar(t)[:, None, None, None]
    x_t = torch.sqrt(ab) * x0 + torch.sqrt(1.0 - ab) * noise
    eps = unet_apply(p, x_t, t, cfg)
    return torch.mean(torch.square(eps - noise))


def denoise_step(p, x_t: torch.Tensor, t_frac: torch.Tensor,
                 cfg: UNetConfig, dt: float) -> torch.Tensor:
    """One refinement step: predict eps at ``t_frac`` (B,) and take an
    Euler step of size ``dt`` toward t = 0."""
    eps = unet_apply(p, x_t, t_frac, cfg)
    return x_t - eps * dt


def denoise_loop(p, x_t: torch.Tensor, cfg: UNetConfig,
                 steps: int) -> torch.Tensor:
    """Sequential Euler refinement, ``steps`` planned U-Net calls."""
    for s in reversed(range(steps)):
        tf = torch.full((x_t.shape[0],), (s + 1) / steps, dtype=x_t.dtype,
                        device=x_t.device)
        eps = unet_apply(p, x_t, tf, cfg)
        x_t = x_t - eps / steps
    return x_t


def sample(p, gen: torch.Generator, cfg: UNetConfig, n: int = 4,
           steps: int = 8, device="cuda") -> torch.Tensor:
    """Draw from the prior (on the CPU generator ``gen``) and refine."""
    x_t = torch.randn((n, cfg.image_hw, cfg.image_hw, cfg.in_c),
                      generator=gen).to(resolve_device(device))
    return denoise_loop(p, x_t, cfg, steps)
