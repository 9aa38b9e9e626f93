"""DilatedNet-style semantic segmentation on the port's plan/executor engine.

Counterpart of ``repro.models.segnet``: a small strided **front-end** (3x3
convs, two stride-2 downsamples) of planned 'conv' sites, an **atrous
context module** (3x3 dilated convs at dilation 1, 2, 4, 8, 1 at constant
resolution) of planned 'dilated' sites, and a 1x1 classifier head.  Every
site gets a ``ConvPlan`` once at model load (``segnet_plans``) and its
weights are stored in the single-phase tap-major superpack ``(R·S·C, N)``,
row for row the JAX package's, so ``params_from_jax`` carries JAX weights
across as plain arrays.  On the 'cuda' route every site is one launch of
kernel B; with ``wdtype='int8'`` one launch of its int8 entry (kernel E).

``SegNetConfig.backend`` is the plan policy ('torch' | 'cuda' | 'auto'),
``SegNetConfig.autotune`` an optional ``AutotunePolicy`` (measured
routes).  The JAX config's device-tiling field (``spatial``) waits for the
plane-parallel slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import resolve_device
from repro_torch.core.autotune import AutotunePolicy
from repro_torch.core.plan import ConvPlan, ConvSpec, dtype_name, plan_conv
from repro_torch.models import params_from_numpy


@dataclasses.dataclass(frozen=True)
class SegLayer:
    kind: str          # 'conv' (front-end / head) | 'dilated' (context)
    in_hw: int
    in_c: int
    out_c: int
    kernel: int = 3
    stride: int = 1
    dilation: int = 1


def atrous_padding(kernel: int, dilation: int):
    """'SAME'-style padding for an odd kernel at dilation d: the dilated tap
    reach is (k-1)·d + 1, so pad d·(k-1)/2 per side keeps the resolution
    (stride 1) or halves it exactly (stride 2, even input)."""
    half = dilation * (kernel - 1) // 2
    return ((half, half), (half, half))


def _front_end(in_hw: int, in_c: int, width: int) -> tuple[SegLayer, ...]:
    return (
        SegLayer("conv", in_hw, in_c, width // 4),
        SegLayer("conv", in_hw, width // 4, width // 2, stride=2),
        SegLayer("conv", in_hw // 2, width // 2, width // 2),
        SegLayer("conv", in_hw // 2, width // 2, width, stride=2),
    )


def _context(hw: int, width: int) -> tuple[SegLayer, ...]:
    return tuple(SegLayer("dilated", hw, width, width, dilation=d)
                 for d in (1, 2, 4, 8, 1))


@dataclasses.dataclass(frozen=True)
class SegNetConfig:
    name: str
    in_hw: int = 64
    in_c: int = 3
    width: int = 128
    num_classes: int = 21
    backend: str = "torch"          # plan policy: 'torch' | 'cuda' | 'auto'
    # measured-route policy (None = heuristic routes)
    autotune: Optional[AutotunePolicy] = None
    # weight storage dtype for every conv site: 'float32' (dense) or 'int8'
    # (quantized superpacks, ``ConvSpec.wdtype``); activations stay f32
    wdtype: str = "float32"

    @property
    def layers(self) -> tuple[SegLayer, ...]:
        front = _front_end(self.in_hw, self.in_c, self.width)
        ctx = _context(self.in_hw // 4, self.width)
        head = (SegLayer("conv", self.in_hw // 4, self.width,
                         self.num_classes, kernel=1),)
        return front + ctx + head

    @property
    def out_hw(self) -> int:
        return self.in_hw // 4


SEGNET = SegNetConfig("segnet")                        # edge default
SEGNET_TINY = SegNetConfig("segnet-tiny", in_hw=32, width=32, num_classes=5)


def segnet_plans(cfg: SegNetConfig,
                 dtype=torch.float32) -> tuple[ConvPlan, ...]:
    """Plans for every front-end / context / head site (cached; the build
    cost is paid once at model load)."""
    return tuple(plan_conv(ConvSpec(
        kind=l.kind, in_hw=(l.in_hw, l.in_hw), in_c=l.in_c, out_c=l.out_c,
        kernel_hw=(l.kernel, l.kernel), strides=(l.stride, l.stride),
        padding=atrous_padding(l.kernel, l.dilation),
        dilation=(l.dilation, l.dilation), dtype=dtype_name(dtype),
        backend=cfg.backend, wdtype=cfg.wdtype), autotune=cfg.autotune)
        for l in cfg.layers)


def segnet_init(seed_or_generator, cfg: SegNetConfig, device="cuda"):
    """Random params with every conv weight superpacked: ``w{i}`` the
    (R·S·C, N) superpack (a ``QuantizedSuperpack`` under ``wdtype='int8'``)
    drawn He-normal, ``b{i}`` zeros.  ``seed_or_generator`` is an int seed
    or a CPU ``torch.Generator``; the draws are made on the CPU, so a seed
    gives the same weights on every device.  Returns the params only: the
    logical sharding specs JAX returns beside them wait for the
    data-parallel slice."""
    dev = resolve_device(device)
    gen = seed_or_generator if isinstance(seed_or_generator,
                                          torch.Generator) \
        else torch.Generator().manual_seed(int(seed_or_generator))
    p = {}
    for i, (l, plan) in enumerate(zip(cfg.layers, segnet_plans(cfg))):
        fan_in = l.kernel * l.kernel * l.in_c
        kernel = torch.randn((l.kernel, l.kernel, l.in_c, l.out_c),
                             generator=gen) * (2.0 / fan_in) ** 0.5
        p[f"w{i}"] = plan.pack(kernel)
        p[f"b{i}"] = torch.zeros((l.out_c,))
    return {k: v.to(dev) for k, v in p.items()}


def params_from_jax(np_params: dict, cfg: SegNetConfig, device="cuda"):
    """Map JAX ``segnet_init`` params (converted to numpy) onto the port's:
    ``w{i}`` (the superpack as is; an int8 one as its codes and scales) and
    ``b{i}``."""
    dev = resolve_device(device)
    want = {}
    for i, l in enumerate(cfg.layers):
        want[f"w{i}"] = (l.kernel * l.kernel * l.in_c, l.out_c)
        want[f"b{i}"] = (l.out_c,)
    return params_from_numpy(np_params, want, dev)


def segnet_apply(p, x: torch.Tensor, cfg: SegNetConfig) -> torch.Tensor:
    """x: (B, in_hw, in_hw, in_c) -> logits (B, in_hw/4, in_hw/4, classes).

    Every conv is ``plan.apply`` on the stored superpack: one launch (or one
    wide product) per site, differentiable through the §3.2.3 backward."""
    plans = segnet_plans(cfg, x.dtype)          # cache hits after model load
    for i, plan in enumerate(plans):
        x = plan.apply(x, p[f"w{i}"]) + p[f"b{i}"]
        if i < len(plans) - 1:
            x = torch.relu(x)
    return x


def segnet_unpack(p, cfg: SegNetConfig):
    """Packed params -> full (R,S,C,N) HWIO kernels (offline export)."""
    out = dict(p)
    for i, plan in enumerate(segnet_plans(cfg)):
        out[f"w{i}"] = plan.unpack(p[f"w{i}"])
    return out


def upsample_logits(logits: torch.Tensor, factor: int = 4) -> torch.Tensor:
    """Nearest-neighbour upsample back to input resolution."""
    return logits.repeat_interleave(factor, dim=-3) \
        .repeat_interleave(factor, dim=-2)


def segnet_loss(p, x: torch.Tensor, labels: torch.Tensor,
                cfg: SegNetConfig) -> torch.Tensor:
    """Mean pixel cross-entropy at feature resolution.

    labels: (B, out_hw, out_hw) int class ids."""
    logp = F.log_softmax(segnet_apply(p, x, cfg), dim=-1)
    return -torch.gather(logp, -1, labels[..., None].long()).mean()
