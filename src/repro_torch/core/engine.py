"""HUGE² public ops: thin dispatchers over the plan/executor engine.

Counterpart of ``repro.core.engine``.  Each call builds the spec from the
argument shapes, compiles it once (``plan_conv`` caches per spec) and runs
``ConvPlan.apply``, so each op is differentiable through the plan's §3.2.3
backward on the superpack.  They take the full HWIO kernel and pack it per
call; training and serving paths hold packed weights and call
``plan.apply`` directly (see ``repro_torch.models.gan``).

``backend`` is the plan policy: ``'torch'`` (plain products), ``'cuda'``
(the hand-written kernels on CUDA tensors, their plain versions on CPU
tensors) or ``'auto'`` (``'cuda'`` when a card is present).
"""
from __future__ import annotations

import torch

from repro_torch.core.plan import conv_spec, plan_conv


def huge_conv_transpose2d(x: torch.Tensor, kernel: torch.Tensor,
                          strides=(2, 2), padding=((2, 2), (2, 2)),
                          backend: str = "auto") -> torch.Tensor:
    """Transposed conv via a cached plan (phase decomposition + untangling).

    x: (..., H, W, C) NHWC; kernel: (R, S, C, N) HWIO.  Semantics of
    ``lax.conv_general_dilated(..., lhs_dilation=strides, padding=padding)``.
    """
    spec = conv_spec("transposed", x.shape, kernel.shape, strides=strides,
                     padding=padding, dtype=x.dtype, backend=backend)
    return plan_conv(spec).apply_kernel(x, kernel)


def huge_conv2d(x: torch.Tensor, kernel: torch.Tensor, strides=(1, 1),
                padding=((0, 0), (0, 0)),
                backend: str = "auto") -> torch.Tensor:
    """Standard / strided conv via untangling (discriminator layers)."""
    spec = conv_spec("conv", x.shape, kernel.shape, strides=strides,
                     padding=padding, dtype=x.dtype, backend=backend)
    return plan_conv(spec).apply(x, kernel)


def huge_dilated_conv2d(x: torch.Tensor, kernel: torch.Tensor, *,
                        dilation=(2, 2), strides=(1, 1),
                        padding=((0, 0), (0, 0)),
                        backend: str = "auto") -> torch.Tensor:
    """Atrous conv via untangling: the dilated kernel is never built, and
    the HWIO kernel's gradient comes back 4-D."""
    spec = conv_spec("dilated", x.shape, kernel.shape, strides=strides,
                     padding=padding, dilation=dilation, dtype=x.dtype,
                     backend=backend)
    return plan_conv(spec).apply(x, kernel)
