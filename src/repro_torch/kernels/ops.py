"""The kernels' HWIO entries: pack per call, run the 'cuda' route.

Counterpart of ``repro.kernels.ops``.  Each entry builds the spec from the
argument shapes with the 'cuda' policy, packs the HWIO kernel into the
plan's superpack and runs the plan's forward: kernel B (or C, where the
reference tiles the plane) for ``untangled_conv2d``, kernel A (or D) for
``untangled_deconv2d``, on CUDA tensors; their plain versions on CPU
tensors.  Forward only, for kernel-level callers and tests: serving and
training hold packed weights and call ``ConvPlan.apply``.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core.plan import (_single_fwd, _transposed_fwd, conv_spec,
                                   plan_conv)

Pair = tuple[int, int]


def untangled_conv2d(x: torch.Tensor, kernel: torch.Tensor, *,
                     strides: Pair = (1, 1),
                     padding: Sequence[Pair] = ((0, 0), (0, 0)),
                     rhs_dilation: Pair = (1, 1)) -> torch.Tensor:
    """Untangled strided / dilated correlation of NHWC ``x`` with the HWIO
    ``kernel`` (R, S, C, N), ``padding`` as in ``lax.conv_general_dilated``
    (negative amounts crop)."""
    kind = "dilated" if tuple(rhs_dilation) != (1, 1) else "conv"
    spec = conv_spec(kind, x.shape, kernel.shape, strides=strides,
                     padding=padding, dilation=rhs_dilation, dtype=x.dtype,
                     backend="cuda")
    plan = plan_conv(spec)
    return _single_fwd(plan, x, plan.as_superpack(kernel))


def untangled_deconv2d(x: torch.Tensor, kernel: torch.Tensor, *,
                       strides: Pair = (2, 2),
                       padding: Sequence[Pair] = ((2, 2), (2, 2))
                       ) -> torch.Tensor:
    """Fused transposed conv, every phase in one launch: the lhs-dilated
    correlation of NHWC ``x`` with the HWIO ``kernel``."""
    spec = conv_spec("transposed", x.shape, kernel.shape, strides=strides,
                     padding=padding, dtype=x.dtype, backend="cuda")
    plan = plan_conv(spec)
    return _transposed_fwd(plan, x, plan.pack(kernel))
