"""Phase decomposition of transposed (fractionally-strided) convolutions.

Counterpart of ``repro.core.decompose`` (the paper's §3.1 index algebra).
Each output index ``o = s*u + q`` has phase ``q = o mod s``; phase q is a
dense stride-1 correlation of the raw input with the sub-kernel
``K[rho_q::s]``, shifted by ``a_q = (q + rho_q - pl) // s``.  The phase
outputs are disjoint and interleave into y; no zero is materialized.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.core.untangle import conv_out_size

Pair = tuple[int, int]


def transposed_out_size(in_size: int, k: int, stride: int, pad: Pair) -> int:
    """Output length of the lhs-dilated correlation along one dim."""
    dil = (in_size - 1) * stride + 1
    return dil + pad[0] + pad[1] - k + 1


def single_out_size(in_size: int, k: int, stride: int, dilation: int,
                    pad: Pair) -> int:
    """Output length of the strided / rhs-dilated correlation along one dim."""
    return conv_out_size(in_size, k, stride, dilation, pad)


@dataclasses.dataclass(frozen=True)
class PhasePlan1D:
    """Everything needed to compute output phase q along one spatial dim."""

    phase: int          # q
    rho: int            # first tap index used by this phase
    taps: int           # T_q = number of taps (len(range(rho, R, s)))
    pad: Pair           # (lo, hi) pad (negative = crop) of the stride-1 conv
    out_size: int       # U_q = number of output pixels with this phase


def plan_phases_1d(in_size: int, k: int, stride: int,
                   pad: Pair) -> list[PhasePlan1D]:
    """Build the per-phase plans along one dimension."""
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    out = transposed_out_size(in_size, k, stride, pad)
    if out <= 0:
        raise ValueError(f"non-positive output size {out}")
    pl_, _ = pad
    plans = []
    for q in range(stride):
        rho = (pl_ - q) % stride
        taps = len(range(rho, k, stride))
        u_q = max(0, -(-(out - q) // stride))  # ceil((out - q)/s), clipped
        if taps == 0 or u_q == 0:
            plans.append(PhasePlan1D(q, rho, taps, (0, 0), u_q))
            continue
        a_q = (q + rho - pl_) // stride
        lo = -a_q
        # conv output length: in + lo + hi - taps + 1 == u_q
        hi = u_q - 1 + taps - in_size - lo
        plans.append(PhasePlan1D(q, rho, taps, (lo, hi), u_q))
    if sum(p.out_size for p in plans) != out:
        raise AssertionError("phase extents do not partition the output")
    return plans


def decompose_kernel(kernel: torch.Tensor, strides: Sequence[int],
                     padding: Sequence[Pair]) -> dict[Pair, torch.Tensor]:
    """Slice the HWIO kernel into per-phase sub-kernels K[rho_h::s_h, rho_w::s_w].

    Returns {(q_h, q_w): sub_kernel}; a sub-kernel is empty (0 taps) for
    strides larger than the kernel."""
    (sh, sw) = strides
    (ph, pw) = padding
    subs = {}
    for qh in range(sh):
        rho_h = (ph[0] - qh) % sh
        for qw in range(sw):
            rho_w = (pw[0] - qw) % sw
            subs[(qh, qw)] = kernel[rho_h::sh, rho_w::sw]
    return subs


def interleave_uniform(phase_outputs: Sequence[torch.Tensor],
                       strides: Sequence[int], out_hw: Pair) -> torch.Tensor:
    """Interleave uniform-extent phase outputs (phase-ordered list, q_h-major)
    with one stack + permute + reshape.  Requires ``U*s_h == out_h`` and
    ``V*s_w == out_w`` for every phase (``ConvPlan.uniform``)."""
    (sh, sw) = strides
    oh, ow = out_hw
    b, u, v, n = phase_outputs[0].shape
    y = torch.stack(list(phase_outputs), dim=0).reshape(sh, sw, b, u, v, n)
    return y.permute(2, 3, 0, 4, 1, 5).reshape(b, oh, ow, n)


def interleave_phases(phase_outputs: dict[Pair, torch.Tensor],
                      strides: Sequence[int], out_hw: Pair) -> torch.Tensor:
    """Interleave per-phase outputs O[.., s_h*u+q_h, s_w*v+q_w, :] = y_q[.., u, v, :]."""
    (sh, sw) = strides
    oh, ow = out_hw
    any_y = next(iter(phase_outputs.values()))
    uniform = (oh % sh == 0 and ow % sw == 0 and all(
        y.shape[-3] == oh // sh and y.shape[-2] == ow // sw
        for y in phase_outputs.values()))
    if uniform:
        # (B, U, V, N) per phase -> (B, U, sh, V, sw, N) -> (B, oh, ow, N)
        rows = []
        for qh in range(sh):
            cols = [phase_outputs[(qh, qw)] for qw in range(sw)]
            rows.append(torch.stack(cols, dim=-2))     # (B, U, V, sw, N)
        y = torch.stack(rows, dim=-4)                  # (B, U, sh, V, sw, N)
        return y.reshape(*y.shape[:-5], oh, ow, any_y.shape[-1])
    # general path: strided writes into zeros
    out = any_y.new_zeros((*any_y.shape[:-3], oh, ow, any_y.shape[-1]))
    for (qh, qw), y in phase_outputs.items():
        if y.shape[-3] == 0 or y.shape[-2] == 0:
            continue
        out[..., qh::sh, qw::sw, :] = y
    return out
