"""Kernels A and B: the untangled convolutions, hand-written for Hopper.

``untangled_deconv2d`` (kernel A) is the port of ``repro.kernels
.untangled_conv.untangled_deconv2d_pallas`` (TPU kernel ``_deconv_kernel``):
ONE launch computes every s_h·s_w output phase of a transposed conv over
the globally padded plane and stores the output interleaved, with no zero
inserted.  ``untangled_conv2d_superpack`` (kernel B) is the port of
``untangled_conv2d_superpack_pallas`` (TPU kernel ``_kernel``): ONE launch
of the strided or dilated correlation of a pre-padded plane with the
tap-major ``(R·S·C, N)`` superpack, with no zero inserted in the kernel.
The CUDA sources are ``csrc/untangled_deconv.cu`` and
``csrc/untangled_conv.cu`` (their headers say what bounds each kernel on the
card and what the design does about it); ``_build`` compiles them with
``nvcc`` at first use and binds their plain C entries with ``ctypes``.

Kernel E, the int8 tap panel of the TPU kernels (``_tap_panel``), is each
kernel's int8 entry: ``scales=`` marks the superpack as int8 codes with one
f32 scale per row (a ``QuantizedSuperpack``), and the kernel multiplies
each code by its row's scale as it stages the weight tile, so the int8
kernel on ``(q, scale)`` is bit-equal to the f32 kernel on
``dequantize_int8(q, scale)``.

Each wrapper launches its kernel for CUDA tensors, and raises on anything
the kernel does not take.  It takes its plain version (``*_ref``) only for
tensors on the CPU.  The kernels have no backward of their own: inputs that
require grad raise, and training goes through ``ConvPlan.apply``, whose
autograd Functions call the wrappers on detached inputs and run the §3.2.3
backward as plain products.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from repro_torch.runtime.compress import dequantize_int8

Pair = tuple[int, int]

# block tiles (BM, BN) of the kernel's configs, indexed as in the source
_CONFIGS = ((128, 128), (64, 64), (256, 16))
# the big tile is taken when it alone yields this many blocks (132 SMs)
_BIG_TILE_MIN_BLOCKS = 120
_INT32_MAX = 2 ** 31 - 1


def _weights_f32(superpack: torch.Tensor, scales) -> torch.Tensor:
    """The plain versions' f32 weights: the superpack, or its int8 codes
    dequantized with ``scales``."""
    if scales is None:
        return superpack.float()
    return dequantize_int8(superpack, scales)


def untangled_deconv2d_ref(xg: torch.Tensor, superpack: torch.Tensor, *,
                           phases, out_hw: Pair, strides: Pair, sum_uv: int,
                           out_dtype=None, scales=None) -> torch.Tensor:
    """Plain PyTorch version of kernel A: per phase, the tap products of the
    plane views at ``xoff + tap`` against superpack rows ``tap_off + t``,
    accumulated in f32 and written to ``y[:, q_h::s_h, q_w::s_w]``.  With
    ``scales`` the superpack is int8 codes, dequantized first."""
    b, _, _, c = xg.shape
    n = superpack.shape[1]
    sh, sw = strides
    y = torch.zeros((b, *out_hw, n), dtype=torch.float32, device=xg.device)
    x32, w32 = xg.float(), _weights_f32(superpack, scales)
    for ex in phases:
        th, tw = ex.taps
        u, v = ex.out_hw
        if th * tw == 0 or u * v == 0:
            continue                       # empty phase: stays zero
        acc = None
        for t in range(th * tw):
            ti, tj = divmod(t, tw)
            xs = x32[:, ex.xoff[0] + ti:ex.xoff[0] + ti + u,
                     ex.xoff[1] + tj:ex.xoff[1] + tj + v, :]
            row = (ex.tap_off + t) * c
            term = torch.matmul(xs, w32[row:row + c])
            acc = term if acc is None else acc + term
        y[:, ex.q[0]::sh, ex.q[1]::sw, :] = acc
    return y.to(out_dtype or xg.dtype)


@functools.lru_cache(maxsize=256)
def _phase_table(phases: tuple, device: torch.device) -> torch.Tensor:
    """The per-phase records ``(q_h, q_w, tap_off, T_h, T_w, xoff_h,
    xoff_w, U, V)`` as an int32 tensor on ``device``.  Plans are cache
    singletons and ``phases`` is one of their constants, so this is built
    (and copied to the card) once per plan and device, never per call."""
    rows = [(ex.q[0], ex.q[1], ex.tap_off, ex.taps[0], ex.taps[1],
             ex.xoff[0], ex.xoff[1], ex.out_hw[0], ex.out_hw[1])
            for ex in phases]
    return torch.tensor(rows, dtype=torch.int32, device=device)


def _pick_config(n: int, rows: Sequence[int]) -> int:
    """The block tile of kernels A and B, for N output channels and the GEMM
    rows of each phase (A: B·U·V per phase; B: its one phase's B·OH·OW):
    256x16 for a thin N (the RGB head), 128x128 when it fills the card, else
    64x64 (more, smaller blocks)."""
    if n <= 16:
        return 2
    bm, bn = _CONFIGS[0]
    blocks = sum(-(-m // bm) for m in rows) * -(-n // bn)
    return 0 if blocks >= _BIG_TILE_MIN_BLOCKS else 1


# the C entries' parameters: every pointer and the stream as c_void_p (a
# bare Python int would be passed as a 32-bit int and cut the address); the
# int8 entry takes the scale column after the codes
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 14
             + [ctypes.c_void_p])
_ARGTYPES_I8 = [ctypes.c_void_p] + _ARGTYPES


def _bind(source: str, symbol: str, argtypes):
    from repro_torch.kernels import _build
    fn = getattr(_build.load(source), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _entry(int8: bool = False):
    if int8:
        return _bind("untangled_deconv", "untangled_deconv2d_i8",
                     _ARGTYPES_I8)
    return _bind("untangled_deconv", "untangled_deconv2d_f32", _ARGTYPES)


def _check_weights(name: str, superpack: torch.Tensor, scales):
    """The weight operand a kernel takes: an f32 superpack, or int8 codes
    with an f32 ``(rows, 1)`` scale column on the same device."""
    if scales is None:
        if superpack.dtype != torch.float32:
            raise TypeError(f"{name} takes a float32 superpack, got "
                            f"{superpack.dtype}")
        return
    if superpack.dtype != torch.int8:
        raise TypeError(f"{name} with scales= takes int8 codes, got "
                        f"{superpack.dtype}")
    if scales.dtype != torch.float32 or tuple(scales.shape) != (
            superpack.shape[0], 1):
        raise ValueError(f"{name} wants float32 scales of shape "
                         f"({superpack.shape[0]}, 1), got {scales.dtype} "
                         f"{tuple(scales.shape)}")
    if scales.device != superpack.device or not scales.is_contiguous():
        raise ValueError(f"{name} takes contiguous scales beside the codes")


def _vec_ok(c: int, n: int, tensors) -> int:
    """The kernels' vector path: C % 4 == N % 4 == 0 and every operand
    aligned for its 4-element loads (16 B for f32, 4 B for int8 codes)."""
    return int(c % 4 == 0 and n % 4 == 0 and all(
        t.data_ptr() % (4 * t.element_size()) == 0 for t in tensors))


def _check(xg: torch.Tensor, superpack: torch.Tensor, phases,
           out_hw: Pair, strides: Pair, sum_uv: int):
    if xg.dim() != 4 or superpack.dim() != 2:
        raise ValueError(f"want xg (B, Hg, Wg, C) and superpack (ΣT·C, N), "
                         f"got {tuple(xg.shape)} and {tuple(superpack.shape)}")
    c = xg.shape[3]
    total_taps = sum(ex.taps[0] * ex.taps[1] for ex in phases)
    if superpack.shape[0] != total_taps * c:
        raise ValueError(f"superpack has {superpack.shape[0]} rows, the "
                         f"phases need {total_taps}·{c}")
    if sum(ex.out_hw[0] * ex.out_hw[1] for ex in phases) != sum_uv \
            or sum_uv != out_hw[0] * out_hw[1] \
            or len({ex.q for ex in phases}) != len(phases):
        raise ValueError("the phases do not partition the output")
    sh, sw = strides
    for ex in phases:
        u, v = ex.out_hw
        if u * v and (ex.q[0] + sh * (u - 1) >= out_hw[0]
                      or ex.q[1] + sw * (v - 1) >= out_hw[1]):
            raise ValueError(f"phase {ex.q} writes outside {out_hw}")
        if u * v and ex.taps[0] * ex.taps[1] and (
                ex.xoff[0] + ex.taps[0] - 1 + u > xg.shape[1]
                or ex.xoff[1] + ex.taps[1] - 1 + v > xg.shape[2]
                or min(ex.xoff) < 0):
            raise ValueError(f"phase {ex.q} reads outside the plane "
                             f"{tuple(xg.shape[1:3])}")


def untangled_deconv2d(xg: torch.Tensor, superpack: torch.Tensor, *,
                       phases: Sequence, out_hw: Pair, strides: Pair,
                       sum_uv: int, out_dtype=None,
                       scales: torch.Tensor | None = None) -> torch.Tensor:
    """Fused transposed conv: ONE kernel launch for all s_h·s_w phases.

    xg: (B, Hg, Wg, C) globally padded plane; superpack: (ΣT·C, N) tap-major
    phase sub-kernels (``ConvPlan.pack``); ``phases`` the plan's
    ``PhaseExec`` records.  ``scales`` ((ΣT·C, 1) f32) marks ``superpack``
    as int8 codes (a ``QuantizedSuperpack``'s ``q``) and takes the int8
    entry.  Returns (B, out_h, out_w, N), written interleaved by the
    kernel.  CUDA tensors launch the kernel (float32 plane, contiguous, no
    grad) and count one in ``untangled_deconv2d.launches`` (f32) or
    ``.launches_int8``; CPU tensors run ``untangled_deconv2d_ref``."""
    phases = tuple(phases)
    out_dtype = out_dtype or xg.dtype
    _check(xg, superpack, phases, out_hw, strides, sum_uv)
    if xg.device.type == "cpu" and superpack.device.type == "cpu":
        return untangled_deconv2d_ref(xg, superpack, phases=phases,
                                      out_hw=out_hw, strides=strides,
                                      sum_uv=sum_uv, out_dtype=out_dtype,
                                      scales=scales)
    if xg.device.type != "cuda" or superpack.device != xg.device:
        raise ValueError(f"kernel A needs both operands on one CUDA device, "
                         f"got {xg.device} and {superpack.device}")
    if xg.requires_grad or superpack.requires_grad or (
            scales is not None and scales.requires_grad):
        raise NotImplementedError(
            "kernel A has no backward of its own: differentiate through "
            "ConvPlan.apply (its autograd Function runs _pt_bwd)")
    if xg.dtype != torch.float32:
        raise TypeError(f"kernel A takes a float32 xg, got {xg.dtype}")
    _check_weights("kernel A", superpack, scales)
    for name, t in (("xg", xg), ("superpack", superpack)):
        if not t.is_contiguous():
            raise ValueError(f"kernel A takes a contiguous {name}")
    if out_dtype != torch.float32:
        raise TypeError(f"kernel A writes float32, asked for {out_dtype}")
    b, hg, wg, c = xg.shape
    n = superpack.shape[1]
    oh, ow = out_hw
    y = torch.empty((b, oh, ow, n), dtype=torch.float32, device=xg.device)
    if max(xg.numel(), superpack.numel(), y.numel()) > _INT32_MAX:
        raise ValueError("kernel A indexes with int32: tensor too large")
    if y.numel() == 0:
        return y
    config = _pick_config(n, [b * ex.out_hw[0] * ex.out_hw[1]
                              for ex in phases])
    bm, bn = _CONFIGS[config]
    grid_m = sum(-(-b * ex.out_hw[0] * ex.out_hw[1] // bm) for ex in phases)
    vec = _vec_ok(c, n, (xg, superpack, y))
    table = _phase_table(phases, xg.device)
    weights = (superpack.data_ptr(),) if scales is None else (
        superpack.data_ptr(), scales.data_ptr())
    with torch.cuda.device(xg.device):
        stream = torch.cuda.current_stream(xg.device).cuda_stream
        rc = _entry(scales is not None)(
            xg.data_ptr(), *weights, table.data_ptr(), y.data_ptr(), b, hg,
            wg, c, n, oh, ow, strides[0], strides[1], len(phases), config,
            vec, grid_m, -(-n // bn), stream)
    if rc != 0:
        raise RuntimeError(f"kernel A launch failed: cudaError {rc}")
    if scales is None:
        untangled_deconv2d.launches += 1
    else:
        untangled_deconv2d.launches_int8 += 1
    return y


untangled_deconv2d.launches = 0
untangled_deconv2d.launches_int8 = 0


# ---------------------------------------------------------------------------
# kernel B: the single (strided / dilated) correlation on the superpack
# ---------------------------------------------------------------------------

def single_out_hw(hp: int, wp: int, taps_hw: Pair, strides: Pair,
                  rhs_dilation: Pair) -> Pair:
    """Output extent of the valid correlation of a pre-padded plane."""
    (r, s), (sh, sw), (dh, dw) = taps_hw, strides, rhs_dilation
    return ((hp - (r - 1) * dh - 1) // sh + 1,
            (wp - (s - 1) * dw - 1) // sw + 1)


def untangled_conv2d_superpack_ref(x: torch.Tensor, superpack: torch.Tensor,
                                   *, taps_hw: Pair, strides: Pair = (1, 1),
                                   rhs_dilation: Pair = (1, 1),
                                   out_dtype=None,
                                   scales=None) -> torch.Tensor:
    """Plain PyTorch version of kernel B: per tap (m, n), the plane view at
    ``(oh·s_h + m·d_h, ow·s_w + n·d_w)`` times superpack rows
    ``[(m·S + n)·C, (m·S + n + 1)·C)``, accumulated in f32.  With
    ``scales`` the superpack is int8 codes, dequantized first."""
    c = x.shape[3]
    r, s = taps_hw
    (sh, sw), (dh, dw) = strides, rhs_dilation
    oh, ow = single_out_hw(x.shape[1], x.shape[2], taps_hw, strides,
                           rhs_dilation)
    x32, w32 = x.float(), _weights_f32(superpack, scales)
    acc = None
    for m in range(r):
        for n in range(s):
            xs = x32[:, m * dh:m * dh + (oh - 1) * sh + 1:sh,
                     n * dw:n * dw + (ow - 1) * sw + 1:sw, :]
            row = (m * s + n) * c
            term = torch.matmul(xs, w32[row:row + c])
            acc = term if acc is None else acc + term
    return acc.to(out_dtype or x.dtype)


# the C entries' parameters, as for kernel A
_CONV_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 17
                  + [ctypes.c_void_p])
_CONV_ARGTYPES_I8 = [ctypes.c_void_p] + _CONV_ARGTYPES


@functools.cache
def _conv_entry(int8: bool = False):
    if int8:
        return _bind("untangled_conv", "untangled_conv2d_i8",
                     _CONV_ARGTYPES_I8)
    return _bind("untangled_conv", "untangled_conv2d_f32", _CONV_ARGTYPES)


def untangled_conv2d_superpack(x: torch.Tensor, superpack: torch.Tensor, *,
                               taps_hw: Pair, strides: Pair = (1, 1),
                               rhs_dilation: Pair = (1, 1), out_dtype=None,
                               scales: torch.Tensor | None = None
                               ) -> torch.Tensor:
    """ONE launch of the valid (pre-padded) untangled correlation.

    x: (B, Hp, Wp, C) padded plane; superpack: (R·S·C, N) tap-major
    (``ConvPlan.pack``).  Strided and dilated kinds run the same kernel:
    dilation only moves each tap's read origin.  ``scales`` ((R·S·C, 1)
    f32) marks ``superpack`` as int8 codes and takes the int8 entry.
    Returns (B, OH, OW, N).  CUDA tensors launch the kernel (float32 plane,
    contiguous, no grad) and count one in
    ``untangled_conv2d_superpack.launches`` (f32) or ``.launches_int8``;
    CPU tensors run ``untangled_conv2d_superpack_ref``."""
    if x.dim() != 4 or superpack.dim() != 2:
        raise ValueError(f"want x (B, Hp, Wp, C) and superpack (R·S·C, N), "
                         f"got {tuple(x.shape)} and {tuple(superpack.shape)}")
    b, hp, wp, c = x.shape
    r, s = taps_hw
    n = superpack.shape[1]
    if superpack.shape[0] != r * s * c:
        raise ValueError(f"superpack has {superpack.shape[0]} rows, taps "
                         f"{taps_hw} need {r}·{s}·{c}")
    oh, ow = single_out_hw(hp, wp, taps_hw, strides, rhs_dilation)
    if oh <= 0 or ow <= 0 or min(*strides, *rhs_dilation) < 1:
        raise ValueError(f"no valid output: plane {hp}x{wp}, taps "
                         f"{taps_hw}, strides {strides}, dilation "
                         f"{rhs_dilation}")
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu" and superpack.device.type == "cpu":
        return untangled_conv2d_superpack_ref(
            x, superpack, taps_hw=taps_hw, strides=strides,
            rhs_dilation=rhs_dilation, out_dtype=out_dtype, scales=scales)
    if x.device.type != "cuda" or superpack.device != x.device:
        raise ValueError(f"kernel B needs both operands on one CUDA device, "
                         f"got {x.device} and {superpack.device}")
    if x.requires_grad or superpack.requires_grad or (
            scales is not None and scales.requires_grad):
        raise NotImplementedError(
            "kernel B has no backward of its own: differentiate through "
            "ConvPlan.apply (its autograd Function runs _ps_bwd)")
    if x.dtype != torch.float32:
        raise TypeError(f"kernel B takes a float32 x, got {x.dtype}")
    _check_weights("kernel B", superpack, scales)
    for name, t in (("x", x), ("superpack", superpack)):
        if not t.is_contiguous():
            raise ValueError(f"kernel B takes a contiguous {name}")
    if out_dtype != torch.float32:
        raise TypeError(f"kernel B writes float32, asked for {out_dtype}")
    y = torch.empty((b, oh, ow, n), dtype=torch.float32, device=x.device)
    if max(x.numel(), superpack.numel(), y.numel()) > _INT32_MAX:
        raise ValueError("kernel B indexes with int32: tensor too large")
    if y.numel() == 0:
        return y
    config = _pick_config(n, [b * oh * ow])
    bm, bn = _CONFIGS[config]
    vec = _vec_ok(c, n, (x, superpack, y))
    weights = (superpack.data_ptr(),) if scales is None else (
        superpack.data_ptr(), scales.data_ptr())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _conv_entry(scales is not None)(
            x.data_ptr(), *weights, y.data_ptr(), b, hp, wp, c, n, oh, ow,
            r, s, strides[0], strides[1], rhs_dilation[0], rhs_dilation[1],
            config, vec, -(-(b * oh * ow) // bm), -(-n // bn), stream)
    if rc != 0:
        raise RuntimeError(f"kernel B launch failed: cudaError {rc}")
    if scales is None:
        untangled_conv2d_superpack.launches += 1
    else:
        untangled_conv2d_superpack.launches_int8 += 1
    return y


untangled_conv2d_superpack.launches = 0
untangled_conv2d_superpack.launches_int8 = 0


def untangled_conv2d(x: torch.Tensor, kernel: torch.Tensor, *,
                     strides: Pair = (1, 1), rhs_dilation: Pair = (1, 1),
                     out_dtype=None) -> torch.Tensor:
    """Valid (pre-padded) untangled correlation with an HWIO kernel
    (R, S, C, N): flattens it into the tap-major superpack (free, same
    memory order) and runs ``untangled_conv2d_superpack``."""
    r, s, c, n = kernel.shape
    if c != x.shape[-1]:
        raise ValueError(f"channel mismatch {x.shape[-1]} vs {c}")
    return untangled_conv2d_superpack(
        x, kernel.reshape(r * s * c, n), taps_hw=(r, s), strides=strides,
        rhs_dilation=rhs_dilation, out_dtype=out_dtype)
