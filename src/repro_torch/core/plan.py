"""Plan/executor engine for every conv kind, on PyTorch.

Counterpart of ``repro.core.plan``.  A convolution site is described by a
hashable ``ConvSpec``, compiled once by ``plan_conv`` (LRU-cached) into a
``ConvPlan`` that holds the geometry (the transposed kind's output phases,
or the single phase of a strided/dilated correlation), the tap-major
superpack layout and one ``Route`` per batch bucket.  ``ConvPlan.apply``
runs the planned forward on the superpack.

Backend policy (``ConvSpec.backend``), the port's reading of JAX's
``'xla' | 'pallas' | 'auto'``:

* ``'torch'`` — the route heuristic of the JAX ``'xla'`` policy, every
  route a plain PyTorch product (transposed: ``fused_tap``,
  ``fused_plane``, ``pixel_shuffle``, ``taps``; single: ``fused_tap``,
  ``taps``).  These are the CPU path and the parity partners of the kernels.
* ``'cuda'``  — every site takes the ``'cuda'`` route at every bucket: one
  launch of the hand-written kernel of its kind (transposed: the fused
  multi-phase ``untangled_deconv2d``; conv/dilated: the single-correlation
  ``untangled_conv2d_superpack``).  Where the reference's ``'pallas'``
  policy takes its spatially tiled kernel, the route carries ``sp_tiles``,
  the output tile of one thread block, and the launch is the tiled kernel
  (C or D) instead of the whole-plane one (B or A).  That verdict is the
  reference's own (``_single_tiled_verdict``,
  ``_transposed_tiled_verdict``), so both packages tile the same (site,
  bucket) cells; the tile is the card's (``pick_block_tile_*``).
* ``'auto'``  — ``'cuda'`` when a card is present, else ``'torch'``.

``plan_conv(spec, autotune=AutotunePolicy(...))`` replaces these
heuristic routes by measured winners (``core.autotune``), which may also be
the transposed kind's ``'per_phase'`` route: the pre-fusion executor, one
pad and product chain per phase (on 'cuda' each live phase is one launch
of kernel B, or of kernel C where the reference tiles the phase's plane,
on an int8 plan's codes through their int8 entries).

Every route of both kinds differentiates through the paper's §3.2.3
backward, as JAX's custom VJPs do: ``apply`` goes through the autograd
Functions ``_PlannedTransposed`` / ``_PlannedSingle``, whose forward runs
the route on detached inputs (the kernel wrappers refuse tensors that
require grad) and whose backward is ``_pt_bwd`` / ``_ps_bwd``, plain
products on the superpack as in JAX.

``ConvSpec.wdtype='int8'`` stores the weights as a ``QuantizedSuperpack``
(int8 codes in the superpack's row order and one f32 scale per row).  The
torch routes read it dequantized (``_deq``), the 'cuda' route hands codes
and scales to the kernels' int8 entries (kernel E inside A-D), and the
backward gives the scale column its closed-form gradient.  Route paths
do not depend on ``wdtype``; the tiled verdict counts int8 weights at one
byte, as the reference's does.
"""
from __future__ import annotations

import dataclasses
import functools
import sys
import time
from typing import Sequence

import torch
from torch.autograd.function import once_differentiable

from repro_torch.core import decompose as dec
from repro_torch.core.untangle import pad_or_crop, untangled_conv2d
from repro_torch.kernels.untangled_conv import (
    deconv_tap_span, halo_extent, pick_block_tile_single,
    pick_block_tile_transposed, untangled_conv2d_superpack,
    untangled_deconv2d)
from repro_torch.runtime.compress import dequantize_int8, quantize_int8_rows

Pair = tuple[int, int]

# per-phase fallback: concatenate tap views into one GEMM when the phase
# output has too few rows to amortize per-tap products
_FUSE_MAX_ROWS = 128

# batch buckets every plan sizes a route for at build time; serving pads
# each request batch up to the nearest bucket
BATCH_BUCKETS = (1, 4, 16, 64)

# whole-conv torch route heuristic: take the plane GEMM when its FLOP
# overhead Hg*Wg*ΣT / Σ u·v·T stays below this
_PLANE_RATIO_MAX = 1.6
# cap of the (per-bucket) f32 plane-GEMM / tap-stack intermediate
_PLANE_BYTES_MAX = 64 * 1024 * 1024

_BACKENDS = ("auto", "torch", "cuda")
_DTYPES = ("float32", "bfloat16", "float16")
_WDTYPES = ("float32", "int8")

# The budget the reference's tile searches fit against (``repro.core.plan
# ._VMEM_BUDGET``).  It reproduces the reference's whole-plane/tiled
# verdict, so both packages tile the same (site, bucket) cells; it is not a
# limit of this card, whose kernels gather from device memory.  The tile a
# tiled route carries is the card's own (``pick_block_tile_*``).
_REF_VMEM_BUDGET = 12 * 1024 * 1024


def norm_padding(padding, k_hw) -> tuple[Pair, Pair]:
    """Normalize 'SAME'/'VALID'/int-pair/nested paddings to ((lo,hi),(lo,hi))."""
    if isinstance(padding, str):
        r, s = k_hw
        if padding.upper() == "SAME":
            return ((r // 2, (r - 1) // 2), (s // 2, (s - 1) // 2))
        if padding.upper() == "VALID":
            return ((0, 0), (0, 0))
        raise ValueError(padding)
    (a, b) = padding
    if isinstance(a, int):
        return ((a, a), (b, b))
    return (tuple(a), tuple(b))


def dtype_name(dtype) -> str:
    """'float32'-style name of a torch / numpy dtype or a dtype string."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return str(getattr(dtype, "name", dtype))


# ---------------------------------------------------------------------------
# the reference's tiled verdict: integer copies of repro.core.plan's tile
# searches and repro.kernels.untangled_conv's working-set estimates
# ---------------------------------------------------------------------------

def _weight_tile_bytes(total_taps, c_tile, n_tile, itemsize, witemsize):
    """Superpack-tile bytes: ``witemsize`` per weight (1 for int8, which
    also carries its f32 scale column), or the activation itemsize."""
    if witemsize is None:
        witemsize = itemsize
    bytes_ = witemsize * total_taps * c_tile * n_tile
    if witemsize != itemsize:
        bytes_ += 4 * total_taps * c_tile
    return bytes_


def vmem_bytes_estimate(hp, wp, c_tile, r, s, n_tile, oh, ow, itemsize=4,
                        witemsize=None):
    """The reference's whole-plane working set, (r, s) form."""
    return vmem_bytes_estimate_superpack(hp, wp, c_tile, r * s, n_tile,
                                         oh, ow, itemsize, witemsize)


def vmem_bytes_estimate_fused(hg, wg, c_tile, total_taps, n_tile, sum_uv,
                              oh, ow, itemsize=4, witemsize=None):
    """The reference's fused multi-phase working set: plane + superpack
    tile + interleaved output + the f32 per-phase accumulator."""
    return itemsize * (hg * wg * c_tile + oh * ow * n_tile) \
        + _weight_tile_bytes(total_taps, c_tile, n_tile, itemsize,
                             witemsize) \
        + 4 * sum_uv * n_tile


def vmem_bytes_estimate_superpack(hp, wp, c_tile, total_taps, n_tile,
                                  oh, ow, itemsize=4, witemsize=None):
    """The reference's single-correlation whole-plane working set."""
    return itemsize * (hp * wp * c_tile + oh * ow * n_tile) \
        + _weight_tile_bytes(total_taps, c_tile, n_tile, itemsize,
                             witemsize) \
        + 4 * oh * ow * n_tile


def vmem_bytes_estimate_tiled(tin_h, tin_w, c_tile, total_taps, n_tile,
                              acc_rows, itemsize=4, witemsize=None):
    """The reference's tiled working set: the halo tile twice (double
    buffer), the superpack tile, the output block and its f32
    accumulator."""
    return itemsize * (2 * tin_h * tin_w * c_tile + acc_rows * n_tile) \
        + _weight_tile_bytes(total_taps, c_tile, n_tile, itemsize,
                             witemsize) \
        + 4 * acc_rows * n_tile


_TILE_CANDS = (256, 128, 64, 32, 16, 8)


def _tile_pairs(c, n):
    """The reference's (C_t, N_t) search order: N_t first, both clipped."""
    for n_t in _TILE_CANDS:
        for c_t in _TILE_CANDS:
            if c_t > max(c, 8) * 2 or n_t > max(n, 8) * 2:
                continue
            yield min(c_t, c), min(n_t, n)


def pick_vmem_tiles(hp, wp, c, n, r, s, oh, ow, itemsize, witemsize=None):
    """The reference's whole-plane (C_t, N_t), or None when no tile fits."""
    for c_t, n_t in _tile_pairs(c, n):
        if vmem_bytes_estimate(hp, wp, c_t, r, s, n_t, oh, ow, itemsize,
                               witemsize=witemsize) <= _REF_VMEM_BUDGET:
            return c_t, n_t
    return None


def pick_fused_tiles(hg, wg, c, n, total_taps, sum_uv, oh, ow, itemsize,
                     witemsize=None):
    """The reference's fused multi-phase (C_t, N_t), or None."""
    for c_t, n_t in _tile_pairs(c, n):
        if vmem_bytes_estimate_fused(
                hg, wg, c_t, total_taps, n_t, sum_uv, oh, ow, itemsize,
                witemsize=witemsize) <= _REF_VMEM_BUDGET:
            return c_t, n_t
    return None


def _spatial_cands(extent: int) -> tuple[int, ...]:
    """Output-tile size candidates along one dim, descending, clipped."""
    return tuple(dict.fromkeys(min(t, extent) for t in (128, 64, 32, 16, 8)))


def pick_tiled_single(c, n, r, s, oh, ow, strides, dilation, itemsize,
                      witemsize=None):
    """The reference's tiled single-correlation (C_t, N_t, (T_oh, T_ow)),
    or None."""
    (sh, sw), (dh, dw) = strides, dilation
    for c_t, n_t in _tile_pairs(c, n):
        for toh in _spatial_cands(oh):
            for tow in _spatial_cands(ow):
                if vmem_bytes_estimate_tiled(
                        halo_extent(toh, r, sh, dh),
                        halo_extent(tow, s, sw, dw), c_t, r * s, n_t,
                        toh * tow, itemsize,
                        witemsize=witemsize) <= _REF_VMEM_BUDGET:
                    return c_t, n_t, (toh, tow)
    return None


def pick_tiled_transposed(c, n, total_taps, phases, itemsize,
                          witemsize=None):
    """The reference's tiled multi-phase (C_t, N_t, (T_u, T_v)), or None.
    Uniform-phase plans only."""
    uu, vv = phases[0].out_hw
    ((mh, xh_max), (mw, xw_max)) = deconv_tap_span(phases)
    for c_t, n_t in _tile_pairs(c, n):
        for tu in _spatial_cands(uu):
            for tv in _spatial_cands(vv):
                if vmem_bytes_estimate_tiled(
                        xh_max - mh + tu, xw_max - mw + tv, c_t,
                        total_taps, n_t, len(phases) * tu * tv, itemsize,
                        witemsize=witemsize) <= _REF_VMEM_BUDGET:
                    return c_t, n_t, (tu, tv)
    return None


def _single_tiled_verdict(spec, hp: int, wp: int, out_hw: Pair) -> bool:
    """Whether the reference's 'pallas' policy takes its tiled kernel for
    this single-correlation site: the whole plane does not fit, a tile
    does.  Independent of the batch, as the reference's is."""
    r, s = spec.kernel_hw
    c, n = spec.in_c, spec.out_c
    itemsize, witemsize = _itemsize(spec), _weight_itemsize(spec)
    if pick_vmem_tiles(hp, wp, c, n, r, s, *out_hw, itemsize,
                       witemsize=witemsize) is not None:
        return False
    dil = spec.dilation if spec.kind == "dilated" else (1, 1)
    return pick_tiled_single(c, n, r, s, *out_hw, spec.strides, dil,
                             itemsize, witemsize=witemsize) is not None


def _transposed_tiled_verdict(spec, hg: int, wg: int, out_hw: Pair,
                              total_taps: int, sum_uv: int, uniform: bool,
                              phases) -> bool:
    """The same for a transposed site: the fused kernel does not fit, the
    phases are uniform with ``out % stride == 0``, and a tile fits."""
    c, n = spec.in_c, spec.out_c
    itemsize, witemsize = _itemsize(spec), _weight_itemsize(spec)
    if pick_fused_tiles(hg, wg, c, n, total_taps, sum_uv, *out_hw, itemsize,
                        witemsize=witemsize) is not None:
        return False
    if not (uniform and out_hw[0] % spec.strides[0] == 0
            and out_hw[1] % spec.strides[1] == 0):
        return False
    return pick_tiled_transposed(c, n, total_taps, phases, itemsize,
                                 witemsize=witemsize) is not None


# ---------------------------------------------------------------------------
# spec
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """Hashable description of one convolution site — the plan-cache key.
    Fields match ``repro.core.plan.ConvSpec`` one for one."""

    kind: str                     # 'transposed' | 'conv' | 'dilated'
    in_hw: Pair                   # input spatial (H, W)
    in_c: int
    out_c: int
    kernel_hw: Pair               # (R, S)
    strides: Pair = (1, 1)
    padding: tuple[Pair, Pair] = ((0, 0), (0, 0))
    dilation: Pair = (1, 1)
    dtype: str = "float32"
    backend: str = "auto"         # 'auto' | 'torch' | 'cuda'
    spatial: Pair = (1, 1)        # device tiling: only (1, 1) is ported
    # weight *storage* dtype: 'float32' (dense superpack) or 'int8' (the
    # quantized superpack: ``pack`` emits a ``QuantizedSuperpack``).
    # Activations and accumulation stay ``dtype``/f32 regardless
    wdtype: str = "float32"


def conv_spec(kind: str, x_shape: Sequence[int], kernel_shape: Sequence[int],
              *, strides=(1, 1), padding=((0, 0), (0, 0)), dilation=(1, 1),
              dtype=None, backend: str = "auto",
              spatial: Pair = (1, 1), wdtype: str = "float32") -> ConvSpec:
    """Build a normalized (cache-canonical) spec from array shapes."""
    r, s, c, n = kernel_shape
    if x_shape[-1] != c:
        raise ValueError(f"channel mismatch {x_shape[-1]} vs {c}")
    return ConvSpec(
        kind=kind, in_hw=(int(x_shape[-3]), int(x_shape[-2])),
        in_c=int(c), out_c=int(n), kernel_hw=(int(r), int(s)),
        strides=tuple(int(v) for v in strides),
        padding=norm_padding(padding, (r, s)),
        dilation=tuple(int(v) for v in dilation),
        dtype=dtype_name(dtype) if dtype is not None else "float32",
        backend=backend, spatial=tuple(int(v) for v in spatial),
        wdtype=str(wdtype))


def _itemsize(spec: ConvSpec) -> int:
    """Bytes per activation element of the spec's dtype."""
    return torch.empty((), dtype=getattr(torch, spec.dtype)).element_size()


def _weight_itemsize(spec: ConvSpec) -> int:
    """Bytes per stored weight element: 1 for the int8 superpack (its f32
    scale rows are counted apart), the activation itemsize otherwise."""
    return 1 if spec.wdtype == "int8" else _itemsize(spec)


@dataclasses.dataclass(eq=False)
class QuantizedSuperpack:
    """The int8 superpack: the tap-major weight buffer quantized per row.

    ``q`` is the ``(rows, N)`` int8 buffer in the exact row order of the f32
    superpack (transposed: phase-concatenated taps; conv/dilated: tap
    ``t = m·S + n`` owns rows ``[t·C, (t+1)·C)``); ``scale`` is the f32
    ``(rows, 1)`` column of per-row scales riding with it, so slicing rows
    of both yields a dequantizable panel at any plan-time offset.  Scales
    come from ``runtime.compress.quantize_int8_rows``, which bounds the
    per-element weight error by ``0.5·scale[row]``."""

    q: torch.Tensor               # (rows, N) int8
    scale: torch.Tensor           # (rows, 1) f32

    @property
    def shape(self):
        return self.q.shape

    def dequant(self) -> torch.Tensor:
        """The f32 superpack: ``q · scale`` row by row."""
        return dequantize_int8(self.q, self.scale)

    def nbytes(self) -> int:
        """Stored bytes: 1 per code plus 4 per scale row."""
        return self.q.numel() + 4 * self.scale.numel()

    def to(self, device) -> "QuantizedSuperpack":
        return QuantizedSuperpack(self.q.to(device), self.scale.to(device))


# ---------------------------------------------------------------------------
# per-phase execution record + routes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PhaseExec:
    """Plan-time geometry record for one output phase.

    ``tap_off`` rows (in taps) into the superpack, ``acc_off`` rows (in
    output pixels) into the TPU kernel's accumulator (kept so plans compare
    field by field with JAX's), ``xoff`` the phase's tap origin inside the
    globally padded plane.
    """

    key: str                      # legacy per-phase pytree key (checkpoints)
    q: Pair                       # (q_h, q_w) output phase
    rho: Pair                     # first kernel tap per dim
    taps: Pair                    # (T_h, T_w) sub-kernel extent
    pad: tuple[Pair, Pair]        # input pad/crop for this phase's stride-1 conv
    out_hw: Pair                  # (U, V) phase output extent
    tap_off: int = 0              # taps preceding this phase in the superpack
    acc_off: int = 0              # U·V rows preceding this phase
    xoff: Pair = (0, 0)           # tap origin in the globally padded plane


@dataclasses.dataclass(frozen=True)
class Route:
    """One batch bucket's execution decision, fixed at plan time.

    ``path`` is 'cuda' (the hand-written kernel) or one of the torch routes
    'fused_plane' | 'fused_tap' | 'pixel_shuffle' | 'taps', or (transposed,
    from autotuning only) 'per_phase'.  ``tiles`` is
    ``None``: the kernel picks its block tile from the call's shapes.
    ``fused_bwd`` picks the single kind's backward form (one wide GEMM vs
    per-tap products).  ``sp_tiles`` is set on a 'cuda' route where the
    reference tiles the plane: the spatial output tile one thread block of
    the tiled kernel computes, ``(T_oh, T_ow)`` output pixels (kernel C) or
    ``(T_u, T_v)`` phase-output pixels (kernel D); ``None`` is the
    whole-plane kernel.  ``dev_tiles`` keeps JAX's schema and is never set
    (device tiling is not ported)."""

    batch: int
    path: str
    tiles: Pair | None
    fused_bwd: bool = True
    sp_tiles: Pair | None = None
    dev_tiles: Pair | None = None


def _want_cuda(backend: str) -> bool:
    return backend == "cuda" or (backend == "auto"
                                 and torch.cuda.is_available())


def _pixel_shuffle_geom(spec: ConvSpec,
                        phases) -> tuple[Pair, tuple[Pair, Pair]] | None:
    """The sub-pixel rewrite's shared stride-1 footprint, or ``None``.

    Eligible when every phase shares output extent ``(U, V) == (H, W)``,
    tap extent and input pad (k % s == 0 'SAME' geometry, e.g. k=4 s=2)."""
    if not phases:
        return None
    first = phases[0]
    th, tw = first.taps
    if th == 0 or tw == 0:
        return None
    if first.out_hw != spec.in_hw:
        return None
    for ex in phases[1:]:
        if (ex.taps != first.taps or ex.pad != first.pad
                or ex.out_hw != first.out_hw):
            return None
    return first.taps, first.pad


def _pixel_shuffle_route(spec: ConvSpec, phases, batch: int) -> Route | None:
    """'pixel_shuffle' at one bucket: the spec admits the rewrite and the
    bucket's f32 tap-stack buffer clears the plane-bytes cap."""
    geom = _pixel_shuffle_geom(spec, phases)
    if geom is None:
        return None
    (th, tw), _ = geom
    h, w = spec.in_hw
    if 4 * batch * th * tw * h * w * spec.in_c > _PLANE_BYTES_MAX:
        return None
    return Route(batch, "pixel_shuffle", None)


def _transposed_route_1dev(spec: ConvSpec, hg: int, wg: int, out_hw: Pair,
                           total_taps: int, sum_uv: int, sum_uvt: int,
                           uniform: bool, phases, batch: int) -> Route:
    """Whole-conv route for the transposed kind at one batch bucket: on
    'cuda', kernel D with the card's tile where the reference tiles,
    else kernel A."""
    if _want_cuda(spec.backend):
        sp = None
        if total_taps and _transposed_tiled_verdict(
                spec, hg, wg, out_hw, total_taps, sum_uv, uniform, phases):
            sp = pick_block_tile_transposed(phases, spec.out_c)
        return Route(batch, "cuda", None, sp_tiles=sp)
    ps = _pixel_shuffle_route(spec, phases, batch)
    if ps is not None:
        return ps
    plane_ratio = hg * wg * total_taps / max(1, sum_uvt)
    plane_bytes = 4 * batch * hg * wg * total_taps * spec.out_c
    if plane_ratio <= _PLANE_RATIO_MAX and plane_bytes <= _PLANE_BYTES_MAX:
        return Route(batch, "fused_plane", None)
    if uniform:
        return Route(batch, "fused_tap", None)
    return Route(batch, "taps", None)


def _single_route_1dev(spec: ConvSpec, hp: int, wp: int, out_hw: Pair,
                       batch: int) -> Route:
    """Whole-conv route for the single-correlation kinds at one bucket; on
    'cuda', kernel C with the card's tile where the reference tiles the
    ``hp x wp`` padded plane, else kernel B.

    ``fused_ok`` caps the f32 tap-stack buffer B·OH·OW·R·S·C that the
    ``fused_tap`` forward and the fused backward materialize; it is the
    ``fused_bwd`` verdict of every row, the 'cuda' ones included (JAX's
    'pallas' rows carry the same one), so the backward takes the same form
    on both packages."""
    r, s = spec.kernel_hw
    oh, ow = out_hw
    fused_ok = 4 * batch * oh * ow * r * s * spec.in_c <= _PLANE_BYTES_MAX
    if _want_cuda(spec.backend):
        sp = None
        if _single_tiled_verdict(spec, hp, wp, out_hw):
            dil = spec.dilation if spec.kind == "dilated" else (1, 1)
            sp = pick_block_tile_single(out_hw, spec.kernel_hw, spec.strides,
                                        dil, spec.out_c)
        return Route(batch, "cuda", None, fused_bwd=fused_ok, sp_tiles=sp)
    if fused_ok:
        return Route(batch, "fused_tap", None, fused_bwd=True)
    return Route(batch, "taps", None, fused_bwd=False)


def _route_exact(plan: "ConvPlan", batch: int) -> Route:
    """Re-run the plan-time route choice for an exact (bucket-less) batch."""
    spec = plan.spec
    h, w = spec.in_hw
    if spec.kind != "transposed":
        (ph, pw) = spec.padding
        return _single_route_1dev(spec, h + ph[0] + ph[1], w + pw[0] + pw[1],
                                  plan.out_hw, batch)
    (glh, ghh), (glw, ghw) = plan.gpad
    sum_uvt = sum(ex.out_hw[0] * ex.out_hw[1] * ex.taps[0] * ex.taps[1]
                  for ex in plan.phases)
    return _transposed_route_1dev(
        spec, h + glh + ghh, w + glw + ghw, plan.out_hw, plan.total_taps,
        plan.sum_uv, sum_uvt, plan.uniform, plan.phases, batch)


# ---------------------------------------------------------------------------
# plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class ConvPlan:
    """Compiled execution plan (identity-hashable cache singleton)."""

    spec: ConvSpec
    out_hw: Pair
    phases: tuple[PhaseExec, ...]          # len 1 for 'conv'/'dilated'
    gpad: tuple[Pair, Pair] | None         # transposed: single global pad
    total_taps: int                        # Σ_q T_h·T_w (superpack rows / C)
    sum_uv: int                            # Σ_q U·V
    uniform: bool                          # all phases share (U, V)
    bwd_pad: tuple[Pair, Pair] | None      # transposed: dy pad for dx/dK
    dx_taps: tuple[tuple, ...] | None      # (m, n, superpack row) schedule
    routes: tuple[Route, ...] = ()         # one per BATCH_BUCKETS, ascending
    build_ms: float = 0.0
    tuned: bool = False                    # routes from autotune, not heuristics
    _xl_routes: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def path(self) -> str:
        """The B=1 bucket's path."""
        return self.routes[0].path

    def route_for_batch(self, batch: int) -> Route:
        """The route of the smallest bucket that fits ``batch``; a batch
        beyond the largest bucket gets an exactly-sized, memoized route."""
        for r in self.routes:
            if batch <= r.batch:
                return r
        if batch not in self._xl_routes:
            self._xl_routes[batch] = _route_exact(self, batch)
        return self._xl_routes[batch]

    def with_routes(self, routes: tuple[Route, ...],
                    tuned: bool = True) -> "ConvPlan":
        """A sibling plan sharing the geometry with a replaced route table
        (how the autotuner installs measured winners and tests force a
        route), with an empty oversize-batch memo."""
        return ConvPlan(
            spec=self.spec, out_hw=self.out_hw, phases=self.phases,
            gpad=self.gpad, total_taps=self.total_taps, sum_uv=self.sum_uv,
            uniform=self.uniform, bwd_pad=self.bwd_pad, dx_taps=self.dx_taps,
            routes=tuple(routes), build_ms=self.build_ms, tuned=tuned)

    # -- weight layout -----------------------------------------------------
    def pack(self, kernel: torch.Tensor):
        """Kernel (R,S,C,N) -> the superpack, row for row
        ``repro.core.plan.ConvPlan.pack``'s.  'transposed': ``(Σ_q
        T_h·T_w·C, N)``, every phase sub-kernel flattened tap-major and
        concatenated in phase order.  'conv'/'dilated': the free tap-major
        flatten ``(R·S·C, N)`` (tap ``t = m·S + n`` owns rows
        ``[t·C, (t+1)·C)``; dilation never changes the layout).
        ``wdtype='int8'`` specs return a ``QuantizedSuperpack`` of the same
        rows instead."""
        c, n = self.spec.in_c, self.spec.out_c
        if self.spec.kind != "transposed":
            r, s = self.spec.kernel_hw
            return self._maybe_quantize(kernel.reshape(r * s * c, n))
        subs = dec.decompose_kernel(kernel, self.spec.strides,
                                    self.spec.padding)
        return self._maybe_quantize(torch.cat(
            [subs[ex.q].reshape(ex.taps[0] * ex.taps[1] * c, n)
             for ex in self.phases if ex.taps[0] * ex.taps[1]],
            dim=0).contiguous())

    def _maybe_quantize(self, packed):
        """Float superpack -> ``QuantizedSuperpack`` when the spec stores
        int8 weights; a ``QuantizedSuperpack`` passes through."""
        if self.spec.wdtype != "int8" or isinstance(packed,
                                                    QuantizedSuperpack):
            return packed
        return QuantizedSuperpack(*quantize_int8_rows(packed))

    def as_superpack(self, packed):
        """Superpacks (dense or quantized) pass through.  Transposed: a
        legacy per-phase dict ({'q0x1': buf} or {(0, 1): buf}) is
        concatenated onto it.  'conv'/'dilated': a full 4-D HWIO kernel is
        flattened (free), and its gradient flows back 4-D.  ``wdtype='int8'``
        specs quantize any float layout they adapt."""
        if isinstance(packed, QuantizedSuperpack):
            return packed
        if not isinstance(packed, dict):
            if self.spec.kind != "transposed" and packed.dim() == 4:
                return self.pack(packed)
            return self._maybe_quantize(packed)
        segs = []
        for ex in self.phases:
            if ex.taps[0] * ex.taps[1] == 0:
                continue
            sub = packed[ex.key] if ex.key in packed else packed[ex.q]
            segs.append(sub.reshape(-1, self.spec.out_c))
        return self._maybe_quantize(torch.cat(segs, dim=0))

    def unpack(self, packed) -> torch.Tensor:
        """Superpack (or legacy dict / HWIO kernel) -> the full (R,S,C,N)
        kernel; exact inverse of ``pack`` for dense weights.  A
        ``QuantizedSuperpack`` dequantizes first, so it round-trips within
        one quantization step per element."""
        packed = _deq(self.as_superpack(packed))
        r, s = self.spec.kernel_hw
        c, n = self.spec.in_c, self.spec.out_c
        if self.spec.kind != "transposed":
            return packed.reshape(r, s, c, n)
        (sh, sw) = self.spec.strides
        kernel = packed.new_zeros((r, s, c, n))
        for ex in self.phases:
            th, tw = ex.taps
            if th * tw == 0:
                continue
            sub = packed[ex.tap_off * c:(ex.tap_off + th * tw) * c]
            kernel[ex.rho[0]::sh, ex.rho[1]::sw] = sub.reshape(th, tw, c, n)
        return kernel

    # -- execution ---------------------------------------------------------
    def apply(self, x: torch.Tensor, packed) -> torch.Tensor:
        """Planned forward of NHWC ``x`` on the superpack, differentiable
        through the §3.2.3 backward of the plan's kind."""
        if (tuple(x.shape[-3:-1]) != self.spec.in_hw
                or x.shape[-1] != self.spec.in_c):
            raise ValueError(
                f"input {tuple(x.shape[-3:])} does not match plan spec "
                f"{self.spec.in_hw + (self.spec.in_c,)} — plans bake geometry "
                f"at build time; plan_conv a spec for this shape")
        fn = (_PlannedTransposed if self.spec.kind == "transposed"
              else _PlannedSingle)
        packed = self.as_superpack(packed)
        if isinstance(packed, QuantizedSuperpack):
            # codes and scales as two inputs: autograd gives the scale its
            # gradient, the codes none
            return fn.apply(self, x, packed.q, packed.scale)
        return fn.apply(self, x, packed, None)

    __call__ = apply

    def apply_kernel(self, x: torch.Tensor, kernel: torch.Tensor):
        """Pack per call, then execute (the one-call engine API; the
        gradient reaches ``kernel`` through the differentiable pack)."""
        return self.apply(x, self.pack(kernel))

    def apply_per_phase(self, x: torch.Tensor, packed) -> torch.Tensor:
        """The pre-fusion per-phase executor (one pad and product chain per
        phase, then the interleave): the measurement baseline of the fused
        launch and a parity oracle.  It does not go through the §3.2.3
        autograd Function.  'conv'/'dilated' plans run ``apply``."""
        if self.spec.kind != "transposed":
            return self.apply(x, packed)
        return _transposed_per_phase(self, x, self.as_superpack(packed))


def plan_conv(spec: ConvSpec, autotune=None) -> ConvPlan:
    """Compile ``spec`` into a ``ConvPlan`` (LRU-cached per frozen spec).
    ``autotune``, a ``core.autotune.AutotunePolicy``, replaces the
    heuristic per-bucket routes by measured winners: cached ones where the
    route cache has them, microbenchmarks on a miss under
    ``mode='measure'``, the heuristic routes otherwise."""
    plan = _plan_conv_cached(spec)
    if autotune is None:
        return plan
    from repro_torch.core.autotune import AutotunePolicy, autotune_plan
    if not isinstance(autotune, AutotunePolicy):
        raise TypeError(f"autotune takes an AutotunePolicy or None, got "
                        f"{type(autotune).__name__}")
    return autotune_plan(plan, autotune)


def plan_cache_info():
    return _plan_conv_cached.cache_info()


def plan_cache_clear():
    """Drop every cached plan (after a test swaps a routing constant), and
    with them the tuned plans and loaded route caches built on them."""
    _plan_conv_cached.cache_clear()
    autotune = sys.modules.get("repro_torch.core.autotune")
    if autotune is not None:
        autotune.reset()


@functools.lru_cache(maxsize=4096)
def _plan_conv_cached(spec: ConvSpec) -> ConvPlan:
    t0 = time.perf_counter()
    if spec.kind not in ("transposed", "conv", "dilated"):
        raise ValueError(f"unknown conv kind {spec.kind!r}")
    if spec.backend not in _BACKENDS:
        raise ValueError(f"unknown backend {spec.backend!r} "
                         f"(supported: {_BACKENDS})")
    if spec.spatial != (1, 1):
        raise NotImplementedError(
            "plane-parallel plans are not ported yet (ROADMAP Queue 1, "
            "item 13)")
    if spec.wdtype not in _WDTYPES:
        raise ValueError(f"unsupported wdtype {spec.wdtype!r} "
                         f"(supported: {_WDTYPES})")
    if spec.dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {spec.dtype!r}")
    plan = (_plan_transposed(spec) if spec.kind == "transposed"
            else _plan_single(spec))
    plan.build_ms = (time.perf_counter() - t0) * 1e3
    return plan


def _plan_single(spec: ConvSpec) -> ConvPlan:
    """'conv'/'dilated': one phase covering the whole output."""
    h, w = spec.in_hw
    r, s = spec.kernel_hw
    (sh, sw) = spec.strides
    (ph, pw) = spec.padding
    (dh, dw) = spec.dilation if spec.kind == "dilated" else (1, 1)
    oh = dec.single_out_size(h, r, sh, dh, ph)
    ow = dec.single_out_size(w, s, sw, dw, pw)
    if oh <= 0 or ow <= 0:
        raise ValueError(f"non-positive output {oh}x{ow}")
    hp, wp = h + ph[0] + ph[1], w + pw[0] + pw[1]
    routes = tuple(_single_route_1dev(spec, hp, wp, (oh, ow), bb)
                   for bb in BATCH_BUCKETS)
    ex = PhaseExec(key="k", q=(0, 0), rho=(0, 0), taps=(r, s),
                   pad=spec.padding, out_hw=(oh, ow))
    # superpack row of tap (m, n) is m*S + n, recorded like the transposed
    # dx schedule so the backward never re-derives the layout
    taps_sched = tuple((m, nn, m * s + nn)
                       for m in range(r) for nn in range(s))
    return ConvPlan(spec=spec, out_hw=(oh, ow), phases=(ex,), gpad=None,
                    total_taps=r * s, sum_uv=oh * ow, uniform=True,
                    bwd_pad=None, dx_taps=taps_sched, routes=routes)


def _plan_transposed(spec: ConvSpec) -> ConvPlan:
    if spec.dilation != (1, 1):
        raise ValueError("transposed plans do not support rhs dilation")
    h, w = spec.in_hw
    r, s = spec.kernel_hw
    (sh, sw) = spec.strides
    (ph, pw) = spec.padding

    plans_h = dec.plan_phases_1d(h, r, sh, ph)
    plans_w = dec.plan_phases_1d(w, s, sw, pw)
    oh = dec.transposed_out_size(h, r, sh, ph)
    ow = dec.transposed_out_size(w, s, sw, pw)
    # single global pad: one residency of the input serves every phase
    gl_h = max(0, max(p.pad[0] for p in plans_h))
    gh_h = max(0, max(p.pad[1] for p in plans_h))
    gl_w = max(0, max(p.pad[0] for p in plans_w))
    gh_w = max(0, max(p.pad[1] for p in plans_w))
    gpad = ((gl_h, gh_h), (gl_w, gh_w))
    hg, wg = h + gl_h + gh_h, w + gl_w + gh_w
    phases = []
    tap_off = acc_off = sum_uvt = 0
    for p_h in plans_h:
        for p_w in plans_w:
            taps = (p_h.taps, p_w.taps)
            out_hw = (p_h.out_size, p_w.out_size)
            phases.append(PhaseExec(
                key=f"q{p_h.phase}x{p_w.phase}", q=(p_h.phase, p_w.phase),
                rho=(p_h.rho, p_w.rho), taps=taps,
                pad=(p_h.pad, p_w.pad), out_hw=out_hw,
                tap_off=tap_off, acc_off=acc_off,
                xoff=(gl_h - p_h.pad[0], gl_w - p_w.pad[0])))
            tap_off += taps[0] * taps[1]
            acc_off += out_hw[0] * out_hw[1]
            sum_uvt += out_hw[0] * out_hw[1] * taps[0] * taps[1]
    total_taps, sum_uv = tap_off, acc_off
    uniform = len({ex.out_hw for ex in phases}) == 1
    routes = tuple(_transposed_route_1dev(
        spec, hg, wg, (oh, ow), total_taps, sum_uv, sum_uvt, uniform,
        tuple(phases), bb) for bb in BATCH_BUCKETS)
    # dx schedule (strided-conv form): tap (m, n) of the flipped/swapped
    # kernel reads full-kernel tap (r-1-m, s-1-n), which lives in phase
    # ((pl-r') % s) at superpack row tap_off + r'//s (tap units)
    by_q = {ex.q: ex for ex in phases}
    dx_taps = []
    for m in range(r):
        for nn in range(s):
            rp, sp = r - 1 - m, s - 1 - nn
            ex = by_q[((ph[0] - rp) % sh, (pw[0] - sp) % sw)]
            dx_taps.append((m, nn, ex.tap_off + (rp // sh) * ex.taps[1]
                            + (sp // sw)))
    bwd_pad = ((r - 1 - ph[0], r - 1 - ph[1]), (s - 1 - pw[0], s - 1 - pw[1]))
    return ConvPlan(spec=spec, out_hw=(oh, ow), phases=tuple(phases),
                    gpad=gpad, total_taps=total_taps, sum_uv=sum_uv,
                    uniform=uniform, bwd_pad=bwd_pad, dx_taps=tuple(dx_taps),
                    routes=routes)


# ---------------------------------------------------------------------------
# torch routes: plain products on the views the JAX routes use
# ---------------------------------------------------------------------------

def _deq(packed):
    """The f32 superpack of either layout: dense buffers as they are, a
    ``QuantizedSuperpack`` dequantized (one multiply per weight ahead of
    the consuming product, as JAX's ``_deq``)."""
    if isinstance(packed, QuantizedSuperpack):
        return packed.dequant()
    return packed


def _kernel_operands(packed) -> tuple[torch.Tensor, dict]:
    """The kernel wrappers' weight operand and ``scales=`` argument: the
    int8 codes and their scale column for a ``QuantizedSuperpack`` (the
    kernels' int8 entries), the f32 superpack and no scales otherwise."""
    if isinstance(packed, QuantizedSuperpack):
        return packed.q, {"scales": packed.scale}
    return packed, {}


def _global_plane(plan: ConvPlan, x4: torch.Tensor) -> torch.Tensor:
    return pad_or_crop(x4, plan.gpad)


def _phase_tap_view(xg: torch.Tensor, ex: PhaseExec, ti: int, tj: int):
    u, v = ex.out_hw
    return xg[:, ex.xoff[0] + ti:ex.xoff[0] + ti + u,
              ex.xoff[1] + tj:ex.xoff[1] + tj + v, :]


def _fused_tap_fwd(plan: ConvPlan, xg: torch.Tensor, packed: torch.Tensor):
    """One wide product, exact FLOPs: every tap view of every phase stacked
    against the superpack (ΣT, C, N), then per-phase tap-segment sums.
    Stacking needs equal views, so this route serves uniform plans."""
    spec = plan.spec
    c, n = spec.in_c, spec.out_c
    b = xg.shape[0]
    views = [_phase_tap_view(xg, ex, *divmod(t, ex.taps[1]))
             for ex in plan.phases for t in range(ex.taps[0] * ex.taps[1])]
    buf = torch.stack(views, dim=0)                    # (ΣT, B, U, V, C)
    w3 = packed.reshape(plan.total_taps, c, n)
    yt = torch.einsum("tbuvc,tcn->tbuvn", buf, w3)
    outs = []
    for ex in plan.phases:
        th, tw = ex.taps
        u, v = ex.out_hw
        if th * tw == 0:
            outs.append(xg.new_zeros((b, u, v, n)))
            continue
        outs.append(yt[ex.tap_off:ex.tap_off + th * tw].sum(dim=0))
    return outs


def _fused_plane_fwd(plan: ConvPlan, xg: torch.Tensor, packed: torch.Tensor):
    """One wide product of the whole resident plane against the superpack
    viewed (C, ΣT·N); per-phase shifted slice-accumulate reads the tap planes."""
    spec = plan.spec
    c, n = spec.in_c, spec.out_c
    b, hg, wg, _ = xg.shape
    w2 = packed.reshape(plan.total_taps, c, n).permute(1, 0, 2) \
        .reshape(c, plan.total_taps * n)
    yf = torch.matmul(xg.reshape(b * hg * wg, c), w2)
    yf = yf.reshape(b, hg, wg, plan.total_taps, n)
    outs = []
    for ex in plan.phases:
        th, tw = ex.taps
        u, v = ex.out_hw
        if th * tw == 0 or u == 0 or v == 0:
            outs.append(xg.new_zeros((b, u, v, n)))
            continue
        acc = None
        for t in range(th * tw):
            ti, tj = divmod(t, tw)
            sl = yf[:, ex.xoff[0] + ti:ex.xoff[0] + ti + u,
                    ex.xoff[1] + tj:ex.xoff[1] + tj + v, ex.tap_off + t, :]
            acc = sl if acc is None else acc + sl
        outs.append(acc)
    return outs


def _pixel_shuffle_fwd(plan: ConvPlan, x4: torch.Tensor,
                       packed: torch.Tensor):
    """Sub-pixel route: the eligible transposed conv as ONE dense stride-1
    correlation against the superpack viewed (Q, T, C, N), then
    depth-to-space (phases are q_h-major, matching the (s_h, s_w) split)."""
    spec = plan.spec
    sh, sw = spec.strides
    c, n = spec.in_c, spec.out_c
    th, tw = plan.phases[0].taps
    h, w = spec.in_hw
    xp = pad_or_crop(x4, plan.phases[0].pad)
    b = xp.shape[0]
    views = [xp[:, ti:ti + h, tj:tj + w, :]
             for ti in range(th) for tj in range(tw)]
    buf = torch.stack(views, dim=0)                    # (T, B, H, W, C)
    w4 = packed.reshape(sh * sw, th * tw, c, n)        # (Q, T, C, N)
    y = torch.einsum("tbhwc,qtcn->bhwqn", buf, w4)
    y = y.reshape(b, h, w, sh, sw, n).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(b, h * sh, w * sw, n)


def _taps_fallback_fwd(plan: ConvPlan, xg: torch.Tensor,
                       packed: torch.Tensor):
    """General fallback: one global pad, per-phase products."""
    spec = plan.spec
    c, n = spec.in_c, spec.out_c
    b = xg.shape[0]
    outs = {}
    for ex in plan.phases:
        th, tw = ex.taps
        u, v = ex.out_hw
        if th * tw == 0 or u == 0 or v == 0:
            outs[ex.q] = xg.new_zeros((b, u, v, n))
            continue
        seg = packed[ex.tap_off * c:(ex.tap_off + th * tw) * c]
        if u * v <= _FUSE_MAX_ROWS and th * tw > 2:
            buf = torch.cat([_phase_tap_view(xg, ex, *divmod(t, tw))
                             for t in range(th * tw)], dim=-1)
            acc = torch.matmul(buf, seg)
        else:
            acc = None
            for t in range(th * tw):
                term = torch.matmul(_phase_tap_view(xg, ex, *divmod(t, tw)),
                                    seg[t * c:(t + 1) * c])
                acc = term if acc is None else acc + term
        outs[ex.q] = acc
    return dec.interleave_phases(outs, spec.strides, plan.out_hw)


def _transposed_fwd(plan: ConvPlan, x: torch.Tensor, packed):
    spec = plan.spec
    lead = tuple(x.shape[:-3])
    x4 = x.reshape((-1,) + tuple(x.shape[-3:]))
    route = plan.route_for_batch(x4.shape[0])
    path = route.path
    if path == "per_phase":
        # autotune-only route: the per-phase executor measured faster than
        # any fused launch (it pads per phase, so it bypasses the global
        # plane below)
        y = _transposed_per_phase(plan, x4, packed)
        return y.reshape(lead + tuple(y.shape[1:]))
    if path == "pixel_shuffle":
        # pads with the shared phase footprint (eligibility guarantees one
        # pad fits all phases), so it bypasses the global plane below
        y = _pixel_shuffle_fwd(plan, x4, _deq(packed))
        return y.reshape(lead + tuple(y.shape[1:]))
    xg = _global_plane(plan, x4)
    if path == "cuda":
        w, scales = _kernel_operands(packed)
        y = untangled_deconv2d(xg.contiguous(), w, phases=plan.phases,
                               out_hw=plan.out_hw, strides=spec.strides,
                               sum_uv=plan.sum_uv, out_dtype=x.dtype,
                               sp_tiles=route.sp_tiles, **scales)
    elif path in ("fused_tap", "fused_plane"):
        fwd = _fused_tap_fwd if path == "fused_tap" else _fused_plane_fwd
        outs = fwd(plan, xg, _deq(packed))
        if plan.uniform:
            y = dec.interleave_uniform(outs, spec.strides, plan.out_hw)
        else:
            y = dec.interleave_phases(
                {ex.q: o for ex, o in zip(plan.phases, outs)},
                spec.strides, plan.out_hw)
    elif path == "taps":
        y = _taps_fallback_fwd(plan, xg, _deq(packed))
    else:
        raise ValueError(f"route {path!r} is not ported (transposed routes: "
                         f"cuda, fused_tap, fused_plane, pixel_shuffle, "
                         f"taps, per_phase)")
    return y.reshape(lead + tuple(y.shape[1:])).to(x.dtype)


def _transposed_per_phase(plan: ConvPlan, x: torch.Tensor,
                          packed) -> torch.Tensor:
    """The pre-fusion executor: per phase, its own pad (or crop) of the
    plane and one stride-1 correlation with its rows of the superpack, then
    the interleave.  On the 'cuda' policy every live phase is one launch,
    as the main routes are: kernel C with the card's tile where the
    reference's tiled verdict takes the phase's plane, else kernel B, on the
    int8 codes and their scale rows (the int8 entries) for an int8 plan.
    Otherwise ``untangled_conv2d`` on the dequantized superpack (one wide
    product for few output rows, else a product per tap, the reference's
    heuristic)."""
    spec = plan.spec
    c, n = spec.in_c, spec.out_c
    cuda = _want_cuda(spec.backend)
    w, scales = _kernel_operands(packed) if cuda else (_deq(packed), {})
    x4 = x.reshape((-1,) + tuple(x.shape[-3:]))
    outs = {}
    for ex in plan.phases:
        th, tw = ex.taps
        u, v = ex.out_hw
        if th * tw == 0 or u == 0 or v == 0:
            outs[ex.q] = x4.new_zeros((x4.shape[0], u, v, n))
            continue
        xp = pad_or_crop(x4, ex.pad)
        rows = slice(ex.tap_off * c, (ex.tap_off + th * tw) * c)
        if not cuda:
            outs[ex.q] = untangled_conv2d(xp, w[rows].reshape(th, tw, c, n))
            continue
        phase = dataclasses.replace(spec, kind="conv", kernel_hw=ex.taps,
                                    strides=(1, 1), dilation=(1, 1))
        sp = None
        if _single_tiled_verdict(phase, xp.shape[1], xp.shape[2], (u, v)):
            sp = pick_block_tile_single((u, v), ex.taps, (1, 1), (1, 1), n)
        outs[ex.q] = untangled_conv2d_superpack(
            xp.contiguous(), w[rows], taps_hw=ex.taps, out_dtype=x.dtype,
            sp_tiles=sp, **{k: t[rows] for k, t in scales.items()})
    y = dec.interleave_phases(outs, spec.strides, plan.out_hw).to(x.dtype)
    return y.reshape(tuple(x.shape[:-3]) + tuple(y.shape[1:]))


# ---------------------------------------------------------------------------
# single correlation ('conv' / 'dilated'): superpack executors
# ---------------------------------------------------------------------------

def _single_geom(plan: ConvPlan):
    spec = plan.spec
    dilation = spec.dilation if spec.kind == "dilated" else (1, 1)
    return spec.strides, dilation, spec.kernel_hw, plan.out_hw


def _single_tap_view(xp: torch.Tensor, m: int, nn: int, strides: Pair,
                     dilation: Pair, out_hw: Pair) -> torch.Tensor:
    """Tap (m, n)'s strided/dilated window of the padded plane (a view):
    the zero-free read the naive engine replaces with kernel zero-insertion."""
    (sh, sw), (dh, dw) = strides, dilation
    u, v = out_hw
    return xp[:, m * dh:m * dh + (u - 1) * sh + 1:sh,
              nn * dw:nn * dw + (v - 1) * sw + 1:sw, :]


def _single_fwd(plan: ConvPlan, x: torch.Tensor, packed):
    """Planned single-correlation forward on the (R·S·C, N) superpack: pad
    once, keep the plane resident, tap products on strided/dilated views."""
    spec = plan.spec
    strides, dilation, (r, s), out_hw = _single_geom(plan)
    c = spec.in_c
    lead = tuple(x.shape[:-3])
    x4 = x.reshape((-1,) + tuple(x.shape[-3:]))
    xp = pad_or_crop(x4, spec.padding)
    route = plan.route_for_batch(x4.shape[0])
    path = route.path
    if path == "cuda":
        w, scales = _kernel_operands(packed)
        y = untangled_conv2d_superpack(
            xp.contiguous(), w, taps_hw=(r, s), strides=strides,
            rhs_dilation=dilation, out_dtype=x.dtype,
            sp_tiles=route.sp_tiles, **scales)
    elif path == "fused_tap":
        # ONE wide product: tap views concatenated channel-major in
        # superpack row order against the whole (R·S·C, N) buffer
        buf = torch.cat([_single_tap_view(xp, m, nn, strides, dilation,
                                          out_hw)
                         for m in range(r) for nn in range(s)], dim=-1)
        y = torch.matmul(buf, _deq(packed))
    elif path == "taps":
        # per-tap products; panels are superpack rows [t·C, (t+1)·C)
        w = _deq(packed)
        y = None
        for (m, nn, row) in plan.dx_taps:
            t = torch.matmul(
                _single_tap_view(xp, m, nn, strides, dilation, out_hw),
                w[row * c:(row + 1) * c])
            y = t if y is None else y + t
    else:
        raise ValueError(f"route {path!r} is not ported (single routes: "
                         f"cuda, fused_tap, taps)")
    return y.to(x.dtype).reshape(lead + tuple(y.shape[1:]))


# ---------------------------------------------------------------------------
# the §3.2.3 backwards (paper Fig. 6) on the superpack, as autograd
# Functions around every route — JAX's custom VJPs _pt_bwd / _ps_bwd.
# The products stay plain PyTorch, as JAX leaves them to XLA.
# ---------------------------------------------------------------------------

def _weight_cotangent(packed, dk: torch.Tensor):
    """The cotangents ``(d superpack, d scale)`` of the packed operand.  A
    dense superpack takes the f32 dK in its dtype.  A quantized one chains
    through ``w = q · scale``: the int8 codes get none (JAX's float0), the
    scale column the exact ``dscale[row] = Σ_n dK[row, n] · q[row, n]``."""
    if not isinstance(packed, QuantizedSuperpack):
        return dk.to(packed.dtype), None
    dscale = (dk.float() * packed.q.float()).sum(dim=-1, keepdim=True)
    return None, dscale.to(packed.scale.dtype)


def _pt_bwd(plan: ConvPlan, x: torch.Tensor, packed, dy: torch.Tensor,
            need_dx: bool = True, need_dk: bool = True):
    """Transposed backward: dx in the strided-conv form (dy windows against
    superpack panels at ``dx_taps`` rows, contracting N), dK in the
    dilated-kernel form, emitted directly in superpack row order.  Returns
    ``(dx, d superpack, d scale)`` (``_weight_cotangent``); the superpack
    is read dequantized, once."""
    spec = plan.spec
    h, w = spec.in_hw
    r, s = spec.kernel_hw
    (sh, sw) = spec.strides
    c = spec.in_c
    x4 = x.reshape((-1,) + tuple(x.shape[-3:]))
    dy4 = dy.reshape((-1,) + tuple(dy.shape[-3:]))
    dy_p = pad_or_crop(dy4, plan.bwd_pad)

    def window(oh0, ow0):
        return dy_p[:, oh0:oh0 + sh * (h - 1) + 1:sh,
                    ow0:ow0 + sw * (w - 1) + 1:sw, :]

    wdq = _deq(packed)
    dx = dpk = dscale = None
    if need_dx:
        for (m, nn, row) in plan.dx_taps:
            t = torch.matmul(window(m, nn), wdq[row * c:(row + 1) * c].T)
            dx = t if dx is None else dx + t
        dx = dx.to(x.dtype).reshape(x.shape)
    if need_dk:
        segs = []
        m_rows = x4.reshape(-1, c).T                       # (C, B·H·W)
        for ex in plan.phases:
            th, tw = ex.taps
            for t in range(th * tw):
                t_h, t_w = divmod(t, tw)
                rr = ex.rho[0] + sh * t_h
                ss = ex.rho[1] + sw * t_w
                wnd = window(r - 1 - rr, s - 1 - ss)
                segs.append(torch.matmul(m_rows, wnd.reshape(-1, spec.out_c)))
        dk = (torch.cat(segs, dim=0) if segs
              else wdq.new_zeros(wdq.shape, dtype=torch.float32))
        dpk, dscale = _weight_cotangent(packed, dk)
    return dx, dpk, dscale


def _unpad_transpose(dxp: torch.Tensor, pads, in_hw: Pair) -> torch.Tensor:
    """Exact transpose of ``pad_or_crop``: slice off the positive pads,
    zero-pad back anything the forward cropped (negative pads)."""
    (ph, pw) = pads
    hp, wp = dxp.shape[-3], dxp.shape[-2]
    dx = dxp[..., max(0, ph[0]):hp - max(0, ph[1]),
             max(0, pw[0]):wp - max(0, pw[1]), :]
    grow = (0, 0, max(0, -pw[0]), max(0, -pw[1]),
            max(0, -ph[0]), max(0, -ph[1]))
    if any(grow):
        dx = torch.nn.functional.pad(dx, grow)
    assert tuple(dx.shape[-3:-1]) == tuple(in_hw), (dx.shape, in_hw)
    return dx


def _ps_bwd(plan: ConvPlan, x: torch.Tensor, packed, dy: torch.Tensor,
            need_dx: bool = True, need_dk: bool = True):
    """Single-correlation backward, mirroring ``_pt_bwd``: dx in the
    transposed-tap form (dy against the superpack's (C, N) panels, each
    tap's plane scattered back through the exact transpose of its forward
    read), dK from tap views of the padded plane against dy, in superpack
    row order.  ``fused_bwd`` of the actual batch's route picks one wide
    GEMM per half or per-tap products.  Returns ``(dx, d superpack,
    d scale)``, as ``_pt_bwd``."""
    spec = plan.spec
    strides, dilation, (r, s), (oh, ow) = _single_geom(plan)
    (sh, sw), (dh, dw) = strides, dilation
    c, n = spec.in_c, spec.out_c
    x4 = x.reshape((-1,) + tuple(x.shape[-3:]))
    dy4 = dy.reshape((-1,) + tuple(dy.shape[-3:]))
    xp = pad_or_crop(x4, spec.padding)
    b, hp, wp = xp.shape[0], xp.shape[1], xp.shape[2]
    fused_bwd = plan.route_for_batch(b).fused_bwd
    dy2 = dy4.reshape(-1, n)                               # (B·OH·OW, N)

    wdq = _deq(packed)
    dx = dpk = dscale = None
    if need_dx:
        g = None
        if fused_bwd:
            # one GEMM over the (ΣT, C, N) view: (B, OH, OW, ΣT, C)
            g = torch.matmul(dy2, wdq.T).reshape(b, oh, ow, r * s, c)
        dxp = torch.zeros((b, hp, wp, c), dtype=torch.float32,
                          device=x.device)
        for (m, nn, row) in plan.dx_taps:
            if g is not None:
                gt = g[..., row, :]
            else:
                gt = torch.matmul(dy4, wdq[row * c:(row + 1) * c].T)
            dxp[:, m * dh:m * dh + (oh - 1) * sh + 1:sh,
                nn * dw:nn * dw + (ow - 1) * sw + 1:sw, :] += gt
        dx = _unpad_transpose(dxp, spec.padding, spec.in_hw)
        dx = dx.to(x.dtype).reshape(x.shape)
    if need_dk:
        views = [_single_tap_view(xp, m, nn, strides, dilation, (oh, ow))
                 for (m, nn, _) in plan.dx_taps]
        if fused_bwd:
            buf = torch.stack(views, dim=0).reshape(r * s, -1, c)
            dk = torch.matmul(buf.transpose(1, 2), dy2).reshape(r * s * c, n)
        else:
            dk = torch.cat([torch.matmul(v.reshape(-1, c).T, dy2)
                            for v in views], dim=0)
        dpk, dscale = _weight_cotangent(packed, dk)
    return dx, dpk, dscale


def _packed_operand(w: torch.Tensor, scale):
    """The superpack an autograd Function's ``(w, scale)`` inputs stand
    for: ``w`` itself, or the ``QuantizedSuperpack`` of codes ``w``."""
    return w if scale is None else QuantizedSuperpack(w, scale)


class _PlannedTransposed(torch.autograd.Function):
    """The transposed kind's forward on any route, with ``_pt_bwd`` as its
    backward (JAX: ``_planned_transposed``).  ``w`` is the f32 superpack
    (``scale`` None) or the int8 codes of a quantized one."""

    @staticmethod
    def forward(ctx, plan, x, w, scale):
        ctx.plan = plan
        ctx.save_for_backward(x, w, scale)
        return _transposed_fwd(plan, x.detach(), _packed_operand(
            w.detach(), None if scale is None else scale.detach()))

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, w, scale = ctx.saved_tensors
        dx, dpk, dscale = _pt_bwd(ctx.plan, x, _packed_operand(w, scale),
                                  dy, need_dx=ctx.needs_input_grad[1],
                                  need_dk=any(ctx.needs_input_grad[2:]))
        return None, dx, dpk, dscale


class _PlannedSingle(torch.autograd.Function):
    """The conv/dilated kinds' forward on any route, with ``_ps_bwd`` as
    its backward (JAX: ``_planned_single``); inputs as for
    ``_PlannedTransposed``."""

    @staticmethod
    def forward(ctx, plan, x, w, scale):
        ctx.plan = plan
        ctx.save_for_backward(x, w, scale)
        return _single_fwd(plan, x.detach(), _packed_operand(
            w.detach(), None if scale is None else scale.detach()))

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, w, scale = ctx.saved_tensors
        dx, dpk, dscale = _ps_bwd(ctx.plan, x, _packed_operand(w, scale),
                                  dy, need_dx=ctx.needs_input_grad[1],
                                  need_dk=any(ctx.needs_input_grad[2:]))
        return None, dx, dpk, dscale
