"""Kernels A–D: the untangled convolutions, hand-written for Hopper.

``untangled_deconv2d`` (kernel A) is the port of ``repro.kernels
.untangled_conv.untangled_deconv2d_pallas`` (TPU kernel ``_deconv_kernel``):
ONE call computes every s_h·s_w output phase of a transposed conv over
the globally padded plane and stores the output interleaved, with no zero
inserted.  ``deconv_schedule`` splits its K range into slices where the
unsplit grid would leave the card's SMs idle (batch 1, or phases of
unequal tap counts); a second small kernel then sums each tile's slices
in slice order.  ``untangled_conv2d_superpack`` (kernel B) is the port of
``untangled_conv2d_superpack_pallas`` (TPU kernel ``_kernel``): ONE call
of the strided or dilated correlation of a pre-padded plane with the
tap-major ``(R·S·C, N)`` superpack, with no zero inserted in the kernel;
``conv_schedule`` picks its tile (BN following N, BM the rows) and splits
K the same way where a modelled makespan says the split pays.
The CUDA sources are ``csrc/untangled_deconv.cu`` and
``csrc/untangled_conv.cu`` (their headers say what bounds each kernel on the
card and what the design does about it); ``_build`` compiles them with
``nvcc`` at first use and binds their plain C entries with ``ctypes``.

Kernel E, the int8 tap panel of the TPU kernels (``_tap_panel``), is each
kernel's int8 entry: ``scales=`` marks the superpack as int8 codes with one
f32 scale per row (a ``QuantizedSuperpack``), and the kernel multiplies
each code by its row's scale into its f32 weight tile (A–D alike, from
the codes their ring brought to shared memory), so the int8 kernel on
``(q, scale)`` is bit-equal to the f32 kernel on
``dequantize_int8(q, scale)``.

A row-parallel superpack (its tap-major K split over ranks) runs A, B, C
or D on the rank's rows only: ``rows=(r0, r1)`` on either wrapper marks
the weight operand (and an int8 one's scales) as superpack rows ``[r0,
r1)``, and the kernel returns the f32 partial sum over them, reading no
other weight row.  A block may cut a tap and, for A and D, span phases: A
walks each phase's K chunks that hold rows of the block
(``_phase_krange``; its thin tile walks every chunk with the rows outside
read as zeros), B its flat K range from ``r0``; C and D walk every chunk
and tap, their weight copies zero-filling the rows outside the block.
Their plain versions are ``*_rows_ref``.

Kernels C and D are the spatially tiled forms of B and A (TPU kernels
``_tiled_kernel`` and ``_deconv_tiled_kernel`` with ``_halo_stream``):
``sp_tiles=`` on either wrapper names the spatial output tile one thread
block computes, ``(T_oh, T_ow)`` output pixels for C and ``(T_u, T_v)``
phase-output pixels for D.  The block stages its tile's halo'd input slice
in shared memory one 4-channel chunk at a time through a ``cp.async`` ring
(``csrc/untangled_conv_tiled.cu``, ``csrc/untangled_deconv_tiled.cu``), so
every tap (and for D every phase) reads the one staged copy; a thread holds
8 pixels of a tile row (D: times 1–4 phases) and reads each halo value
once for all taps of a row.  Where D's phases share one 2x2 window
(k = 2·s), they are extra output columns of one correlation.
``halo_extent`` and ``deconv_tap_span`` are the reference's halo geometry;
``tiled_conv_schedule`` and ``tiled_deconv_schedule`` lay out C's and D's
blocks (tap loop, register split, tile, BN, ring, halo pitch) and
``pick_block_tile_*`` return their tiles.

Each wrapper launches its kernel for CUDA tensors, and raises on anything
the kernel does not take.  It takes its plain version (``*_ref``) only for
tensors on the CPU.  A fake tensor off the CPU (``kernels.fake``) gets the
empty output, and the launch and its work (``work_deconv``, ``work_conv``)
go to the analysis that made it; the launch counters move only where a
kernel launches.  The kernels have no
backward of their own: inputs that require grad raise, and training goes
through ``ConvPlan.apply``, whose autograd Functions call the wrappers on
detached inputs and run the §3.2.3 backward as plain products.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import heapq
from typing import Sequence

import torch

from repro_torch.kernels import fake
from repro_torch.runtime.compress import dequantize_int8

Pair = tuple[int, int]

# kernel A's 128x128 tile is taken when it alone yields this many blocks
_BIG_TILE_MIN_BLOCKS = 120
_INT32_MAX = 2 ** 31 - 1

# kernel A's tiles, indexed as in csrc/untangled_deconv.cu's dispatch:
# (BM, BN, BK channels a K chunk).  0-3 are the wide tiles, 4 the thin-N
# tile (N <= _THIN_N)
_DECONV_CONFIGS = ((128, 128, 16), (64, 64, 16), (32, 64, 16),
                   (16, 64, 16), (256, 4, 8))
_THIN = 4
_THIN_N = 16
# the thin tile is a spatial TU x TV block of a phase's output, TV =
# min(V, _THIN_TV) and TU = min(BM // TV, _THIN_TU) (the kernel's kThinTV,
# kThinTU); its halo ring has _THIN_STAGES slots
_THIN_TV = _THIN_TU = 64
_THIN_STAGES = 3
# the thin tile stages its unit's weight rows whole: at most this many
_THIN_ROWS_MAX = 3072
SMS = 132
# a split aims at no more than this many units, and its workspace at no
# more than this many bytes
_UNITS_MAX = 4 * SMS
_WORKSPACE_MAX = 64 * 2 ** 20
# a unit's fixed cost (fill the ring, store a partial tile), in K chunks
_UNIT_OVERHEAD = 2
# slices shorter than this (in K chunks) make the M tile step down
_MIN_SLICE = 8


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


def embed_rows(block: torch.Tensor, scales, rows: Pair, total: int):
    """A row block ``block`` (and its ``scales``) at rows ``rows`` = [r0,
    r1) of an otherwise zero superpack of ``total`` rows: the plain row
    versions run the whole plain versions on it."""
    whole = block.new_zeros((total, block.shape[1]))
    whole[rows[0]:rows[1]] = block
    if scales is None:
        return whole, None
    wscales = scales.new_zeros((total, 1))
    wscales[rows[0]:rows[1]] = scales
    return whole, wscales


def untangled_deconv2d_rows_ref(xg: torch.Tensor, block: torch.Tensor, *,
                                rows: Pair, phases, out_hw: Pair,
                                strides: Pair, sum_uv: int, out_dtype=None,
                                scales=None) -> torch.Tensor:
    """Plain PyTorch version of kernel A on a row-parallel block: ``block``
    holds superpack rows ``rows`` = [r0, r1) only (with ``scales``, their
    int8 codes and scale rows), and the result is the f32 partial sum over
    those rows, ``untangled_deconv2d_ref`` on the block in its rows of an
    otherwise zero superpack.  Summed over the blocks of every rank it is
    ``untangled_deconv2d_ref`` on the whole superpack."""
    total = sum(ex.taps[0] * ex.taps[1] for ex in phases) * xg.shape[3]
    whole, wscales = embed_rows(block, scales, rows, total)
    return untangled_deconv2d_ref(xg, whole, phases=phases, out_hw=out_hw,
                                  strides=strides, sum_uv=sum_uv,
                                  out_dtype=out_dtype, scales=wscales)


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


def _n_slices(chunks: int, chunk_len: int) -> int:
    """Slices of a phase of ``chunks`` K chunks under slice length L: one
    for a phase that fits (or has no taps), else ceil(chunks / L).  The
    kernel's ``n_slices``."""
    return 1 if chunks <= chunk_len else -(-chunks // chunk_len)


def _slice_begin(chunks: int, slices: int, s: int) -> int:
    """First K chunk of slice ``s``: slice s covers ``[begin(s),
    begin(s + 1))``, lengths differing by at most one.  The kernel's
    ``slice_begin``."""
    return s * chunks // slices


@dataclasses.dataclass(frozen=True)
class DeconvSchedule:
    """How kernel A covers one call: the tile ``config`` (an index into
    ``_DECONV_CONFIGS``), K chunks of ``bk`` channels, ``chunk_len`` chunks
    a slice (at least the longest phase when no phase is split), per phase
    its M tiles and slices, the grid (work units over (phase, M tile,
    slice), N tiles), the longest slice in chunks, the thin tile's halo in
    plane pixels (0 for the wide tiles) and the f32 workspace of the
    split's partial tiles (0 bytes: no split, no second pass)."""
    config: int
    chunk_len: int
    phase_chunks: tuple[int, ...]
    m_tiles: tuple[int, ...]
    slices: tuple[int, ...]
    grid: tuple[int, int]
    max_chunks: int
    halo: int
    workspace_bytes: int

    @property
    def tile(self) -> tuple[int, int]:
        return _DECONV_CONFIGS[self.config][:2]

    @property
    def bk(self) -> int:
        return _DECONV_CONFIGS[self.config][2]

    @property
    def split(self) -> bool:
        return self.workspace_bytes > 0

    @property
    def units(self) -> int:
        return self.grid[0] * self.grid[1]

    @property
    def reduce_tiles(self) -> int:
        return sum(self.m_tiles)

    def unit_chunks(self) -> list[int]:
        """K chunks of every work unit in launch order (x fastest)."""
        per_x = [_slice_begin(k, s, i + 1) - _slice_begin(k, s, i)
                 for k, mt, s in zip(self.phase_chunks, self.m_tiles,
                                     self.slices)
                 for _ in range(mt) for i in range(s)]
        return per_x * self.grid[1]


def _makespan(chunks: Sequence[int], slots: int = SMS) -> int:
    """Greedy list schedule of units (in launch order, each its chunks plus
    the fixed ``_UNIT_OVERHEAD``) on ``slots`` block slots (the card's SMs
    by default), each running one unit at a time at its full rate: the
    time the last one ends, in K chunks."""
    ends = [0] * min(slots, len(chunks))
    for c in chunks:
        heapq.heapreplace(ends, ends[0] + c + _UNIT_OVERHEAD)
    return max(ends)


def _deconv_config(n: int, rows: Sequence[int]) -> int:
    """Kernel A's first tile for N output channels and the GEMM rows B·U·V
    of each phase: the thin tile for N <= 16; 128x128 when it alone fills
    the card; else the M tile follows the rows (64, 32 or 16)."""
    if n <= _THIN_N:
        return _THIN
    if sum(-(-m // 128) for m in rows) * -(-n // 128) >= _BIG_TILE_MIN_BLOCKS:
        return 0
    m = max(rows)
    return 1 if m > 32 else 2 if m > 16 else 3


def _thin_tile(v: int) -> tuple[int, int]:
    """The thin tile's (TU, TV) on a phase of V columns."""
    tv = min(v, _THIN_TV)
    return min(_DECONV_CONFIGS[_THIN][0] // tv, _THIN_TU), tv


def thin_smem_bytes(sch: DeconvSchedule) -> int:
    """Dynamic shared memory of the thin tile's block: the halo ring (BK +
    4 floats a pixel) and the slice's weight rows (4 floats each); the
    kernel's launch_thin."""
    return 4 * _THIN_STAGES * sch.halo * (sch.bk + 4) \
        + 16 * sch.max_chunks * sch.bk


def _m_tiles(config: int, b: int, ex) -> int:
    """Output tiles of one phase (the kernel's ``phase_tiles``): BM rows of
    its B·U·V for the wide tiles, TU x TV blocks of each image's U x V for
    the thin one."""
    u, v = ex.out_hw
    if config != _THIN:
        return -(-b * u * v // _DECONV_CONFIGS[config][0])
    if u * v == 0:
        return 0
    tu, tv = _thin_tile(v)
    return b * -(-u // tu) * -(-v // tv)


def _thin_halo(phases) -> int:
    """The thin tile's halo, the most plane pixels any live phase's tile
    reads: (TU + T_h - 1) x (TV + T_w - 1)."""
    out = 0
    for ex in phases:
        if ex.taps[0] * ex.taps[1] and ex.out_hw[0] * ex.out_hw[1]:
            tu, tv = _thin_tile(ex.out_hw[1])
            out = max(out, (tu + ex.taps[0] - 1) * (tv + ex.taps[1] - 1))
    return out


def _phase_krange(ex, c: int, bk: int, rows, thin: bool = False
                  ) -> tuple[int, int]:
    """(first K chunk, chunks) of one phase that a call on superpack rows
    ``rows`` = (r0, r1) walks (None: the whole superpack): the wide tiles
    walk a phase's rows in ascending order (tap by tap, ``bk`` channels a
    chunk), so the chunks holding rows of [r0, r1) are one range; the thin
    tile walks every chunk, the rows outside read as zeros.  The kernel's
    ``phase_krange``."""
    t, kc = ex.taps[0] * ex.taps[1], -(-c // bk)
    if rows is None or thin:
        return 0, t * kc
    base = ex.tap_off * c
    a, b = max(rows[0] - base, 0), min(rows[1] - base, t * c)
    if b <= a:
        return 0, 0
    lo = (a // c) * kc + (a % c) // bk
    return lo, ((b - 1) // c) * kc + ((b - 1) % c) // bk + 1 - lo


def _phase_chunks(config: int, phases, c: int, rows=None) -> list[int]:
    """K chunks of each phase: its T_h·T_w taps times ceil(C / BK), or
    those of a row block's range (``_phase_krange``)."""
    bk = _DECONV_CONFIGS[config][2]
    return [_phase_krange(ex, c, bk, rows, config == _THIN)[1]
            for ex in phases]


def _schedule(config: int, phases, b: int, c: int, n: int,
              chunk_len: int, rows=None) -> DeconvSchedule:
    bm, bn, _ = _DECONV_CONFIGS[config]
    phase_chunks = _phase_chunks(config, phases, c, rows)
    m_tiles = tuple(_m_tiles(config, b, ex) for ex in phases)
    slices = tuple(_n_slices(k, chunk_len) for k in phase_chunks)
    gn = -(-n // bn)
    gx = sum(t * s for t, s in zip(m_tiles, slices))
    split = any(s > 1 for s in slices)
    max_chunks = max(-(-k // s) for k, s in zip(phase_chunks, slices))
    return DeconvSchedule(
        config=config, chunk_len=chunk_len,
        phase_chunks=tuple(phase_chunks), m_tiles=m_tiles, slices=slices,
        grid=(gx, gn), max_chunks=max_chunks,
        halo=_thin_halo(phases) if config == _THIN else 0,
        workspace_bytes=4 * gx * gn * bm * bn if split else 0)


def _best_split(config: int, phases, b: int, c: int, n: int, rows=None
                ) -> DeconvSchedule:
    """The schedule of one tile: unsplit when that already gives 132 units
    (and, for the thin tile, fits its weight stage); else the slice length
    L, among those giving at least 132 units (at most ``_UNITS_MAX`` where
    possible), of least greedy makespan on 132 SMs."""
    phase_chunks = _phase_chunks(config, phases, c, rows)
    k_max = max(max(phase_chunks), 1)
    cap = _THIN_ROWS_MAX // _DECONV_CONFIGS[config][2] if config == _THIN \
        else k_max
    whole = _schedule(config, phases, b, c, n, min(k_max, cap), rows)
    if whole.units >= SMS and cap >= k_max:
        return whole
    most = _schedule(config, phases, b, c, n, 1, rows).units
    lengths = sorted({-(-k // j) for k in phase_chunks if k
                      for j in range(1, k + 1)} | {1}, reverse=True)
    best = None
    for length in lengths:
        if length > cap:
            continue
        sch = _schedule(config, phases, b, c, n, length, rows)
        if sch.workspace_bytes > _WORKSPACE_MAX and best is not None:
            break
        if sch.units < min(SMS, most) or (sch.units > _UNITS_MAX
                                          and best is not None):
            continue
        cost = _makespan(sch.unit_chunks())
        if best is None or cost < best[0]:
            best = (cost, sch)
    return best[1]


@functools.lru_cache(maxsize=1024)
def deconv_schedule(phases: tuple, b: int, c: int, n: int, rows=None
                    ) -> DeconvSchedule:
    """Kernel A's schedule for a call on ``b`` images of C input and N
    output channels (f32 and int8 entries alike).  No phase is split when
    the unsplit grid already has 132 units (one an SM); else K is split into
    slices of one length L shared by every phase (``_best_split``), so a
    9-tap and a 4-tap phase end together.  Where that leaves slices shorter
    than ``_MIN_SLICE`` chunks, the M tile steps down (64 -> 32 -> 16) for
    more tiles and longer slices.  The thin tile also caps a slice at
    ``_THIN_ROWS_MAX`` weight rows (its shared-memory stage).  ``rows`` =
    (r0, r1): a call on a row-parallel block of the superpack, each phase
    walking only its chunks of those rows (``_phase_krange``)."""
    phases = tuple(phases)
    m_rows = [b * ex.out_hw[0] * ex.out_hw[1] for ex in phases]
    config = _deconv_config(n, m_rows)
    while True:
        sch = _best_split(config, phases, b, c, n, rows)
        if sch.split and sch.chunk_len < _MIN_SLICE and config in (1, 2):
            config += 1
            continue
        return sch


def work_deconv(xg: torch.Tensor, superpack: torch.Tensor, y: torch.Tensor,
                phases, scales=None, rows=None) -> tuple[int, int]:
    """(FLOPs, bytes) of one kernel A or D call: 2·B·U·V·T·C·N summed over
    the phases, over the superpack rows ``rows`` = (r0, r1) only where the
    launch walks only those (A's row block; D's row block walks every
    row, so its caller passes None), and the plane, the weight operand
    (int8 codes with their scales) and the output each moved once at their
    dtype's size."""
    b, c, n = xg.shape[0], xg.shape[3], superpack.shape[1]
    r0, r1 = (0, sum(ex.taps[0] * ex.taps[1] for ex in phases) * c) \
        if rows is None else rows
    macs, row = 0, 0
    for ex in phases:
        k = ex.taps[0] * ex.taps[1] * c
        macs += b * ex.out_hw[0] * ex.out_hw[1] * max(
            0, min(row + k, r1) - max(row, r0))
        row += k
    return 2 * macs * n, fake.nbytes(xg, superpack, scales, y)


def work_conv(x: torch.Tensor, superpack: torch.Tensor, y: torch.Tensor,
              scales=None, k=None) -> tuple[int, int]:
    """(FLOPs, bytes) of one kernel B or C call: 2·B·OH·OW·K·N for the K
    rows the launch walks (``k``; by default the weight operand's: R·S·C,
    or B's row block; C's row block walks all R·S·C), and the plane, the
    weight operand and the output each moved once at their dtype's
    size."""
    b, oh, ow, n = y.shape
    k = superpack.shape[0] if k is None else k
    return (2 * b * oh * ow * k * n, fake.nbytes(x, superpack, scales, y))


# the C entries' parameters: every pointer and the stream as c_void_p (a
# bare Python int would be passed as a 32-bit int and cut the address); the
# int8 entry takes the scale column after the codes
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 20
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


def _check_rows(name: str, rows, total: int, got: int) -> Pair:
    """The call's superpack rows: ``rows`` = (r0, r1), a block of the
    ``total`` rows that the weight operand's ``got`` rows hold, or the
    whole superpack (None)."""
    if rows is None:
        rows = (0, total)
    r0, r1 = (int(r) for r in rows)
    if not 0 <= r0 < r1 <= total or got != r1 - r0:
        raise ValueError(f"{name}: a weight operand of {got} rows for "
                         f"superpack rows {rows} of {total}")
    return r0, r1


def _count(entry, sp_tiles, scales, whole: bool) -> None:
    """Add one to the launch counter of ``entry`` (``untangled_deconv2d``
    or ``untangled_conv2d_superpack``) that a launch of this form adds to:
    ``launches_tiled`` or ``launches`` (``_int8`` with scales), and for a
    row block also ``launches_rows`` (A, B) or ``launches_tiled_rows`` (C,
    D), f32 and int8 alike."""
    tiled = "_tiled" if sp_tiles is not None else ""
    i8 = "" if scales is None else "_int8"
    attr = f"launches{tiled}{i8}"
    setattr(entry, attr, getattr(entry, attr) + 1)
    if not whole:
        attr = f"launches{tiled}_rows"
        setattr(entry, attr, getattr(entry, attr) + 1)


def _check(xg: torch.Tensor, superpack: torch.Tensor, phases,
           out_hw: Pair, strides: Pair, sum_uv: int, rows=None) -> Pair:
    if xg.dim() != 4 or superpack.dim() != 2:
        raise ValueError(f"want xg (B, Hg, Wg, C) and superpack (ΣT·C, N), "
                         f"got {tuple(xg.shape)} and {tuple(superpack.shape)}")
    c = xg.shape[3]
    total_taps = sum(ex.taps[0] * ex.taps[1] for ex in phases)
    if rows is None and superpack.shape[0] != total_taps * c:
        raise ValueError(f"superpack has {superpack.shape[0]} rows, the "
                         f"phases need {total_taps}·{c}")
    rows = _check_rows("kernel A", rows, total_taps * c, superpack.shape[0])
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
    return rows


def deconv_launch_ints(xg: torch.Tensor, superpack: torch.Tensor,
                       y: torch.Tensor, phases: tuple, strides: Pair,
                       rows=None):
    """Kernel A's schedule for a call and the C entry's int arguments after
    its pointers: the geometry, the tile, the 16-byte path (the thin tile's
    plane copies, C % 4 == 0; the wide tiles' superpack copies and stores,
    N % 4 == 0; every operand aligned) and the schedule's slice length,
    longest slice, grid and reduction tiles, and the superpack rows ``rows``
    = (r0, r1) the weight operand holds (None: all of them).  The f32 and
    int8 entries take the same ones (int8 codes need 4-byte, f32 16-byte
    alignment)."""
    b, hg, wg, c = xg.shape
    _, oh, ow, n = y.shape
    sch = deconv_schedule(phases, b, c, n) if rows is None else \
        deconv_schedule(phases, b, c, n, tuple(rows))
    if rows is None:
        rows = (0, sum(ex.taps[0] * ex.taps[1] for ex in phases) * c)
    if sch.grid[1] > _GRID_YZ_MAX or sch.grid[0] > _INT32_MAX:
        raise ValueError(f"kernel A: N {n} or batch {b} beyond the grid")
    if sch.config == _THIN and thin_smem_bytes(sch) > SMEM_BLOCK_MAX:
        raise ValueError(f"kernel A: the thin tile's halo ({sch.halo} "
                         f"pixels) needs more shared memory than a block has")
    vec = _vec_ok(c, 4, (xg,)) if sch.config == _THIN \
        else _vec_ok(4, n, (superpack, y))
    return sch, (b, hg, wg, c, n, oh, ow, strides[0], strides[1],
                 len(phases), sch.config, vec, sch.chunk_len, sch.max_chunks,
                 sch.halo, sch.grid[0], sch.grid[1], sch.reduce_tiles,
                 rows[0], rows[1])


def untangled_deconv2d(xg: torch.Tensor, superpack: torch.Tensor, *,
                       phases: Sequence, out_hw: Pair, strides: Pair,
                       sum_uv: int, out_dtype=None,
                       scales: torch.Tensor | None = None,
                       sp_tiles: Pair | None = None,
                       rows: Pair | None = None) -> torch.Tensor:
    """Fused transposed conv: ONE kernel launch for all s_h·s_w phases.

    xg: (B, Hg, Wg, C) globally padded plane; superpack: (ΣT·C, N) tap-major
    phase sub-kernels (``ConvPlan.pack``); ``phases`` the plan's
    ``PhaseExec`` records.  ``scales`` ((ΣT·C, 1) f32) marks ``superpack``
    as int8 codes (a ``QuantizedSuperpack``'s ``q``) and takes the int8
    entry.  ``sp_tiles=(T_u, T_v)`` (phase-output pixels; uniform phases
    with ``out % stride == 0`` only, else ``ValueError``) takes the
    spatially tiled kernel D.  ``rows=(r0, r1)``: ``superpack`` (and
    ``scales``) hold those superpack rows only, a row-parallel block, and
    the result is the f32 partial sum over them (A or D; the launch reads
    the block and nothing else of the weights).  Returns (B, out_h,
    out_w, N), written interleaved by the kernel.  CUDA tensors launch the
    kernel (float32 plane, contiguous, no grad) and count one in
    ``untangled_deconv2d.launches`` (f32), ``.launches_int8``,
    ``.launches_tiled`` or ``.launches_tiled_int8`` (a row block's launch
    also in ``.launches_rows`` or ``.launches_tiled_rows``); CPU tensors
    run ``untangled_deconv2d_ref``, ``untangled_deconv2d_tiled_ref`` or
    their row forms ``*_rows_ref``."""
    phases = tuple(phases)
    out_dtype = out_dtype or xg.dtype
    whole = rows is None
    rows = _check(xg, superpack, phases, out_hw, strides, sum_uv, rows)
    if sp_tiles is not None:
        _check_uniform(phases, out_hw, strides)
        deconv_tap_span(phases)                 # at least one live phase
        sp_tiles = (min(sp_tiles[0], phases[0].out_hw[0]),
                    min(sp_tiles[1], phases[0].out_hw[1]))
        if min(sp_tiles) < 1:
            raise ValueError(f"sp_tiles {sp_tiles} must be positive")
    if xg.device.type == "cpu" and superpack.device.type == "cpu":
        if not whole and sp_tiles is not None:
            return untangled_deconv2d_tiled_rows_ref(
                xg, superpack, rows=rows, phases=phases, out_hw=out_hw,
                strides=strides, sp_tiles=sp_tiles, out_dtype=out_dtype,
                scales=scales)
        if not whole:
            return untangled_deconv2d_rows_ref(
                xg, superpack, rows=rows, phases=phases, out_hw=out_hw,
                strides=strides, sum_uv=sum_uv, out_dtype=out_dtype,
                scales=scales)
        if sp_tiles is not None:
            return untangled_deconv2d_tiled_ref(
                xg, superpack, phases=phases, out_hw=out_hw,
                strides=strides, sp_tiles=sp_tiles, out_dtype=out_dtype,
                scales=scales)
        return untangled_deconv2d_ref(xg, superpack, phases=phases,
                                      out_hw=out_hw, strides=strides,
                                      sum_uv=sum_uv, out_dtype=out_dtype,
                                      scales=scales)
    name = "kernel A" if sp_tiles is None else "kernel D"
    if (xg.device.type != "cuda" and not fake.is_fake(xg)) \
            or superpack.device != xg.device:
        raise ValueError(f"{name} needs both operands on one CUDA device, "
                         f"got {xg.device} and {superpack.device}")
    if xg.requires_grad or superpack.requires_grad or (
            scales is not None and scales.requires_grad):
        raise NotImplementedError(
            f"{name} has no backward of its own: differentiate through "
            "ConvPlan.apply (its autograd Function runs _pt_bwd)")
    if xg.dtype != torch.float32:
        raise TypeError(f"{name} takes a float32 xg, got {xg.dtype}")
    _check_weights(name, superpack, scales)
    for arg, t in (("xg", xg), ("superpack", superpack)):
        if not t.is_contiguous():
            raise ValueError(f"{name} takes a contiguous {arg}")
    if out_dtype != torch.float32:
        raise TypeError(f"{name} writes float32, asked for {out_dtype}")
    b, _, _, c = xg.shape
    n = superpack.shape[1]
    y = torch.empty((b, *out_hw, n), dtype=torch.float32, device=xg.device)
    if max(xg.numel(), superpack.numel(), y.numel()) > _INT32_MAX:
        raise ValueError(f"{name} indexes with int32: tensor too large")
    if y.numel() == 0:
        return y
    if fake.is_fake(xg):
        name = ("A" if sp_tiles is None else "D") + (
            "" if scales is None else "_int8")
        fake.launched(name, work_deconv(
            xg, superpack, y, phases, scales,
            None if whole or sp_tiles is not None else rows))
        return y
    if sp_tiles is not None:
        _launch_tiled_deconv(xg, superpack, scales, y, phases, strides,
                             sp_tiles, rows)
        _count(untangled_deconv2d, sp_tiles, scales, whole)
        return y
    sch, ints = deconv_launch_ints(xg, superpack, y, phases, strides,
                                   None if whole else rows)
    table = _phase_table(phases, xg.device)
    ws = torch.empty(sch.workspace_bytes // 4, dtype=torch.float32,
                     device=xg.device) if sch.split else None
    weights = (superpack.data_ptr(),) if scales is None else (
        superpack.data_ptr(), scales.data_ptr())
    with torch.cuda.device(xg.device):
        stream = torch.cuda.current_stream(xg.device).cuda_stream
        rc = _entry(scales is not None)(
            xg.data_ptr(), *weights, table.data_ptr(), y.data_ptr(),
            None if ws is None else ws.data_ptr(), *ints, stream)
    if rc != 0:
        raise RuntimeError(f"kernel A launch failed: cudaError {rc}")
    _count(untangled_deconv2d, None, scales, whole)
    return y


untangled_deconv2d.launches = 0
untangled_deconv2d.launches_int8 = 0
untangled_deconv2d.launches_rows = 0
untangled_deconv2d.launches_tiled = 0
untangled_deconv2d.launches_tiled_int8 = 0
untangled_deconv2d.launches_tiled_rows = 0


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


def untangled_conv2d_superpack_rows_ref(x: torch.Tensor, block: torch.Tensor,
                                        *, rows: Pair, taps_hw: Pair,
                                        strides: Pair = (1, 1),
                                        rhs_dilation: Pair = (1, 1),
                                        out_dtype=None,
                                        scales=None) -> torch.Tensor:
    """Plain PyTorch version of kernel B on a row-parallel block: ``block``
    holds superpack rows ``rows`` = [r0, r1) only (with ``scales``, int8
    codes and their scale rows); the f32 partial sum over those rows,
    ``untangled_conv2d_superpack_ref`` on the block in its rows of an
    otherwise zero superpack.  Summed over every rank's block it is
    ``untangled_conv2d_superpack_ref``."""
    total = taps_hw[0] * taps_hw[1] * x.shape[3]
    whole, wscales = embed_rows(block, scales, rows, total)
    return untangled_conv2d_superpack_ref(
        x, whole, taps_hw=taps_hw, strides=strides,
        rhs_dilation=rhs_dilation, out_dtype=out_dtype, scales=wscales)


# kernel B's tiles (BM, BN, blocks an SM holds: the kernel's MINB), indexed
# as in csrc/untangled_conv.cu's dispatch; every tile walks the flat K
# range in chunks of _CONV_BK superpack rows.  BN follows N, BM the rows
# (``_conv_config``); the last is the thin-N tile (N <= _THIN_N)
_CONV_CONFIGS = ((128, 128, 1), (64, 128, 2), (32, 128, 2), (16, 128, 2),
                 (128, 64, 2), (64, 64, 2), (32, 64, 2), (16, 64, 2),
                 (128, 32, 2), (64, 32, 2), (128, 16, 2))
_CONV_THIN = 10
_CONV_BK = 16
# BM = 128 when that tile alone gives this many units (0.9 of the card)
_CONV_BIG_TILE_UNITS = 120
# the split's second pass (a launch and a read of the partial tiles), in
# the K chunks of _makespan
_SPLIT_COST = 6


def _conv_tile(bm: int, bn: int) -> int | None:
    """The index of kernel B's (BM, BN) tile, or None."""
    return next((i for i, t in enumerate(_CONV_CONFIGS) if t[:2] == (bm, bn)),
                None)


@dataclasses.dataclass(frozen=True)
class ConvSchedule:
    """How kernel B covers one call: the tile ``config`` (an index into
    ``_CONV_CONFIGS``), K in ``chunks`` chunks of ``_CONV_BK`` superpack
    rows, ``chunk_len`` chunks a slice (at least ``chunks`` when K is not
    split), the M tiles and K slices, the grid (work units over (M tile,
    slice), N tiles) and the f32 workspace of the split's partial tiles (0
    bytes: no split, no second pass)."""
    config: int
    chunks: int
    chunk_len: int
    m_tiles: int
    slices: int
    grid: tuple[int, int]
    workspace_bytes: int

    @property
    def tile(self) -> tuple[int, int]:
        return _CONV_CONFIGS[self.config][:2]

    @property
    def bk(self) -> int:
        return _CONV_BK

    @property
    def split(self) -> bool:
        return self.workspace_bytes > 0

    @property
    def units(self) -> int:
        return self.grid[0] * self.grid[1]

    @property
    def cost(self) -> int:
        """The modelled time: the greedy makespan of the units on the
        card's block slots (132 times the blocks an SM holds of this tile),
        plus ``_SPLIT_COST`` for a split's second pass."""
        return _makespan(self.unit_chunks(),
                         SMS * _CONV_CONFIGS[self.config][2]) \
            + (_SPLIT_COST if self.split else 0)

    def unit_chunks(self) -> list[int]:
        """K chunks of every work unit in launch order (x fastest)."""
        per_tile = [_slice_begin(self.chunks, self.slices, i + 1)
                    - _slice_begin(self.chunks, self.slices, i)
                    for i in range(self.slices)]
        return per_tile * (self.m_tiles * self.grid[1])


def _conv_config(m: int, n: int) -> int:
    """Kernel B's first tile for M output rows and N output channels: the
    thin tile for N <= 16; else BN is the smallest of 32, 64 and 128 that
    holds min(N, 128), and BM is 128 when that tile alone gives
    ``_CONV_BIG_TILE_UNITS`` units, else it follows the rows (64, 32 or 16;
    64 the least beside BN = 32)."""
    if n <= _THIN_N:
        return _CONV_THIN
    bn = 32 if n <= 32 else 64 if n <= 64 else 128
    if -(-m // 128) * -(-n // bn) >= _CONV_BIG_TILE_UNITS:
        return _conv_tile(128, bn)
    bm = 64 if m > 32 or bn == 32 else 32 if m > 16 else 16
    return _conv_tile(bm, bn)


def _conv_schedule(config: int, m: int, chunks: int, n: int,
                   chunk_len: int) -> ConvSchedule:
    bm, bn, _ = _CONV_CONFIGS[config]
    m_tiles, slices = -(-m // bm), _n_slices(chunks, chunk_len)
    gn = -(-n // bn)
    return ConvSchedule(
        config=config, chunks=chunks, chunk_len=chunk_len, m_tiles=m_tiles,
        slices=slices, grid=(m_tiles * slices, gn),
        workspace_bytes=4 * m_tiles * slices * gn * bm * bn
        if slices > 1 else 0)


def _conv_splits(config: int, m: int, chunks: int, n: int):
    """The split schedules one tile may take: every slice length L giving
    at least 132 units (or as many as one-chunk slices give), at most
    ``_UNITS_MAX``, within ``_WORKSPACE_MAX``."""
    most = _conv_schedule(config, m, chunks, n, 1).units
    for length in sorted({-(-chunks // j) for j in range(2, chunks + 1)},
                         reverse=True):
        sch = _conv_schedule(config, m, chunks, n, length)
        if sch.units > _UNITS_MAX or sch.workspace_bytes > _WORKSPACE_MAX:
            break
        if sch.units >= min(SMS, most):
            yield sch


def _conv_best(config: int, m: int, chunks: int, n: int) -> ConvSchedule:
    """The schedule of one tile: of the unsplit one and the splits
    (``_conv_splits``), the least ``cost``; the unsplit one on a tie."""
    whole = _conv_schedule(config, m, chunks, n, max(chunks, 1))
    if whole.units > _UNITS_MAX:
        return whole                    # every split has more units still
    return min([whole, *_conv_splits(config, m, chunks, n)],
               key=lambda sch: sch.cost)


@functools.lru_cache(maxsize=1024)
def conv_schedule(m_rows: int, k: int, n: int) -> ConvSchedule:
    """Kernel B's schedule for a call of ``m_rows`` = B·OH·OW output rows,
    ``k`` = R·S·C superpack rows and N output channels (f32 and int8
    entries alike).  K is split into slices of one length L only where
    that lowers the modelled time (``ConvSchedule.cost``: the makespan on
    the card's block slots plus the second pass), the rule that won on an
    H100 (PERF.md): a 128x128 grid of 120-132 units, one block an SM,
    runs unsplit in one wave, since a split's second pass costs more than
    the last few idle SMs; the two-block tiles split until they fill both
    slots of every SM; a K of a few chunks is not worth a second pass.
    Where a split leaves slices shorter than ``_MIN_SLICE`` chunks, or an
    unsplit grid leaves SMs idle, the M tile steps down (64 -> 32 -> 16)
    for more tiles."""
    chunks = -(-k // _CONV_BK)
    config = _conv_config(m_rows, n)
    while True:
        sch = _conv_best(config, m_rows, chunks, n)
        bm, bn = sch.tile
        smaller = _conv_tile(bm // 2, bn) if bm in (64, 32) else None
        if smaller is not None and (
                sch.chunk_len < _MIN_SLICE if sch.split
                else sch.units < SMS):
            config = smaller
            continue
        return sch


# the C entries' parameters, as for kernel A
_CONV_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 22
                  + [ctypes.c_void_p])
_CONV_ARGTYPES_I8 = [ctypes.c_void_p] + _CONV_ARGTYPES


def conv_launch_ints(x: torch.Tensor, superpack: torch.Tensor,
                     y: torch.Tensor, taps_hw: Pair, strides: Pair,
                     rhs_dilation: Pair, rows=None):
    """Kernel B's schedule for a call and the C entry's int arguments after
    its pointers: the geometry, the tile, the plane's 16-byte path (C % 4
    == 0, aligned plane; for a row block also its first row and its rows
    a multiple of 4), the superpack's and output's (N % 4 == 0, every
    operand aligned), the schedule's slice length, grid and M tiles, and
    the call's superpack rows (first row, rows: ``rows`` = (r0, r1), or
    all of them).  The f32 and int8 entries take the same ones (int8 codes
    need 4-byte, f32 16-byte alignment)."""
    b, hp, wp, c = x.shape
    _, oh, ow, n = y.shape
    r, s = taps_hw
    k0, k1 = (0, r * s * c) if rows is None else rows
    sch = conv_schedule(b * oh * ow, k1 - k0, n)
    if sch.grid[1] > _GRID_YZ_MAX or sch.grid[0] > _INT32_MAX:
        raise ValueError(f"kernel B: N {n} or batch {b} beyond the grid")
    return sch, (b, hp, wp, c, n, oh, ow, r, s, strides[0], strides[1],
                 rhs_dilation[0], rhs_dilation[1], sch.config,
                 int(_vec_ok(c, 4, (x,)) and k0 % 4 == 0
                     and (k1 - k0) % 4 == 0),
                 _vec_ok(4, n, (superpack, y)), sch.chunk_len, sch.grid[0],
                 sch.grid[1], sch.m_tiles, k0, k1 - k0)


@functools.cache
def _conv_entry(int8: bool = False):
    if int8:
        return _bind("untangled_conv", "untangled_conv2d_i8",
                     _CONV_ARGTYPES_I8)
    return _bind("untangled_conv", "untangled_conv2d_f32", _CONV_ARGTYPES)


def untangled_conv2d_superpack(x: torch.Tensor, superpack: torch.Tensor, *,
                               taps_hw: Pair, strides: Pair = (1, 1),
                               rhs_dilation: Pair = (1, 1), out_dtype=None,
                               scales: torch.Tensor | None = None,
                               sp_tiles: Pair | None = None,
                               rows: Pair | None = None) -> torch.Tensor:
    """ONE launch of the valid (pre-padded) untangled correlation.

    x: (B, Hp, Wp, C) padded plane; superpack: (R·S·C, N) tap-major
    (``ConvPlan.pack``).  Strided and dilated kinds run the same kernel:
    dilation only moves each tap's read origin.  ``scales`` ((R·S·C, 1)
    f32) marks ``superpack`` as int8 codes and takes the int8 entry.
    ``sp_tiles=(T_oh, T_ow)`` takes the spatially tiled kernel C.
    ``rows=(r0, r1)``: ``superpack`` (and ``scales``) hold those superpack
    rows only, a row-parallel block, and the result is the f32 partial sum
    over them (B or C; the launch reads the block and nothing else of the
    weights).  Returns (B, OH, OW, N).  CUDA tensors launch the kernel
    (float32 plane, contiguous, no grad) and count one in
    ``untangled_conv2d_superpack.launches`` (f32), ``.launches_int8``,
    ``.launches_tiled`` or ``.launches_tiled_int8`` (a row block's launch
    also in ``.launches_rows`` or ``.launches_tiled_rows``); CPU tensors
    run ``untangled_conv2d_superpack_ref``, its tiled form or their row
    forms ``*_rows_ref``."""
    if x.dim() != 4 or superpack.dim() != 2:
        raise ValueError(f"want x (B, Hp, Wp, C) and superpack (R·S·C, N), "
                         f"got {tuple(x.shape)} and {tuple(superpack.shape)}")
    b, hp, wp, c = x.shape
    r, s = taps_hw
    n = superpack.shape[1]
    whole = rows is None
    if whole and superpack.shape[0] != r * s * c:
        raise ValueError(f"superpack has {superpack.shape[0]} rows, taps "
                         f"{taps_hw} need {r}·{s}·{c}")
    rows = _check_rows("kernel B", rows, r * s * c, superpack.shape[0])
    oh, ow = single_out_hw(hp, wp, taps_hw, strides, rhs_dilation)
    if oh <= 0 or ow <= 0 or min(*strides, *rhs_dilation) < 1:
        raise ValueError(f"no valid output: plane {hp}x{wp}, taps "
                         f"{taps_hw}, strides {strides}, dilation "
                         f"{rhs_dilation}")
    out_dtype = out_dtype or x.dtype
    if sp_tiles is not None:
        sp_tiles = (min(sp_tiles[0], oh), min(sp_tiles[1], ow))
        if min(sp_tiles) < 1:
            raise ValueError(f"sp_tiles {sp_tiles} must be positive")
    if x.device.type == "cpu" and superpack.device.type == "cpu":
        if not whole and sp_tiles is not None:
            return untangled_conv2d_superpack_tiled_rows_ref(
                x, superpack, rows=rows, taps_hw=taps_hw, sp_tiles=sp_tiles,
                strides=strides, rhs_dilation=rhs_dilation,
                out_dtype=out_dtype, scales=scales)
        if not whole:
            return untangled_conv2d_superpack_rows_ref(
                x, superpack, rows=rows, taps_hw=taps_hw, strides=strides,
                rhs_dilation=rhs_dilation, out_dtype=out_dtype,
                scales=scales)
        if sp_tiles is not None:
            return untangled_conv2d_superpack_tiled_ref(
                x, superpack, taps_hw=taps_hw, sp_tiles=sp_tiles,
                strides=strides, rhs_dilation=rhs_dilation,
                out_dtype=out_dtype, scales=scales)
        return untangled_conv2d_superpack_ref(
            x, superpack, taps_hw=taps_hw, strides=strides,
            rhs_dilation=rhs_dilation, out_dtype=out_dtype, scales=scales)
    name = "kernel B" if sp_tiles is None else "kernel C"
    if (x.device.type != "cuda" and not fake.is_fake(x)) \
            or superpack.device != x.device:
        raise ValueError(f"{name} needs both operands on one CUDA device, "
                         f"got {x.device} and {superpack.device}")
    if x.requires_grad or superpack.requires_grad or (
            scales is not None and scales.requires_grad):
        raise NotImplementedError(
            f"{name} has no backward of its own: differentiate through "
            "ConvPlan.apply (its autograd Function runs _ps_bwd)")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} takes a float32 x, got {x.dtype}")
    _check_weights(name, superpack, scales)
    for arg, t in (("x", x), ("superpack", superpack)):
        if not t.is_contiguous():
            raise ValueError(f"{name} takes a contiguous {arg}")
    if out_dtype != torch.float32:
        raise TypeError(f"{name} writes float32, asked for {out_dtype}")
    y = torch.empty((b, oh, ow, n), dtype=torch.float32, device=x.device)
    if max(x.numel(), superpack.numel(), y.numel()) > _INT32_MAX:
        raise ValueError(f"{name} indexes with int32: tensor too large")
    if y.numel() == 0:
        return y
    if fake.is_fake(x):
        name = ("B" if sp_tiles is None else "C") + (
            "" if scales is None else "_int8")
        fake.launched(name, work_conv(
            x, superpack, y, scales,
            None if sp_tiles is None else r * s * c))
        return y
    if sp_tiles is not None:
        _launch_tiled_conv(x, superpack, scales, y, taps_hw, strides,
                           rhs_dilation, sp_tiles, rows)
        _count(untangled_conv2d_superpack, sp_tiles, scales, whole)
        return y
    sch, ints = conv_launch_ints(x, superpack, y, taps_hw, strides,
                                 rhs_dilation, None if whole else rows)
    ws = torch.empty(sch.workspace_bytes // 4, dtype=torch.float32,
                     device=x.device) if sch.split else None
    weights = (superpack.data_ptr(),) if scales is None else (
        superpack.data_ptr(), scales.data_ptr())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _conv_entry(scales is not None)(
            x.data_ptr(), *weights, y.data_ptr(),
            None if ws is None else ws.data_ptr(), *ints, stream)
    if rc != 0:
        raise RuntimeError(f"kernel B launch failed: cudaError {rc}")
    _count(untangled_conv2d_superpack, None, scales, whole)
    return y


untangled_conv2d_superpack.launches = 0
untangled_conv2d_superpack.launches_int8 = 0
untangled_conv2d_superpack.launches_rows = 0
untangled_conv2d_superpack.launches_tiled = 0
untangled_conv2d_superpack.launches_tiled_int8 = 0
untangled_conv2d_superpack.launches_tiled_rows = 0


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


# ---------------------------------------------------------------------------
# kernels C and D: the spatially tiled forms of B and A
# ---------------------------------------------------------------------------

def halo_extent(tile: int, taps: int, stride: int, dilation: int) -> int:
    """Input rows one halo'd output tile needs along one dim: the strided
    tile footprint plus the dilated tap reach ``(T-1)·d``."""
    return (tile - 1) * stride + (taps - 1) * dilation + 1


def deconv_tap_span(phases) -> tuple[Pair, Pair]:
    """``((min_h, max_h), (min_w, max_w))`` tap-origin span over the
    non-empty phases: phase q's taps read the padded plane at rows
    ``xoff_h + t_i + u``, so a halo'd tile of ``T_u`` phase-output rows
    spans ``(max - min) + T_u`` input rows from ``min + i·T_u``."""
    live = [ex for ex in phases if ex.taps[0] * ex.taps[1] > 0]
    if not live:
        raise ValueError("deconv_tap_span needs at least one non-empty "
                         "phase")
    return ((min(ex.xoff[0] for ex in live),
             max(ex.xoff[0] + ex.taps[0] - 1 for ex in live)),
            (min(ex.xoff[1] for ex in live),
             max(ex.xoff[1] + ex.taps[1] - 1 for ex in live)))


# shared memory of one H100 block (227 KB) and of one SM (228 KB, less 1
# KB reserved per block)
SMEM_BLOCK_MAX = 232448
SMEM_SM = 233472
SMEM_RESERVED = 1024


# kernel C (csrc/untangled_conv_tiled.cu): a thread holds _TC_TM output
# pixels of one tile row x _TC_TN channels; C is walked in chunks of _TC_CK
# channels, one 16-byte group a halo pixel.  BN follows N; per BN the
# block's threads and the blocks an SM holds (the kernel's Block<BN>,
# asked of ptxas as __launch_bounds__)
_TC_TM, _TC_TN, _TC_CK = 8, 4, 4
_TILED_CONV_BLOCKS = {4: (128, 2), 32: (256, 2), 64: (256, 2),
                      128: (256, 2)}
# ring slots, most first: the first whose block fits its share of the SM
_TC_STAGES = (4, 3)
_TC_INT8_MIN_STAGES = 3


def tiled_conv_bn(n: int) -> int:
    """Kernel C's BN for N output channels: 4 for N <= 4 (the RGB head),
    else the smallest of 32, 64 and 128 that holds min(N, 128)."""
    return 4 if n <= 4 else 32 if n <= 32 else 64 if n <= 64 else 128


def tiled_conv_path(taps_hw: Pair, strides: Pair, dilation: Pair) -> int:
    """Kernel C's tap loop: 1 for 3x3 taps with s_w = 1 (a thread's pixels
    spaced d_w apart, each span value read once for all three taps of a
    row), 2 for 3x3 with s_w = 2 and d_w = 1 (the same with span 2k + n),
    else 0 (taps, strides and dilations at run time)."""
    if tuple(taps_hw) != (3, 3):
        return 0
    if strides[1] == 1:
        return 1
    return 2 if strides[1] == 2 and dilation[1] == 1 else 0


def tiled_halo_unit(col: int) -> int:
    """The staged 16-byte unit of halo column ``col`` in its row: one pad
    unit every 8 columns (the kernel's ``halo_unit``)."""
    return col + col // 8


def tiled_conv_smem_bytes(bn: int, tin_h: int, pitch: int, taps: int,
                          stages: int, int8: bool = False) -> int:
    """Dynamic shared memory of one kernel-C or kernel-D block: ``stages``
    halo slots of ``tin_h`` rows x ``pitch`` 16-byte units and, for f32, as
    many weight slots of ``taps·4·BN`` floats (D: the superpack's taps of
    every phase); int8 keeps two f32 weight tiles and the ring's row scales
    and codes instead.  The kernels' ``smem_bytes``."""
    halo = tin_h * pitch * 16
    wt = 4 * taps * _TC_CK * bn
    if not int8:
        return stages * (halo + wt)
    return stages * (halo + 4 * taps * _TC_CK + taps * _TC_CK * bn) + 2 * wt


@dataclasses.dataclass(frozen=True)
class TiledConvSchedule:
    """How kernel C covers one call: the block's N width ``bn``, its tap
    loop ``path`` (``tiled_conv_path``), the output tile ``(T_oh, T_ow)``,
    the columns ``pd`` between a thread's pixels and the pixel groups
    ``gpr`` a tile row, the staged halo ``(tin_h, tin_w)`` and its row
    ``pitch`` in 16-byte units, the ring's ``stages``, the block's threads,
    the blocks an SM holds, the larger of the f32 and int8 entries' shared
    memory, the channel chunk, the tiles over the output, the taps and
    C."""
    bn: int
    path: int
    tile: Pair
    pd: int
    gpr: int
    halo: Pair
    pitch: int
    stages: int
    threads: int
    blocks_sm: int
    smem_bytes: int
    chunk: int
    tiles: Pair
    taps: int
    c: int

    @property
    def groups(self) -> int:
        """Pixel groups (of ``_TC_TM`` pixels) a block."""
        return self.threads // (self.bn // _TC_TN)

    @property
    def fits_sm(self) -> bool:
        """Whether ``blocks_sm`` blocks share one SM's shared memory."""
        return self.blocks_sm * (self.smem_bytes + SMEM_RESERVED) <= SMEM_SM

    @property
    def k_steps(self) -> int:
        """Multiply-adds a pixel and channel: taps x the chunks' channels
        (C rounded up to the chunk)."""
        return self.taps * self.chunk * -(-self.c // self.chunk)

    def grid(self, b: int, n: int) -> tuple[int, int, int]:
        return (self.tiles[0] * self.tiles[1], -(-n // self.bn), b)


def _tc_layout(tile: Pair, taps_hw: Pair, strides: Pair, dilation: Pair,
               bn: int, path: int):
    """(pd, gpr, (tin_h, tin_w), pitch) of one tile, or None when its rows
    of pixel groups exceed the block's.  The staged halo covers the tile
    widened to whole pixel groups, which idle pixels read."""
    (r, s), (sh, sw), (dh, dw) = taps_hw, strides, dilation
    threads, _ = _TILED_CONV_BLOCKS[bn]
    pd = dw if path == 1 else 1
    span = _TC_TM * pd
    blocks = -(-tile[1] // span)
    gpr = blocks * pd
    if tile[0] * gpr > threads // (bn // _TC_TN):
        return None
    tin_h = halo_extent(tile[0], r, sh, dh)
    tin_w = halo_extent(blocks * span, s, sw, dw)
    return pd, gpr, (tin_h, tin_w), tiled_halo_unit(tin_w - 1) + 1


def _tc_schedule(tile: Pair, out_hw: Pair, taps_hw: Pair, strides: Pair,
                 dilation: Pair, c: int, bn: int, path: int):
    """The schedule of one tile, with the most stages whose block (either
    entry) fits its share of the SM; None when the tile does not fit a
    block."""
    lay = _tc_layout(tile, taps_hw, strides, dilation, bn, path)
    if lay is None:
        return None
    pd, gpr, tin, pitch = lay
    threads, blocks_sm = _TILED_CONV_BLOCKS[bn]
    taps = taps_hw[0] * taps_hw[1]
    share = SMEM_SM // blocks_sm - SMEM_RESERVED
    stages = None
    for st in _TC_STAGES:
        smem = max(tiled_conv_smem_bytes(bn, tin[0], pitch, taps, st, i8)
                   for i8 in (False, True))
        if smem <= share or (st == _TC_STAGES[-1]
                             and smem <= SMEM_BLOCK_MAX):
            stages = st
            break
    if stages is None:
        return None
    return TiledConvSchedule(
        bn=bn, path=path, tile=tile, pd=pd, gpr=gpr, halo=tin, pitch=pitch,
        stages=stages, threads=threads, blocks_sm=blocks_sm, smem_bytes=smem,
        chunk=_TC_CK, tiles=(-(-out_hw[0] // tile[0]),
                             -(-out_hw[1] // tile[1])), taps=taps, c=c)


def _tc_best(out_hw: Pair, taps_hw: Pair, strides: Pair, dilation: Pair,
             c: int, bn: int, tile: Pair | None):
    """The schedule at one BN: the caller's tile, or the card's best."""
    threads, _ = _TILED_CONV_BLOCKS[bn]
    groups = threads // (bn // _TC_TN)
    path = tiled_conv_path(taps_hw, strides, dilation)
    if path == 1 and dilation[1] > groups:
        path = 0                # a row of d_w pixel groups would not fit
    pd = dilation[1] if path == 1 else 1
    args = (out_hw, taps_hw, strides, dilation, c, bn, path)
    if tile is not None:
        return _tc_schedule(tile, *args)
    best = None
    for blocks in _pow2_tiles(groups // pd):
        gpr = blocks * pd
        cand = (min(groups // gpr, out_hw[0]),
                min(blocks * _TC_TM * pd, out_hw[1]))
        sch = _tc_schedule(cand, *args)
        if sch is None:
            continue
        key = (not sch.fits_sm,
               sch.tiles[0] * sch.tiles[1] * (sch.halo[0] * sch.halo[1]
                                              + sch.taps * bn), -cand[1])
        if best is None or key < best[0]:
            best = (key, sch)
    return None if best is None else best[1]


@functools.lru_cache(maxsize=1024)
def tiled_conv_schedule(out_hw: Pair, taps_hw: Pair, strides: Pair,
                        dilation: Pair, c: int, n: int,
                        tile: Pair | None = None) -> TiledConvSchedule | None:
    """Kernel C's schedule for an output of ``out_hw`` pixels, ``taps_hw``
    taps, strides, dilation, C input and N output channels (f32 and int8
    entries alike); ``tile`` given (a caller's ``sp_tiles``) is kept, else
    the card's tile is picked.  BN follows N (``tiled_conv_bn``), stepping
    down (128 -> 64 -> 32) only where the ring's weight slots of every tap
    would not let the block share its SM (the 7x7 fixture site).  A block
    holds ``groups`` rows of ``_TC_TM`` pixels, ``gpr`` of them a tile
    row, so ``T_ow`` is a power-of-two number of pixel groups' columns and
    ``T_oh`` fills the block.  Of those tiles (clipped to the output) the
    one that stages the fewest bytes over the plane — halo pixels plus
    weight rows of every tile, both times C — is taken, ``blocks_sm``
    blocks an SM first, the wider tile on a tie.  Returns None when no
    tile fits a block (a caller's tile with too many pixel rows or too
    much halo)."""
    out_hw, taps_hw = tuple(out_hw), tuple(taps_hw)
    strides, dilation = tuple(strides), tuple(dilation)
    tile = None if tile is None else tuple(tile)
    top = tiled_conv_bn(n)
    fallback = None
    for bn in (top,) if top == 4 else [b for b in (128, 64, 32) if b <= top]:
        sch = _tc_best(out_hw, taps_hw, strides, dilation, c, bn, tile)
        if sch is not None and sch.fits_sm:
            return sch
        fallback = fallback or sch
    return fallback


def _pow2_tiles(p: int) -> tuple[int, ...]:
    return tuple(1 << i for i in range(p.bit_length()) if (1 << i) <= p)


def pick_block_tile_single(out_hw: Pair, taps_hw: Pair, strides: Pair,
                           dilation: Pair, n: int) -> Pair | None:
    """Kernel C's spatial output tile ``(T_oh, T_ow)`` for one block: the
    tile of ``tiled_conv_schedule``, or None when none fits a block (the
    tile does not depend on C)."""
    sch = tiled_conv_schedule(tuple(out_hw), tuple(taps_hw), tuple(strides),
                              tuple(dilation), _TC_CK, n)
    return None if sch is None else sch.tile


# kernel D (csrc/untangled_deconv_tiled.cu): C in chunks of _TC_CK channels,
# as kernel C.  Per (tap loop, BN) the instantiated register splits (TM
# pixels of a tile row, TP phases a thread, threads a block, blocks an SM
# asked of ptxas), the schedule's first: the kernel's D_VARIANT lines.  At
# BN 32 (the U-Net's up0) the second is there for the sweep
# (tools/time_kernel_d.py --sweep): 8 pixels x 4 phases at one block an SM
# (255 registers) measured 2-3% faster in f32 than 8 x 2 at two blocks an
# SM at B = 1 and 16 (8 x 1 and 8 x 2 at 512 threads were slower still)
_TD_VARIANTS = {
    (0, 4): ((8, 1, 256, 2),), (0, 32): ((8, 1, 256, 2),),
    (0, 64): ((8, 1, 256, 2),), (0, 128): ((8, 1, 256, 2),),
    (1, 4): ((8, 2, 256, 2),),
    (1, 32): ((8, 4, 256, 1), (8, 2, 256, 2)),
    (1, 64): ((8, 2, 256, 2),), (1, 128): ((8, 2, 256, 2),)}
# ring slots, most first: the first whose block fits its share of the SM
_TD_STAGES = (4, 3)
_WARP = 32


def tiled_deconv_path(phases) -> int:
    """Kernel D's tap loop: 1 where every phase has 2x2 taps at one xoff
    (k = 2·s: the phases read one halo window and differ only in their
    weights, so they are extra output columns of one correlation and a
    thread serves its phases from one read) and phase q's taps are
    superpack taps 4q .. 4q + 3 (as ``plan_conv`` packs them), else 0
    (taps and offsets at run time, each phase in its own threads)."""
    first = phases[0]
    return int(all(ex.taps == (2, 2) and ex.xoff == first.xoff
                   and ex.tap_off == 4 * i for i, ex in enumerate(phases)))


@dataclasses.dataclass(frozen=True)
class TiledDeconvSchedule:
    """How kernel D covers one call: the tap loop ``path``
    (``tiled_deconv_path``), the block's N width ``bn``, the register split
    (``tm`` pixels of a tile row x ``tp`` phases x 4 channels a thread,
    ``threads`` a block, ``blocks_sm`` blocks an SM), the tile ``(T_u,
    T_v)`` of phase-output pixels, the pixel groups ``gpr`` a tile row and
    ``gpp`` a phase (path 1: the block's), the staged halo ``(tin_h,
    tin_w)`` from ``origin`` (the tap span's minimum) and its row ``pitch``
    in 16-byte units, the ring's ``stages``, the larger of the f32 and int8
    entries' shared memory, the channel chunk, the tiles over (U, V), the
    phases, the superpack's taps and C."""
    path: int
    bn: int
    tm: int
    tp: int
    threads: int
    blocks_sm: int
    tile: Pair
    gpr: int
    gpp: int
    halo: Pair
    origin: Pair
    pitch: int
    stages: int
    smem_bytes: int
    chunk: int
    tiles: Pair
    phases: int
    taps: int
    c: int

    @property
    def column_groups(self) -> int:
        """Threads that share a pixel group: its phases (path 1) and
        channels, ``tp`` x 4 a thread."""
        return (self.phases // self.tp if self.path == 1 else 1) \
            * (self.bn // _TC_TN)

    @property
    def fits_sm(self) -> bool:
        """Whether ``blocks_sm`` blocks share one SM's shared memory."""
        return self.blocks_sm * (self.smem_bytes + SMEM_RESERVED) <= SMEM_SM

    def grid(self, b: int, n: int) -> tuple[int, int, int]:
        return (self.tiles[0] * self.tiles[1], -(-n // self.bn), b)


def _td_schedule(tile: Pair, phases, c: int, bn: int, path: int,
                 variant) -> TiledDeconvSchedule | None:
    """The schedule of one tile under one register split, with the most
    stages whose block (either entry) fits its share of the SM; None when
    the tile does not fit the block's pixel groups or shared memory."""
    tm, tp, threads, blocks_sm = variant
    p = len(phases)
    ncg = (p // tp if path == 1 else 1) * (bn // _TC_TN)
    if p % tp or threads % ncg:
        return None
    gpp = threads // ncg // (1 if path == 1 else p)
    gpr = -(-tile[1] // tm)
    if gpp < 1 or tile[0] * gpr > gpp:
        return None
    ((mh, xh), (mw, xw)) = deconv_tap_span(phases)
    tin = (xh - mh + tile[0], xw - mw + gpr * tm)
    pitch = tiled_halo_unit(tin[1] - 1) + 1
    taps = sum(ex.taps[0] * ex.taps[1] for ex in phases)
    share = SMEM_SM // blocks_sm - SMEM_RESERVED
    for stages in _TD_STAGES:
        smem = max(tiled_conv_smem_bytes(bn, tin[0], pitch, taps, stages, i8)
                   for i8 in (False, True))
        if smem <= share or (stages == _TD_STAGES[-1]
                             and smem <= SMEM_BLOCK_MAX):
            break
    else:
        return None
    uu, vv = phases[0].out_hw
    return TiledDeconvSchedule(
        path=path, bn=bn, tm=tm, tp=tp, threads=threads, blocks_sm=blocks_sm,
        tile=tile, gpr=gpr, gpp=gpp, halo=tin, origin=(mh, mw), pitch=pitch,
        stages=stages, smem_bytes=smem, chunk=_TC_CK,
        tiles=(-(-uu // tile[0]), -(-vv // tile[1])), phases=p, taps=taps,
        c=c)


def _td_best(phases, c: int, bn: int, path: int, variant,
             tile: Pair | None) -> TiledDeconvSchedule | None:
    """The schedule at one BN and split: the caller's tile, or the card's
    best.  The card's tiles are ``rows x gpr`` pixel groups filling the
    block (path 0: a phase's share), a warp's groups in one tile row where
    the plane is that wide (so its span reads fall on distinct bank
    groups), rows following the columns a narrow plane leaves; of those the tile
    that stages the fewest bytes over the plane — halo pixels plus weight
    rows of every tile — is taken, ``blocks_sm`` blocks an SM first, the
    wider tile on a tie."""
    if tile is not None:
        return _td_schedule(tile, phases, c, bn, path, variant)
    tm, tp, threads, _ = variant
    p = len(phases)
    if p % tp:
        return None
    ncg = (p // tp if path == 1 else 1) * (bn // _TC_TN)
    cap = threads // ncg // (1 if path == 1 else p)
    warp_groups = max(1, _WARP // ncg) if path == 1 else 1
    uu, vv = phases[0].out_hw
    best = None
    for gpr in _pow2_tiles(cap):
        if gpr < min(cap, warp_groups):
            continue
        t_v = min(gpr * tm, vv)
        cand = (min(cap // -(-t_v // tm), uu), t_v)
        sch = _td_schedule(cand, phases, c, bn, path, variant)
        if sch is None:
            continue
        key = (not sch.fits_sm,
               sch.tiles[0] * sch.tiles[1] * (sch.halo[0] * sch.halo[1]
                                              + sch.taps * bn), -cand[1])
        if best is None or key < best[0]:
            best = (key, sch)
    return None if best is None else best[1]


@functools.lru_cache(maxsize=1024)
def tiled_deconv_schedule(phases: tuple, out_hw: Pair, c: int, n: int,
                          tile: Pair | None = None
                          ) -> TiledDeconvSchedule | None:
    """Kernel D's schedule for the uniform ``phases`` of an ``out_hw``
    output, C input and N output channels (f32 and int8 entries alike);
    ``tile`` given (a caller's ``sp_tiles``) is kept, else the card's tile
    is picked.  Path 1 (``tiled_deconv_path``) first, with the first split
    of ``_TD_VARIANTS``, then path 0; BN follows N (``tiled_conv_bn``),
    stepping down (128 -> 64 -> 32) only where the block would not fit its
    share of the SM (or its pixel groups would not hold a phase each).
    Returns None when no layout fits a block (a caller's tile with too many
    pixel rows or too much halo)."""
    phases, out_hw = tuple(phases), tuple(out_hw)
    tile = None if tile is None else tuple(tile)
    uu, vv = phases[0].out_hw
    if any(ex.out_hw != (uu, vv) for ex in phases) \
            or len(phases) * uu * vv != out_hw[0] * out_hw[1]:
        raise ValueError(f"kernel D needs uniform phases covering {out_hw}")
    top = tiled_conv_bn(n)
    bns = (top,) if top == 4 else [b for b in (128, 64, 32) if b <= top]
    fallback = None
    for path in (1, 0) if tiled_deconv_path(phases) else (0,):
        for bn in bns:
            sch = _td_best(phases, c, bn, path, _TD_VARIANTS[(path, bn)][0],
                           tile)
            if sch is not None and sch.fits_sm:
                return sch
            fallback = fallback or sch
    return fallback


def pick_block_tile_transposed(phases, n: int) -> Pair | None:
    """Kernel D's spatial tile ``(T_u, T_v)`` in phase-output pixels for
    one block (every phase of the tile in the same block, so each staged
    halo serves all of them): the tile of ``tiled_deconv_schedule``, or
    None when none fits a block (the tile does not depend on C)."""
    phases = tuple(phases)
    uu, vv = phases[0].out_hw
    out_hw = ((1 + max(ex.q[0] for ex in phases)) * uu,
              (1 + max(ex.q[1] for ex in phases)) * vv)
    sch = tiled_deconv_schedule(phases, out_hw, _TC_CK, n)
    return None if sch is None else sch.tile


def _tile_windows(x: torch.Tensor, origin: Pair, step: Pair, n_tiles: Pair,
                  tin: Pair) -> torch.Tensor:
    """The halo'd input slices of every spatial tile as one strided view
    ``(B, n_i, n_j, tin_h, tin_w, C)``: tile (i, j) starts at ``origin +
    (i·step_h, j·step_w)``.  ``x`` must already hold every slice."""
    b, _, _, c = x.shape
    sb, sh, sw, sc = x.stride()
    base = x[:, origin[0]:, origin[1]:, :]
    return base.as_strided(
        (b, n_tiles[0], n_tiles[1], tin[0], tin[1], c),
        (sb, step[0] * sh, step[1] * sw, sh, sw, sc),
        base.storage_offset())


def _grow(x: torch.Tensor, h_need: int, w_need: int) -> torch.Tensor:
    """Zero rows/cols at the bottom/right so every halo slice is in
    bounds; they only feed output pixels that are sliced off."""
    dh, dw = max(0, h_need - x.shape[1]), max(0, w_need - x.shape[2])
    if dh or dw:
        x = torch.nn.functional.pad(x, (0, 0, 0, dw, 0, dh))
    return x


def untangled_conv2d_superpack_tiled_ref(
        x: torch.Tensor, superpack: torch.Tensor, *, taps_hw: Pair,
        sp_tiles: Pair, strides: Pair = (1, 1), rhs_dilation: Pair = (1, 1),
        out_dtype=None, scales=None) -> torch.Tensor:
    """Plain PyTorch version of kernel C: the output in ``(T_oh, T_ow)``
    tiles, each computed from its own halo'd input slice (``halo_extent``
    rows and columns from ``(i·T_oh·s_h, j·T_ow·s_w)``), one product per tap
    across all tiles at once; ragged edge tiles read zeros past the plane
    and their extra pixels are sliced off.  With ``scales`` the superpack
    is int8 codes, dequantized first."""
    b, hp, wp, c = x.shape
    r, s = taps_hw
    (sh, sw), (dh, dw) = strides, rhs_dilation
    oh, ow = single_out_hw(hp, wp, taps_hw, strides, rhs_dilation)
    toh, tow = min(sp_tiles[0], oh), min(sp_tiles[1], ow)
    n_oi, n_oj = -(-oh // toh), -(-ow // tow)
    tin = (halo_extent(toh, r, sh, dh), halo_extent(tow, s, sw, dw))
    x32 = _grow(x.float(), (n_oi - 1) * toh * sh + tin[0],
                (n_oj - 1) * tow * sw + tin[1])
    win = _tile_windows(x32, (0, 0), (toh * sh, tow * sw), (n_oi, n_oj), tin)
    w32 = _weights_f32(superpack, scales)
    acc = None
    for m in range(r):
        for n in range(s):
            xs = win[..., m * dh:m * dh + (toh - 1) * sh + 1:sh,
                     n * dw:n * dw + (tow - 1) * sw + 1:sw, :]
            row = (m * s + n) * c
            term = torch.matmul(xs, w32[row:row + c])
            acc = term if acc is None else acc + term
    y = acc.permute(0, 1, 3, 2, 4, 5).reshape(
        b, n_oi * toh, n_oj * tow, -1)[:, :oh, :ow]
    return y.to(out_dtype or x.dtype)


def untangled_conv2d_superpack_tiled_rows_ref(
        x: torch.Tensor, block: torch.Tensor, *, rows: Pair, taps_hw: Pair,
        sp_tiles: Pair, strides: Pair = (1, 1), rhs_dilation: Pair = (1, 1),
        out_dtype=None, scales=None) -> torch.Tensor:
    """Plain PyTorch version of kernel C on a row-parallel block: ``block``
    holds superpack rows ``rows`` = [r0, r1) only (with ``scales``, int8
    codes and their scale rows); the f32 partial sum over those rows,
    ``untangled_conv2d_superpack_tiled_ref`` on the block in its rows of
    an otherwise zero superpack."""
    total = taps_hw[0] * taps_hw[1] * x.shape[3]
    whole, wscales = embed_rows(block, scales, rows, total)
    return untangled_conv2d_superpack_tiled_ref(
        x, whole, taps_hw=taps_hw, sp_tiles=sp_tiles, strides=strides,
        rhs_dilation=rhs_dilation, out_dtype=out_dtype, scales=wscales)


def _check_uniform(phases, out_hw: Pair, strides: Pair) -> Pair:
    """Kernel D's geometry: every phase of one extent (U, V) with
    ``out = stride·(U, V)``, so the interleaved output tiles block cleanly
    (JAX asserts the same).  Returns (U, V)."""
    uu, vv = phases[0].out_hw
    if any(ex.out_hw != (uu, vv) for ex in phases) \
            or uu * strides[0] != out_hw[0] or vv * strides[1] != out_hw[1]:
        raise ValueError(f"the tiled transposed kernel needs uniform phases "
                         f"with out % stride == 0, got out {out_hw}, "
                         f"strides {strides}, phase extents "
                         f"{sorted({ex.out_hw for ex in phases})}")
    return uu, vv


def untangled_deconv2d_tiled_ref(xg: torch.Tensor, superpack: torch.Tensor,
                                 *, phases, out_hw: Pair, strides: Pair,
                                 sp_tiles: Pair, out_dtype=None,
                                 scales=None) -> torch.Tensor:
    """Plain PyTorch version of kernel D: the output in tiles of ``(T_u,
    T_v)`` phase-output pixels, every phase of a tile computed from one
    halo'd input slice (origin ``min + (i·T_u, j·T_v)`` of
    ``deconv_tap_span``, extent ``(max - min) + T``), phase q's taps at
    ``xoff - min + (t_i, t_j)`` inside it, written interleaved to
    ``y[q_h + s_h·u, q_w + s_w·v]``.  Uniform phases only."""
    b, _, _, c = xg.shape
    sh, sw = strides
    uu, vv = _check_uniform(phases, out_hw, strides)
    tu, tv = min(sp_tiles[0], uu), min(sp_tiles[1], vv)
    n_oi, n_oj = -(-uu // tu), -(-vv // tv)
    ((mh, xh_max), (mw, xw_max)) = deconv_tap_span(phases)
    tin = (xh_max - mh + tu, xw_max - mw + tv)
    x32 = _grow(xg.float(), mh + (n_oi - 1) * tu + tin[0],
                mw + (n_oj - 1) * tv + tin[1])
    win = _tile_windows(x32, (mh, mw), (tu, tv), (n_oi, n_oj), tin)
    w32 = _weights_f32(superpack, scales)
    n = w32.shape[1]
    y = torch.zeros((b, n_oi * tu * sh, n_oj * tv * sw, n),
                    dtype=torch.float32, device=xg.device)
    for ex in phases:
        th, tw = ex.taps
        acc = None
        for t in range(th * tw):
            ti, tj = divmod(t, tw)
            r0, c0 = ex.xoff[0] - mh + ti, ex.xoff[1] - mw + tj
            row = (ex.tap_off + t) * c
            term = torch.matmul(win[..., r0:r0 + tu, c0:c0 + tv, :],
                                w32[row:row + c])
            acc = term if acc is None else acc + term
        if acc is not None:                # empty phase: stays zero
            y[:, ex.q[0]::sh, ex.q[1]::sw] = acc.permute(
                0, 1, 3, 2, 4, 5).reshape(b, n_oi * tu, n_oj * tv, n)
    return y[:, :out_hw[0], :out_hw[1]].to(out_dtype or xg.dtype)


def untangled_deconv2d_tiled_rows_ref(
        xg: torch.Tensor, block: torch.Tensor, *, rows: Pair, phases,
        out_hw: Pair, strides: Pair, sp_tiles: Pair, out_dtype=None,
        scales=None) -> torch.Tensor:
    """Plain PyTorch version of kernel D on a row-parallel block: ``block``
    holds superpack rows ``rows`` = [r0, r1) only (with ``scales``, int8
    codes and their scale rows); the f32 partial sum over those rows,
    ``untangled_deconv2d_tiled_ref`` on the block in its rows of an
    otherwise zero superpack."""
    total = sum(ex.taps[0] * ex.taps[1] for ex in phases) * xg.shape[3]
    whole, wscales = embed_rows(block, scales, rows, total)
    return untangled_deconv2d_tiled_ref(
        xg, whole, phases=phases, out_hw=out_hw, strides=strides,
        sp_tiles=sp_tiles, out_dtype=out_dtype, scales=wscales)


def _tiled_vec_ok(n: int, tensors) -> int:
    """Kernels C's and D's weight and output vector path: N % 4 == 0 and
    the weights and the output aligned for 4-element loads and stores
    (their plane path is ``_vec_ok(c, 4, (x,))``)."""
    return int(n % 4 == 0 and all(
        t.data_ptr() % (4 * t.element_size()) == 0 for t in tensors))


# the C entries' parameters, as for kernels A and B
_CONV_TILED_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 29
                        + [ctypes.c_void_p])
_DECONV_TILED_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 34
                          + [ctypes.c_void_p])


@functools.cache
def _conv_tiled_entry(int8: bool = False):
    if int8:
        return _bind("untangled_conv_tiled", "untangled_conv2d_tiled_i8",
                     [ctypes.c_void_p] + _CONV_TILED_ARGTYPES)
    return _bind("untangled_conv_tiled", "untangled_conv2d_tiled_f32",
                 _CONV_TILED_ARGTYPES)


@functools.cache
def _deconv_tiled_entry(int8: bool = False):
    if int8:
        return _bind("untangled_deconv_tiled", "untangled_deconv2d_tiled_i8",
                     [ctypes.c_void_p] + _DECONV_TILED_ARGTYPES)
    return _bind("untangled_deconv_tiled", "untangled_deconv2d_tiled_f32",
                 _DECONV_TILED_ARGTYPES)


# the grid's y (N tiles) and z (images) extents
_GRID_YZ_MAX = 65535


def _launch_tiled_conv(x, superpack, scales, y, taps_hw, strides, dilation,
                       tile: Pair, rows: Pair):
    """Kernel C (or its int8 entry) on ``tile``-sized blocks, as
    ``tiled_conv_schedule`` lays them out, on the weight operand's
    superpack rows ``rows``; raises when the tile does not fit one
    block."""
    b, hp, wp, c = x.shape
    _, oh, ow, n = y.shape
    r, s = taps_hw
    sch = tiled_conv_schedule((oh, ow), tuple(taps_hw), tuple(strides),
                              tuple(dilation), c, n, tuple(tile))
    if sch is None:
        raise ValueError(f"kernel C: tile {tile} does not fit one block "
                         f"(its pixel rows or its halo)")
    grid = sch.grid(b, n)
    if grid[0] > _INT32_MAX or max(grid[1:]) > _GRID_YZ_MAX:
        raise ValueError(f"kernel C: batch {b} or N {n} beyond the launch "
                         f"grid")
    weights = (superpack.data_ptr(),) if scales is None else (
        superpack.data_ptr(), scales.data_ptr())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _conv_tiled_entry(scales is not None)(
            x.data_ptr(), *weights, y.data_ptr(), b, hp, wp, c, n, oh, ow,
            r, s, strides[0], strides[1], dilation[0], dilation[1],
            *sch.tile, *sch.halo, sch.pitch, *sch.tiles, sch.gpr, sch.pd,
            sch.bn, sch.path, sch.stages, _vec_ok(c, 4, (x,)),
            _tiled_vec_ok(n, (superpack, y)), *rows, stream)
    if rc != 0:
        raise RuntimeError(f"kernel C launch failed: cudaError {rc}")


def _launch_tiled_deconv(xg, superpack, scales, y, phases, strides,
                         tile: Pair, rows: Pair):
    """Kernel D (or its int8 entry) on ``tile``-sized blocks, as
    ``tiled_deconv_schedule`` lays them out, on the weight operand's
    superpack rows ``rows``; raises when the tile does not fit one
    block."""
    b, hg, wg, c = xg.shape
    _, oh, ow, n = y.shape
    sch = tiled_deconv_schedule(phases, (oh, ow), c, n, tuple(tile))
    if sch is None:
        raise ValueError(f"kernel D: tile {tile} does not fit one block "
                         f"(its pixel rows or its halo)")
    grid = sch.grid(b, n)
    if grid[0] > _INT32_MAX or max(grid[1:]) > _GRID_YZ_MAX:
        raise ValueError(f"kernel D: batch {b} or N {n} beyond the launch "
                         f"grid")
    table = _phase_table(phases, xg.device)
    weights = (superpack.data_ptr(),) if scales is None else (
        superpack.data_ptr(), scales.data_ptr())
    with torch.cuda.device(xg.device):
        stream = torch.cuda.current_stream(xg.device).cuda_stream
        rc = _deconv_tiled_entry(scales is not None)(
            xg.data_ptr(), *weights, table.data_ptr(), y.data_ptr(), b, hg,
            wg, c, n, oh, ow, strides[0], strides[1], sch.phases, sch.taps,
            *sch.tile, *phases[0].out_hw, *sch.origin, *sch.halo, sch.pitch,
            *sch.tiles, sch.gpr, sch.gpp, sch.bn, sch.path, sch.tm, sch.tp,
            sch.threads, sch.stages, _vec_ok(c, 4, (xg,)),
            _tiled_vec_ok(n, (superpack, y)), *rows, stream)
    if rc != 0:
        raise RuntimeError(f"kernel D launch failed: cudaError {rc}")
