"""Plane-parallel execution: one conv plane split over the ranks of a
spatial mesh, with halo exchange at the block boundaries.

Counterpart of ``repro.core.spatial``.  A plan's per-bucket ``Route`` may
carry a device-tiling verdict (``Route.dev_tiles``); under a bound spatial
mesh whose extents match it, ``ConvPlan.apply`` runs the conv across the
mesh's ranks: each rank runs the *local plan* (an ordinary ``plan_conv``
of a local spec, so kernels A-D on the 'cuda' route) on its halo'd block,
and point-to-point sends move exactly the halo rows and columns between
neighbours.  The geometry (``DimTiling``, ``SpatialPlan``,
``spatial_plan``) is JAX's, integer for integer:

- device ``d`` owns input rows ``[d·Hl, (d+1)·Hl)`` and output rows
  ``[d·T, (d+1)·T)`` of the plane zero-padded to ``pad_to`` rows;
- single correlation: the slab is ``tin = (T-1)·s + (R-1)·d + 1`` rows
  entered at ``halo_lo = pl``; transposed: ``tin = xh_max + T_u``,
  ``halo_lo = gl``; one hop only (each halo fits in a block);
- edge ranks receive zeros: the conv's own zero padding;
- the local spec has padding ``(0, 0)`` (single kinds) or ``(pl - gl·s,
  ·)`` (transposed; the low pad may be negative, a crop) on a split dim,
  and the transposed local plan's superpack layout is the parent's;
- 2-D tiling exchanges rows first, then the columns of the row-extended
  slab, so the corners come with the columns.

The executor, in the steps that ``try_spatial`` chains:

- ``scatter_plane``: the rank's block of the site's input.  The previous
  split site's output, held as blocks (``PlaneBlocks``) of the same
  layout, is taken as it is; a plain tensor counts as replicated and the
  rank keeps its block of it (its batch slice over 'data' where the batch
  divides, its rows over 'sp_h', its columns over 'sp_w'), and nothing
  moves; the backward gathers the blocks' cotangents into the plane's.
- ``spatial_apply``: the shard_map body.  The padding rows past the
  plane's extent are zeroed, then the halo exchange (``_HaloExchange``,
  an autograd Function whose backward sends each halo's cotangent back to
  the rank owning those rows, which adds it into its border; the edge
  zeros' cotangents are dropped), then the local plan, whose own autograd
  Function differentiates the block.  The superpack enters through
  ``_SumGrad``: its gradient is summed over every rank that holds a piece
  of the batch or of the plane.  Only halo rows move here, forward and
  backward; nothing is gathered.  The output stays split, as
  ``shard_map``'s ``out_specs`` leave it: a ``PlaneBlocks``.
- Between sites the plane stays split: a ``PlaneBlocks`` runs elementwise
  ops (bias, activations, a per-image embedding) and channel
  concatenations block by block, so each rank holds about
  ``1/(D_h·D_w)`` of every activation.  It is gathered
  (``gather_plane``) only where it must be whole: at a site with no
  verdict or a mesh of other extents, at any other op, and at the model's
  output.

Transport (``core.comm``): ``_send_recv`` posts a step's sends and
receives as one ``batch_isend_irecv``; ``_all_gather`` and ``_all_reduce``
are ``gather_plane``'s and the weight gradient's collectives.  On a gloo
group a CUDA tensor goes through pinned host buffers (``comm``'s
docstring).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import warnings

import torch
import torch.distributed as dist

from repro_torch.core import decompose as dec
from repro_torch.core.comm import _all_gather, _all_reduce, _send_recv
from repro_torch.core.plan import (ConvSpec, QuantizedSuperpack, Route,
                                   plan_conv)
from repro_torch.sharding import _ranks

Pair = tuple[int, int]

# the mesh axes a plane's rows / columns split over ('plane_h' / 'plane_w'
# of ``sharding.DEFAULT_RULES``), and the batch's
SPATIAL_AXES = ("sp_h", "sp_w")
DATA_AXIS = "data"


# ---------------------------------------------------------------------------
# geometry: the per-dim tiling record and its feasibility arithmetic
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DimTiling:
    """One spatial dim's device tiling, all plan-time constants."""

    dev: int        # devices along this dim (1 = unsplit)
    size: int       # parent input extent H
    pad_to: int     # padded input extent H' (zeros appended; H' >= H)
    block: int      # per-device input rows Hl = H'/dev
    out_pad: int    # padded output extent OH' (sliced back to OH after)
    tin: int        # halo'd slab extent each device assembles
    halo_lo: int    # rows received from the previous device
    halo_hi: int    # rows received from the next device
    lpad: Pair      # the local spec's padding along this dim


@dataclasses.dataclass(frozen=True)
class SpatialPlan:
    """Device-tiling geometry for one spec: per-dim records + the local
    (per-block) spec whose ``plan_conv`` runs on every rank."""

    spec: ConvSpec
    dims: tuple[DimTiling, DimTiling]
    local_spec: ConvSpec
    out_hw: Pair          # parent output extent (the slice target)

    @property
    def dev_tiles(self) -> Pair:
        return (self.dims[0].dev, self.dims[1].dev)


def _single_dim(d: int, h: int, r: int, s: int, dil: int, pad: Pair,
                oh: int) -> tuple[DimTiling | None, str | None]:
    """Tiling of one dim of a 'conv'/'dilated' site over ``d`` devices:
    ``(tiling, None)`` when feasible, ``(None, reason)`` when not."""
    pl, _ = pad
    if d == 1:
        return DimTiling(1, h, h, h, oh, h, 0, 0, pad), None
    if pl < 0:
        return None, f"crop-style padding (pad lo {pl} < 0)"
    # the output padded to a device multiple; the input to OH'·s, so that
    # T·s == Hl holds (and to at least H, so no real row is dropped)
    out_pad = d * max(-(-oh // d), -(-(-(-h // s)) // d))
    hp = out_pad * s
    if hp < h:
        return None, f"padded extent {hp} would drop input rows (H={h})"
    block, t = hp // d, out_pad // d
    tin = (t - 1) * s + (r - 1) * dil + 1
    halo_lo = pl
    halo_hi = max(0, tin - block - halo_lo)
    if halo_lo > block or halo_hi > block:
        return None, (f"halo ({halo_lo}, {halo_hi}) exceeds the {block}-row "
                      f"device block (needs multi-hop exchange)")
    return (DimTiling(d, h, hp, block, out_pad, tin, halo_lo, halo_hi,
                      (0, 0)), None)


def _transposed_dim(d: int, h: int, r: int, s: int, pad: Pair
                    ) -> tuple[DimTiling | None, str | None]:
    """Tiling of one dim of a transposed site over ``d`` devices: needs
    uniform phases with ``U == H`` (the 'SAME'-style padding); ``gl`` and
    ``xh_max`` do not depend on H, so the parent's phase algebra holds at
    the padded extent."""
    if d == 1:
        oh = dec.transposed_out_size(h, r, s, pad)
        return DimTiling(1, h, h, h, oh, h, 0, 0, pad), None
    plans = dec.plan_phases_1d(h, r, s, pad)
    if any(p.out_size != h for p in plans):
        sizes = sorted({p.out_size for p in plans})
        return None, (f"transposed phases are non-uniform or U != H "
                      f"(phase outputs {sizes}, H={h})")
    gl = max(0, max(p.pad[0] for p in plans))
    live = [p for p in plans if p.taps > 0]
    if not live:
        return None, "no live phases"
    xh_max = max(gl - p.pad[0] + p.taps - 1 for p in live)
    hp = d * (-(-h // d))
    block = hp // d                  # == T_u (phase-output rows per device)
    tin = xh_max + block
    halo_lo, halo_hi = gl, max(0, xh_max - gl)
    if halo_lo > block or halo_hi > block:
        return None, (f"halo ({halo_lo}, {halo_hi}) exceeds the {block}-row "
                      f"device block (needs multi-hop exchange)")
    pl, _ = pad
    lpad_lo = pl - gl * s
    lpad_hi = s * block + r - 2 - (tin - 1) * s - lpad_lo
    return (DimTiling(d, h, hp, block, s * hp, tin, halo_lo, halo_hi,
                      (lpad_lo, lpad_hi)), None)


# specs whose infeasible-tiling warning already fired: once per process,
# surviving ``reset()``, so plan-cache clears do not warn again
_INFEASIBLE_WARNED: set = set()


def _warn_infeasible(spec: ConvSpec, reason: str) -> None:
    """A spec that requests device tiling but cannot be tiled would plan
    single-device without a word: name the spec and the reason, once."""
    if spec in _INFEASIBLE_WARNED:
        return
    _INFEASIBLE_WARNED.add(spec)
    warnings.warn(
        f"spatial_plan: {spec.kind} site {spec.in_hw}x{spec.in_c}->"
        f"{spec.out_c} k={spec.kernel_hw} s={spec.strides} "
        f"p={spec.padding} requests device tiling spatial={spec.spatial} "
        f"but admits no one-hop halo exchange ({reason}) — planning "
        f"single-device", RuntimeWarning, stacklevel=3)


@functools.lru_cache(maxsize=4096)
def spatial_plan(spec: ConvSpec) -> SpatialPlan | None:
    """The device-tiling geometry for ``spec``, or None when it requests
    none (``spatial == (1, 1)``) or admits no one-hop halo exchange
    (warned once per spec).  Pure arithmetic on the spec, the same on
    every rank."""
    d_h, d_w = spec.spatial
    if (d_h, d_w) == (1, 1):
        return None
    (h, w), (r, s) = spec.in_hw, spec.kernel_hw
    (sh, sw) = spec.strides
    (ph, pw) = spec.padding
    if spec.kind == "transposed":
        th, why_h = _transposed_dim(d_h, h, r, sh, ph)
        tw, why_w = _transposed_dim(d_w, w, s, sw, pw)
    else:
        (dh, dw) = spec.dilation if spec.kind == "dilated" else (1, 1)
        oh = dec.single_out_size(h, r, sh, dh, ph)
        ow = dec.single_out_size(w, s, sw, dw, pw)
        th, why_h = _single_dim(d_h, h, r, sh, dh, ph, oh)
        tw, why_w = _single_dim(d_w, w, s, sw, dw, pw, ow)
    if th is None or tw is None:
        _warn_infeasible(spec, "; ".join(
            f"dim {nm}: {why}" for nm, why in (("H", why_h), ("W", why_w))
            if why))
        return None
    if spec.kind == "transposed":
        out_hw = (dec.transposed_out_size(h, r, sh, ph),
                  dec.transposed_out_size(w, s, sw, pw))
    else:
        out_hw = (oh, ow)
    local_spec = dataclasses.replace(
        spec, in_hw=(th.tin, tw.tin), padding=(th.lpad, tw.lpad),
        spatial=(1, 1))
    return SpatialPlan(spec=spec, dims=(th, tw), local_spec=local_spec,
                       out_hw=out_hw)


def plane_parallel_bytes(spec: ConvSpec, out_hw: Pair, batch: int,
                         itemsize: int) -> int:
    """The single-device working set the dev-tiling verdict is gated on:
    resident input plane + output plane at this batch bucket."""
    h, w = spec.in_hw
    oh, ow = out_hw
    return itemsize * batch * (h * w * spec.in_c + oh * ow * spec.out_c)


def halo_bytes(sp: SpatialPlan, batch: int, itemsize: int) -> int:
    """Bytes the ranks of one spatial grid send in one forward's exchange
    for a block batch of ``batch`` (the backward sends as many back): the
    row halos of every block, then the column halos of the row-extended
    slabs."""
    th, tw = sp.dims
    rows = tw.dev * (th.dev - 1) * (th.halo_lo + th.halo_hi) * tw.block
    cols = th.dev * (tw.dev - 1) * (tw.halo_lo + tw.halo_hi) * th.tin
    return itemsize * batch * sp.spec.in_c * (rows + cols)


# ---------------------------------------------------------------------------
# active spatial mesh: what ``ConvPlan.apply`` dispatches through
# ---------------------------------------------------------------------------

_ACTIVE: list = [None]      # (mesh, (axis_h, axis_w)) or None


def set_spatial_mesh(mesh, axes: Pair = SPATIAL_AXES):
    """Bind (or, with ``mesh=None``, clear) the process's active spatial
    mesh.  Serving binds it at ``degrade``; tests prefer the scoped
    ``use_spatial_mesh``."""
    _ACTIVE[0] = None if mesh is None else (mesh, tuple(axes))


def active_spatial_mesh():
    """The bound (mesh, axes) or None."""
    return _ACTIVE[0]


@contextlib.contextmanager
def use_spatial_mesh(mesh, axes: Pair = SPATIAL_AXES):
    prev = _ACTIVE[0]
    set_spatial_mesh(mesh, axes)
    try:
        yield
    finally:
        _ACTIVE[0] = prev


def _sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_matches(mesh, axes, dev_tiles: Pair) -> bool:
    """Does the bound mesh offer exactly ``dev_tiles`` ranks along the
    spatial axes?  (An axis may be absent when its tile extent is 1.)"""
    sizes = _sizes(mesh)
    return all(sizes.get(ax, 1) == want for ax, want in zip(axes, dev_tiles))


# ---------------------------------------------------------------------------
# transport
# ---------------------------------------------------------------------------

# ``_send_recv``, ``_all_gather`` and ``_all_reduce`` come from
# ``core.comm`` by name, so a patch of ``spatial._send_recv`` (the planted
# faults of the tests and the smoke) reaches this module's calls.


# ---------------------------------------------------------------------------
# a rank's place on the mesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Place:
    """This rank's coordinates on the mesh, its neighbours' global ranks
    along each spatial axis and the groups its blocks span."""

    index: dict                 # axis -> this rank's index along it
    nbrs: dict                  # axis -> (previous, next) global rank/None
    groups: dict                # axis -> process group
    data: int                   # extent of the 'data' axis
    batch_split: bool           # the batch divides over 'data'

    def span(self, axes) -> list:
        """(tensor dim, group) of every split dim among ``axes``, inner
        dims first: 'sp_w' (dim 2), 'sp_h' (dim 1), 'data' (dim 0)."""
        return [(dim, self.groups[ax]) for dim, ax in axes
                if ax in self.groups]


def _place(mesh, axes: Pair, batch: int) -> _Place:
    coord = mesh.get_coordinate()
    if coord is None:
        raise RuntimeError(f"rank {dist.get_rank()} is not on the bound "
                           f"spatial mesh {_sizes(mesh)}")
    names = list(mesh.mesh_dim_names)
    sizes = _sizes(mesh)
    index, nbrs, groups = {}, {}, {}
    data = sizes.get(DATA_AXIS, 1)
    batch_split = data > 1 and batch % data == 0
    for ax in (*axes, DATA_AXIS):
        if sizes.get(ax, 1) == 1:
            continue
        i = names.index(ax)
        index[ax] = coord[i]
        if ax == DATA_AXIS and not batch_split:
            continue

        def rank_at(j):
            c = list(coord)
            c[i] = j
            return int(_ranks(mesh)[tuple(c)])
        nbrs[ax] = (rank_at(coord[i] - 1) if coord[i] > 0 else None,
                    rank_at(coord[i] + 1) if coord[i] < sizes[ax] - 1
                    else None)
        groups[ax] = mesh.get_group(ax)
    return _Place(index, nbrs, groups, data, batch_split)


# ---------------------------------------------------------------------------
# the halo exchange and the superpack's gradient sum (autograd Functions)
# ---------------------------------------------------------------------------

def _exchange_fwd(xb, axis, dim: DimTiling, prev, nxt, group):
    lo, hi, blk = dim.halo_lo, dim.halo_hi, dim.block
    sends, recvs, parts = [], [], []

    def buf(rows):
        shape = list(xb.shape)
        shape[axis] = rows
        return xb.new_zeros(shape)
    if lo:
        recv_lo = buf(lo)
        if nxt is not None:
            sends.append((xb.narrow(axis, blk - lo, lo).contiguous(), nxt))
        if prev is not None:
            recvs.append((recv_lo, prev))
        parts.append(recv_lo)
    parts.append(xb)
    if hi:
        recv_hi = buf(hi)
        if prev is not None:
            sends.append((xb.narrow(axis, 0, hi).contiguous(), prev))
        if nxt is not None:
            recvs.append((recv_hi, nxt))
        parts.append(recv_hi)
    _send_recv(sends, recvs, group)
    out = torch.cat(parts, dim=axis) if len(parts) > 1 else xb
    return out.narrow(axis, 0, dim.tin) if out.shape[axis] != dim.tin \
        else out


def _exchange_bwd(g, axis, dim: DimTiling, prev, nxt, group):
    lo, hi, blk = dim.halo_lo, dim.halo_hi, dim.block
    full = lo + blk + hi
    if g.shape[axis] < full:          # rows past the slab had no cotangent
        grow = [0, 0] * (g.dim() - 1 - axis) + [0, full - g.shape[axis]]
        g = torch.nn.functional.pad(g, grow)
    dx = g.narrow(axis, lo, blk).clone()
    sends, recvs = [], []
    back_lo = back_hi = None
    if lo:
        if prev is not None:
            sends.append((g.narrow(axis, 0, lo).contiguous(), prev))
        if nxt is not None:
            shape = list(dx.shape)
            shape[axis] = lo
            back_lo = dx.new_empty(shape)
            recvs.append((back_lo, nxt))
    if hi:
        if nxt is not None:
            sends.append((g.narrow(axis, lo + blk, hi).contiguous(), nxt))
        if prev is not None:
            shape = list(dx.shape)
            shape[axis] = hi
            back_hi = dx.new_empty(shape)
            recvs.append((back_hi, prev))
    _send_recv(sends, recvs, group)
    if back_lo is not None:
        dx.narrow(axis, blk - lo, lo).add_(back_lo)
    if back_hi is not None:
        dx.narrow(axis, 0, hi).add_(back_hi)
    return dx


class _HaloExchange(torch.autograd.Function):
    """One dim's exchange: my bottom ``halo_lo`` rows to the next rank, my
    top ``halo_hi`` rows to the previous one, the received rows around my
    block, sliced to the slab.  The backward sends each halo's cotangent
    back to its owner, which adds it into its border rows."""

    @staticmethod
    def forward(ctx, xb, axis, dim, prev, nxt, group):
        ctx.meta = (axis, dim, prev, nxt, group)
        return _exchange_fwd(xb, axis, dim, prev, nxt, group)

    @staticmethod
    def backward(ctx, g):
        return (_exchange_bwd(g.contiguous(), *ctx.meta),
                None, None, None, None, None)


class _SumGrad(torch.autograd.Function):
    """Identity on the superpack whose backward sums its gradient over
    ``groups`` (the ranks holding distinct pieces of batch and plane)."""

    @staticmethod
    def forward(ctx, w, groups):
        ctx.groups = groups
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        for group in ctx.groups:
            g = _all_reduce(g, group)
        return g, None


def _sum_grad(packed, groups):
    if not groups:
        return packed
    if isinstance(packed, QuantizedSuperpack):
        return QuantizedSuperpack(packed.q, _SumGrad.apply(packed.scale,
                                                           groups))
    return _SumGrad.apply(packed, groups)


def _exchange(x, axis: int, dim: DimTiling, place: _Place, ax: str):
    if dim.dev == 1:
        return x
    prev, nxt = place.nbrs[ax]
    return _HaloExchange.apply(x, axis, dim, prev, nxt, place.groups[ax])


# ---------------------------------------------------------------------------
# a plane held as blocks
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class _Layout:
    """Where the blocks of one (B, H, W, C) plane lie: per spatial dim the
    ranks it splits over, its valid extent and the rows of one block (the
    plane padded to ``dev·block``, the padding rows held by the last
    ranks); the batch, split over 'data' where ``place.batch_split``."""

    mesh: object
    axes: Pair
    place: _Place
    batch: int
    hw: tuple            # ((dev, valid, block), (dev, valid, block))

    def same(self, other: "_Layout") -> bool:
        return (self.mesh is other.mesh and self.axes == other.axes
                and self.batch == other.batch and self.hw == other.hw)

    def groups(self, skip=()) -> list:
        """The groups of every split dim, inner dims first, but those of
        the mesh axes in ``skip``."""
        return [g for _, g in self.place.span(
            tuple((d, ax) for d, ax in ((2, self.axes[1]),
                                        (1, self.axes[0]), (0, DATA_AXIS))
                  if ax not in skip))]


def _layout(sp: SpatialPlan, mesh, axes: Pair, batch: int,
            out: bool) -> _Layout:
    """The layout of a site's input blocks, or of its output blocks."""
    if out:
        hw = tuple((d.dev, o, d.out_pad // d.dev)
                   for d, o in zip(sp.dims, sp.out_hw))
    else:
        hw = tuple((d.dev, d.size, d.block) for d in sp.dims)
    return _Layout(mesh, axes, _place(mesh, axes, batch), batch, hw)


def _block_of(t, lay: _Layout):
    """The rank's block of a plane padded to the layout's extents."""
    for dim, ax, (dev, _, blk) in zip((1, 2), lay.axes, lay.hw):
        if dev > 1:
            t = t.narrow(dim, lay.place.index[ax] * blk, blk)
    if lay.place.batch_split:
        n = t.shape[0] // lay.place.data
        t = t.narrow(0, lay.place.index[DATA_AXIS] * n, n)
    return t.contiguous()


def _gather_blocks(t, lay: _Layout):
    """All blocks of ``t`` joined: columns over 'sp_w', rows over 'sp_h',
    the batch over 'data' (where it is split)."""
    for dim, group in lay.place.span(((2, lay.axes[1]), (1, lay.axes[0]),
                                      (0, DATA_AXIS))):
        t = torch.cat(_all_gather(t, group), dim=dim)
    return t


class _Scatter(torch.autograd.Function):
    """Global (replicated) plane -> the rank's block of the padded plane;
    nothing moves.  The backward gathers every block's cotangent into the
    (replicated) plane's."""

    @staticmethod
    def forward(ctx, x4, lay):
        ctx.lay = lay
        (dh, vh, bh), (dw, vw, bw) = lay.hw
        zh, zw = dh * bh - vh, dw * bw - vw
        if zh or zw:
            x4 = torch.nn.functional.pad(x4, (0, 0, 0, zw, 0, zh))
        return _block_of(x4, lay)

    @staticmethod
    def backward(ctx, g):
        lay = ctx.lay
        g = _gather_blocks(g.contiguous(), lay)
        return (g[:, :lay.hw[0][1], :lay.hw[1][1]].contiguous(), None)


class _Gather(torch.autograd.Function):
    """The ranks' blocks -> the global plane, sliced to the valid extents.
    The backward keeps the rank's block of the cotangent."""

    @staticmethod
    def forward(ctx, block, lay):
        ctx.lay = lay
        y = _gather_blocks(block.contiguous(), lay)
        return y[:, :lay.hw[0][1], :lay.hw[1][1]].contiguous()

    @staticmethod
    def backward(ctx, g):
        lay = ctx.lay
        (dh, _, bh), (dw, _, bw) = lay.hw
        g = torch.nn.functional.pad(g, (0, 0, 0, dw * bw - g.shape[2],
                                        0, dh * bh - g.shape[1]))
        return _block_of(g, lay), None


class PlaneBlocks:
    """A (B, H, W, C) plane held as this rank's block: what a split site
    returns, as JAX's ``shard_map`` returns a plane sharded over
    ``out_specs``, so the plane stays split from one site to the next.

    ``shape`` is the global plane's.  Elementwise functions and operators
    (``_POINTWISE``) run on the block: the other operand is another plane
    of the same layout or a tensor that broadcasts over the rows and
    columns (a bias, a per-image vector: its rows over a split batch kept,
    its gradient summed over the ranks, as the superpack's).
    ``torch.cat`` over channels joins blocks of one layout.  Anything else
    (a reshape, a reduction, a tensor method) gathers the plane first
    (``full``), which is also what a site whose route carries no verdict,
    or a mesh of other extents, takes.  The
    padding rows past the valid extent hold whatever the elementwise ops
    made of zeros; the next site zeroes them and ``full`` drops them.
    In-place tensor methods are refused: they would write to a gathered
    copy."""

    def __init__(self, block: torch.Tensor, layout: _Layout):
        self.block = block
        self.layout = layout

    @property
    def shape(self) -> torch.Size:
        (_, vh, _), (_, vw, _) = self.layout.hw
        return torch.Size((self.layout.batch, vh, vw, self.block.shape[-1]))

    @property
    def dtype(self):
        return self.block.dtype

    @property
    def device(self):
        return self.block.device

    def full(self) -> torch.Tensor:
        """The global plane, gathered from every rank's block."""
        return _Gather.apply(self.block, self.layout)

    def __getattr__(self, name):
        if name.startswith("__") or name in ("block", "layout"):
            raise AttributeError(name)
        if name.endswith("_") and not name.endswith("__"):
            raise TypeError(f"PlaneBlocks.{name}: an in-place op on a "
                            f"plane held as blocks would write to a "
                            f"gathered copy")
        return getattr(self.full(), name)

    def __getitem__(self, idx):
        return self.full()[idx]

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = None
        if func in _POINTWISE:
            out = _pointwise(func, args, kwargs)
        elif func in (torch.cat, torch.concat):
            out = _cat(*args, **kwargs)
        if out is not None:
            return out
        return func(*_gathered(args), **_gathered(kwargs))


def _dunder(func):
    def op(self, other):
        out = _pointwise(func, (self, other), {})
        return out if out is not None else func(*_gathered((self, other)))
    return op


for _name, _func in (("add", torch.Tensor.add),
                     ("radd", torch.Tensor.__radd__),
                     ("sub", torch.Tensor.sub),
                     ("rsub", torch.Tensor.__rsub__),
                     ("mul", torch.Tensor.mul),
                     ("rmul", torch.Tensor.__rmul__),
                     ("truediv", torch.Tensor.div),
                     ("rtruediv", torch.Tensor.__rtruediv__),
                     ("pow", torch.Tensor.pow),
                     ("rpow", torch.Tensor.__rpow__)):
    setattr(PlaneBlocks, f"__{_name}__", _dunder(_func))
PlaneBlocks.__neg__ = lambda self: _pointwise(torch.Tensor.neg, (self,), {})

_F = torch.nn.functional
# functions applied block by block: elementwise in every operand
_POINTWISE = frozenset((
    torch.Tensor.add, torch.Tensor.sub, torch.Tensor.mul, torch.Tensor.div,
    torch.Tensor.pow, torch.square, torch.abs, torch.relu, torch.tanh,
    torch.sigmoid, _F.relu, _F.silu, _F.leaky_relu))


def _gathered(obj):
    """``obj`` with every ``PlaneBlocks`` in it gathered."""
    if isinstance(obj, PlaneBlocks):
        return obj.full()
    if isinstance(obj, (list, tuple)):
        return type(obj)(_gathered(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _gathered(v) for k, v in obj.items()}
    return obj


def _operand(t: torch.Tensor, lay: _Layout):
    """``t``'s part in an elementwise op with a plane of layout ``lay``,
    or None when it has none short of the gathered plane: a tensor that
    broadcasts over rows and columns is used as is (its rows of a split
    batch kept), its gradient summed over the ranks, which each add a
    block's part."""
    nd = t.dim()
    if nd > 4:
        return None
    b, h, w = ((1,) * (4 - nd) + tuple(t.shape))[:3]
    if b not in (1, lay.batch) or (h, w) != (1, 1):
        return None
    # summed whole: each rank's gradient has only its batch rows
    t = _sum_grad(t, lay.groups())
    if nd == 4 and b == lay.batch > 1 and lay.place.batch_split:
        n = b // lay.place.data
        t = t.narrow(0, lay.place.index[DATA_AXIS] * n, n)
    return t


def _pointwise(func, args, kwargs):
    lay = next(a.layout for a in (*args, *kwargs.values())
               if isinstance(a, PlaneBlocks))

    def part(a):
        if isinstance(a, PlaneBlocks):
            return a.block if a.layout.same(lay) else None
        if isinstance(a, torch.Tensor):
            return _operand(a, lay)
        return a
    margs = [part(a) for a in args]
    mkw = {k: part(v) for k, v in kwargs.items()}
    if any(m is None and a is not None for m, a in
           zip((*margs, *mkw.values()), (*args, *kwargs.values()))):
        return None
    return PlaneBlocks(func(*margs, **mkw), lay)


def _cat(tensors, dim=0, **kwargs):
    """Planes of one layout joined over channels, block by block."""
    lay = tensors[0].layout if isinstance(tensors[0], PlaneBlocks) else None
    if dim not in (3, -1) or kwargs or lay is None or not all(
            isinstance(t, PlaneBlocks) and t.layout.same(lay)
            for t in tensors):
        return None
    return PlaneBlocks(torch.cat([t.block for t in tensors], dim=-1), lay)


def gather_plane(y):
    """The global plane of ``y``: a ``PlaneBlocks`` gathered from every
    rank, a tensor as it is (what a model returns at its output)."""
    return y.full() if isinstance(y, PlaneBlocks) else y


# ---------------------------------------------------------------------------
# executor
# ---------------------------------------------------------------------------

def _zero_padding(block, lay: _Layout):
    """The block with the rows and columns past the valid extent zeroed:
    the conv's own zero padding, whatever elementwise ops made of it."""
    for dim, ax, (dev, valid, blk) in zip((1, 2), lay.axes, lay.hw):
        start = lay.place.index.get(ax, 0) * blk if dev > 1 else 0
        keep = min(max(valid - start, 0), blk)
        if keep < blk:
            grow = [0, 0] * (3 - dim) + [0, blk - keep]
            block = torch.nn.functional.pad(block.narrow(dim, 0, keep), grow)
    return block


def scatter_plane(sp: SpatialPlan, x4, mesh,
                  axes: Pair = SPATIAL_AXES) -> PlaneBlocks:
    """The rank's block of the site's input: ``x4`` itself when it is a
    ``PlaneBlocks`` laid out as the site's input (the previous split
    site's output), else the block of the global plane (a plain tensor
    counts as replicated; a ``PlaneBlocks`` of another layout is gathered
    first)."""
    lay = _layout(sp, mesh, axes, x4.shape[0], out=False)
    if isinstance(x4, PlaneBlocks):
        if x4.layout.same(lay):
            return x4
        x4 = x4.full()
    return PlaneBlocks(_Scatter.apply(x4, lay), lay)


def spatial_apply(sp: SpatialPlan, xb: PlaneBlocks, packed, mesh,
                  axes: Pair = SPATIAL_AXES, summed=()) -> PlaneBlocks:
    """The shard_map body on the rank's block ``xb`` (``scatter_plane``):
    zero the padding rows, exchange the halos (rows, then the columns of
    the row-extended slab), run the local plan, and return the output
    block.  Only halo rows move, forward and backward; the superpack's
    gradient is summed over the ranks that hold pieces (the batch's too
    where it is split over 'data'), but over the mesh axes ``summed``,
    where the caller's gather of a split superpack sums it."""
    lay = xb.layout
    place = lay.place
    th, tw = sp.dims
    xl = _zero_padding(xb.block, lay)
    xl = _exchange(xl, 1, th, place, axes[0])
    xl = _exchange(xl, 2, tw, place, axes[1])
    yb = plan_conv(sp.local_spec).apply(xl, _sum_grad(packed,
                                                      lay.groups(summed)))
    SPLIT_SITES[0] += 1
    return PlaneBlocks(yb, _layout(sp, mesh, axes, lay.batch, out=True))


# split site runs in this process (``spatial_apply`` calls): what shows
# that a run under a mesh really split its planes
SPLIT_SITES = [0]


def _site(plan, x):
    """(spatial plan, mesh, axes, batch) where the plane-parallel executor
    takes the site: a spatial mesh is bound and its extents match the
    route's ``dev_tiles`` verdict; None otherwise."""
    active = active_spatial_mesh()
    if active is None:
        return None
    lead = tuple(x.shape[:-3])
    batch = int(math.prod(lead)) if lead else 1
    route: Route = plan.route_for_batch(batch)
    if route.dev_tiles is None:
        return None
    mesh, axes = active
    if not mesh_matches(mesh, axes, route.dev_tiles):
        return None
    sp = spatial_plan(plan.spec)
    if sp is None:
        return None
    return sp, mesh, axes, batch


def split_axes(plan, x):
    """The mesh axes whose ranks hold other pieces of the site's input
    (the plane's split axes, 'data' where the batch splits) where the
    plane-parallel executor takes the site; None where it declines it."""
    site = _site(plan, x)
    if site is None:
        return None
    _, mesh, axes, batch = site
    return frozenset(_place(mesh, axes, batch).groups)


def try_spatial(plan, x, packed, summed=()):
    """``ConvPlan.apply``'s dispatch hook: run plane-parallel when a
    spatial mesh is bound and its extents match the route's ``dev_tiles``
    verdict, and return the output as blocks (``PlaneBlocks``); None
    otherwise (the route's path and tiles are the single-device verdict,
    so the plan's own route then runs on the gathered plane).  ``summed``:
    the mesh axes over which the superpack's gradient is summed already
    (``spatial_apply``)."""
    site = _site(plan, x)
    if site is None:
        return None
    sp, mesh, axes, _ = site
    lead = tuple(x.shape[:-3])
    x4 = x if len(lead) == 1 else \
        gather_plane(x).reshape((-1,) + tuple(x.shape[-3:]))
    y = spatial_apply(sp, scatter_plane(sp, x4, mesh, axes),
                      plan.as_superpack(packed), mesh, axes, summed)
    if len(lead) == 1:
        return y
    y = y.full()
    return y.reshape(lead + tuple(y.shape[1:]))


def reset():
    """Drop the memoised geometry (tests patch plan-route constants and
    clear every plan-derived cache together)."""
    spatial_plan.cache_clear()
