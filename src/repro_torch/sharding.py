"""Sharding rules: logical axes -> mesh axes, on ``torch.distributed``.

Counterpart of ``repro.sharding``.  The model code names the *logical*
axes of its parameters ("heads", "ffn", "vocab", "expert", "conv_out",
...) in spec trees beside the params; ``DistContext`` maps them onto the
axes of a ``DeviceMesh`` (``launch.mesh``), so a parallelism strategy is
an edit of ``rules``.  ``Spec`` is the port's logical-spec type, JAX's
``PartitionSpec``: a tuple of axis names (or tuples of them, or None) per
tensor dim.

JAX places whole arrays with ``NamedSharding`` and lets XLA's SPMD
partitioner insert the collectives.  The port has no partitioner: its mesh
code is explicit SPMD.  ``shard_params`` gives every rank its own block of
each sharded leaf, the block its mesh coordinate selects, as
``NamedSharding`` lays it out (several mesh axes on one dim split it major
to minor in the order listed); every rank runs the same code, and the
layers call the collectives of ``core.comm`` on the groups of the mesh
axes (``DistContext.group``).  A superpack whose out-channels are split
comes back as a ``core.plan.TPSuperpack``, one whose rows are split as a
``core.plan.RowSuperpack`` (both: the first holding the second), which
``ConvPlan.apply`` runs as a tensor- or row-parallel site.

Placement of activations: a batch over the batch axes is split by
``split_batch`` (each rank runs its rows; several axes split it major to
minor, in mesh order) and joined by ``join_batch``; a plane over
'sp_h'/'sp_w' is split by the plane-parallel executor (``core.spatial``).
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any, Optional

# default logical -> mesh translation (megatron TP on 'model', experts EP'd)
DEFAULT_RULES: dict[str, Any] = {
    "heads": "model",
    "kv_heads": "model",
    "ffn": "model",
    "vocab": "model",
    "expert": "model",
    "expert_ffn": None,
    "batch": ("data",),
    "seq": None,
    "kv_seq": None,
    # superpacked conv weights: one tap-major (ΣT·C, N) buffer per site;
    # the default shards only the out-channel dim
    "conv_taps": None,
    "conv_out": "model",
    # plane-parallel execution (core.spatial): one plane's rows / cols
    # over the 'sp_h' / 'sp_w' axes of ``make_spatial_mesh``
    "plane_h": "sp_h",
    "plane_w": "sp_w",
}


class Spec(tuple):
    """A logical (or resolved) spec: one entry per tensor dim, each an
    axis name, a tuple of names, or None; trailing dims are implicit.  A
    one-name tuple is that name, as in JAX's ``PartitionSpec``."""

    def __new__(cls, *axes):
        return super().__new__(cls, (
            a[0] if isinstance(a, tuple) and len(a) == 1 else a
            for a in axes))

    def __repr__(self):
        return f"Spec{tuple.__repr__(self)}"


# logical spec of every superpacked conv weight buffer
SUPERPACK_SPEC = Spec("conv_taps", "conv_out")

# logical spec of a plane-parallel (B, H, W, C) activation
PLANE_SPEC = Spec("batch", "plane_h", "plane_w")

# (param path, dim, axis) triples ``shard_params`` has warned about: the
# replication fallback is silent by design at each call site, but the
# first hit for a given param deserves a visible trace
_REPLICATION_WARNED: set = set()

# process groups over several mesh axes, per (mesh ranks, axis names,
# axes): a content key, so every rank finds the same groups built
_GROUPS: dict = {}


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _is_spec(x) -> bool:
    return isinstance(x, Spec)


def keystr(path) -> str:
    """``jax.tree_util.keystr`` of a path of dict keys and list indices."""
    return "".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]"
                   for k in path)


def _tree_map_with_path(fn, tree, specs, path=(), leaf=None):
    """``fn(path, leaf, spec)`` over a params tree of dicts, lists and
    tuples and its spec tree of the same structure."""
    if leaf is not None and leaf(tree):
        return fn(path, tree, specs)
    if isinstance(tree, dict):
        return {k: _tree_map_with_path(fn, tree[k], specs[k], path + (k,),
                                       leaf) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map_with_path(fn, t, s, path + (i,), leaf)
                          for i, (t, s) in enumerate(zip(tree, specs)))
    return fn(path, tree, specs)


def _spec_map(fn, specs):
    if _is_spec(specs):
        return fn(specs)
    if isinstance(specs, dict):
        return {k: _spec_map(fn, v) for k, v in specs.items()}
    if isinstance(specs, (list, tuple)):
        return type(specs)(_spec_map(fn, v) for v in specs)
    return specs


@dataclasses.dataclass(frozen=True)
class Placement:
    """A resolved spec on a mesh (JAX's ``NamedSharding``): ``block``
    cuts this rank's block from a whole tensor, a dim its mesh axes do not
    divide staying whole (``shard_params``' rule); ``gather`` makes a
    rank's block whole again (a collective: every rank of the mesh calls
    it).

    A leaf of a stack JAX keeps as one stacked leaf (``index``: its place
    in the stack) carries the stacked ``spec`` and whole ``shape``, the
    stack dim first.  Where that dim is split (ZeRO-1 of a stack of
    layers over 'data'), a rank holds the leaf whole if its part of the
    stack has layer ``index`` and an empty tensor otherwise."""

    dist: "DistContext"
    spec: Spec
    shape: Optional[tuple] = None
    index: Optional[int] = None

    def _leaf(self):
        if self.index is None:
            return self.spec, self.shape
        return Spec(*self.spec[1:]), (None if self.shape is None
                                      else tuple(self.shape[1:]))

    def _owner(self):
        """(this rank owns the leaf, the owner's rank in the stack dim's
        group, that group) of a leaf whose stack dim is split; None
        otherwise."""
        if self.index is None or not self.spec or self.spec[0] is None:
            return None
        lead = self.spec[0]
        j, n = self.dist.shard_of(lead, self.shape[0])
        if n == 1:
            return None
        size = self.shape[0] // n
        return (j == self.index // size, self.index // size,
                self.dist.group(lead))

    def block(self, t):
        own = self._owner()
        if own is not None and not own[0]:
            return t.new_empty((0,))
        return self.dist._block(t, self._leaf()[0])

    def gather(self, t, root=False):
        """The whole leaf from this rank's block ``t`` (an empty tensor
        where the stack's owner holds it).  ``root``: only on the mesh's
        first rank (None on the others), each dim gathered to its group's
        first rank, which moves each block once."""
        import torch
        from repro_torch.core import comm
        spec, shape = self._leaf()
        if shape is None:
            raise ValueError("Placement.gather needs the whole shape "
                             "(DistContext.placement)")
        own = self._owner()
        if own is not None:
            if not own[0]:
                blk = [b - a for a, b in self.dist._dims(shape, spec)]
                t = torch.empty(blk, dtype=t.dtype, device=t.device)
            t = comm.broadcast(t, own[1], own[2], kind="ckpt_broadcast")
        spec = tuple(spec) + (None,) * (t.dim() - len(spec))
        for d, entry in enumerate(spec):
            j, n = self.dist.shard_of(entry, shape[d])
            if n == 1:
                continue
            if not root:
                t = comm.all_gather(t, self.dist.group(entry), d,
                                    kind="ckpt_gather")
                continue
            # the group's members share every other coordinate, so they
            # all still hold data here, or none do
            t = comm.gather_to(t, self.dist.group(entry), d,
                               kind="ckpt_gather")
            if t is None:
                return None
        if root and not self.dist.is_first():
            return None
        return t


def _ranks(mesh):
    """The mesh's ranks as a numpy array, read with no dispatch mode on (a
    fake tensor mode would read the mesh's tensor as a fake one)."""
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():
        return mesh.mesh.cpu().numpy()


@dataclasses.dataclass(frozen=True)
class DistContext:
    mesh: Any                       # a DeviceMesh, or None
    rules: dict = dataclasses.field(default_factory=lambda: dict(DEFAULT_RULES))

    # ---- the mesh ----------------------------------------------------------
    def _sizes(self) -> dict[str, int]:
        return dict(zip(self.mesh.mesh_dim_names, self.mesh.shape))

    def _coord(self) -> dict[str, int]:
        return dict(zip(self.mesh.mesh_dim_names,
                        self.mesh.get_coordinate()))

    @property
    def batch_axes(self):
        return self.rules["batch"]

    @property
    def model_axis(self):
        return "model"

    def extent(self, entry) -> int:
        """Ranks along a resolved spec entry (1 off the mesh)."""
        if self.mesh is None:
            return 1
        sizes = self._sizes()
        return math.prod(sizes.get(a, 1) for a in _axes(entry))

    def shard_of(self, entry, size: int) -> tuple[int, int]:
        """(this rank's block index, block count) of a dim of ``size``
        over the resolved entry: the axes' coordinates major to minor in
        the order listed; (0, 1) where the extent does not divide
        ``size`` (the dim stays whole)."""
        n = self.extent(entry)
        if n == 1 or size % n:
            return 0, 1
        sizes, coord = self._sizes(), self._coord()
        i = 0
        for a in _axes(entry):
            i = i * sizes.get(a, 1) + coord.get(a, 0)
        return i, n

    def span(self, entry, size: int) -> tuple[int, int]:
        """[start, stop) of this rank's block of a dim of ``size`` over
        the resolved ``entry`` (``shard_of``'s block; the whole dim off
        the mesh or where the extent does not divide ``size``)."""
        if self.mesh is None:
            return 0, size
        j, n = self.shard_of(entry, size)
        return j * (size // n), (j + 1) * (size // n)

    def block_shape(self, shape, spec) -> tuple:
        """This rank's block shape of a whole ``shape`` under the logical
        ``spec`` (``shard_params``' layout; ``shape`` off the mesh)."""
        if self.mesh is None:
            return tuple(shape)
        return tuple(b - a for a, b in self._dims(shape, self.resolve(spec)))

    def axes_of(self, entry) -> tuple:
        """(((mesh axis, its process group), ...), batch): each axis of the
        resolved ``entry`` with more than one rank, in the order listed
        (major to minor, as ``shard_of`` counts blocks), and the names of
        those of them that the image batch splits over (``batch_ranks``):
        a weight split over one of these is gathered whole before use."""
        axes = tuple((a, self.mesh.get_group(a)) for a in _axes(entry)
                     if self.extent(a) > 1)
        batch, _ = self.batch_ranks()
        return axes, frozenset(_axes(batch)) & {a for a, _ in axes}

    def group(self, entry):
        """The process group of the ranks that share this rank's
        coordinates off ``entry``'s axes (a resolved entry: one mesh axis
        or several), in the order its block index counts them; None for
        a one-rank group.  Several axes make a group of their own (every
        rank builds each such group once, in the same order)."""
        axes = tuple(a for a in _axes(entry) if self.extent(a) > 1)
        if not axes:
            return None
        if len(axes) == 1:
            return self.mesh.get_group(axes[0])
        key = (tuple(_ranks(self.mesh).ravel().tolist()),
               tuple(self.mesh.mesh_dim_names), axes)
        if key not in _GROUPS:
            _GROUPS[key] = self._new_group(axes)
        return _GROUPS[key]

    def _new_group(self, axes):
        import itertools

        import numpy as np
        import torch.distributed as dist
        names = list(self.mesh.mesh_dim_names)
        ranks = _ranks(self.mesh)
        # the group's axes last, in the listed order; the rest index groups
        others = [i for i, a in enumerate(names) if a not in axes]
        order = others + [names.index(a) for a in axes]
        ranks = ranks.transpose(order)
        ranks = ranks.reshape(ranks.shape[:len(others)] + (-1,))
        mine = None
        me = dist.get_rank()
        for idx in itertools.product(*(range(s) for s in
                                       ranks.shape[:-1])):
            members = [int(r) for r in ranks[idx]]
            if members != sorted(members):
                raise NotImplementedError(
                    f"a group over axes {axes} whose ranks are not in "
                    f"mesh order: {members}")
            g = dist.new_group(members)
            if me in members:
                mine = g
        return mine

    # ---- specs -------------------------------------------------------------
    def resolve(self, spec) -> Spec:
        """Translate a logical spec into a mesh spec."""
        out = []
        for ax in spec:
            if ax is None:
                out.append(None)
            elif isinstance(ax, str) and ax in self.rules:
                out.append(self.rules[ax])
            else:
                out.append(ax)
        return Spec(*out)

    def sharding(self, spec) -> Placement:
        return Placement(self, self.resolve(spec))

    def placement(self, resolved, shape, index=None) -> Placement:
        """A ``Placement`` of a resolved spec over a whole ``shape`` (a
        stacked one, the stack dim first, with ``index`` the leaf's place
        in the stack)."""
        return Placement(self, Spec(*resolved), tuple(shape), index)

    def mesh_group(self):
        """The group of every rank of the mesh (None for one rank)."""
        return self.group(tuple(a for a in self.mesh.mesh_dim_names))

    def is_first(self) -> bool:
        """This rank is the mesh's first (every coordinate 0)."""
        coord = self.mesh.get_coordinate()
        return coord is not None and not any(coord)

    def param_shardings(self, specs_tree):
        return _spec_map(self.sharding, specs_tree)

    def act_spec(self, *, seq_dim: bool = True) -> Spec:
        """(B, S, D) residual-stream spec: batch over DP axes, optional SP."""
        if seq_dim:
            return Spec(self.rules["batch"], self.rules["seq"], None)
        return Spec(self.rules["batch"], None)

    def image_spec(self) -> Spec:
        """(B, H, W, C) image batch spec: batch over the DP axes."""
        return Spec(self.rules["batch"])

    def plane_spec(self) -> Spec:
        """(B, H, W, C) plane-parallel spec: batch over the DP axes, the
        plane's rows/cols over the spatial axes."""
        return self.resolve(PLANE_SPEC)

    def spatial_tiles(self) -> tuple[int, int]:
        """(D_h, D_w): the extents of the mesh axes 'plane_h' / 'plane_w'
        resolve to (1 where unmapped or absent), what model configs feed
        into ``ConvSpec.spatial``."""
        return tuple(self.extent(self.rules.get(logical))
                     for logical in ("plane_h", "plane_w"))

    # ---- parameters --------------------------------------------------------
    def _dims(self, shape, resolved, name=None):
        """(start, stop) of this rank's block along every dim of
        ``shape`` under the resolved spec; a dim its axes do not divide
        stays whole (warned once per (param, dim, axis) when ``name``)."""
        resolved = tuple(resolved) + (None,) * (len(shape) - len(resolved))
        out = []
        for i, (dim, ax) in enumerate(zip(shape, resolved)):
            n = self.extent(ax)
            if ax is not None and n > 1 and dim % n:
                if name is not None and (name, i, ax) not in \
                        _REPLICATION_WARNED:
                    _REPLICATION_WARNED.add((name, i, ax))
                    warnings.warn(
                        f"shard_params: param {name} dim {i} (size {dim}) "
                        f"does not divide mesh axis {ax!r} (extent {n}) — "
                        f"replicating that dim instead", RuntimeWarning,
                        stacklevel=3)
            j, m = self.shard_of(ax, dim)
            out.append((j * (dim // m), (j + 1) * (dim // m)))
        return out

    def _block(self, t, resolved, name=None):
        for d, (a, b) in enumerate(self._dims(t.shape, resolved, name)):
            if b - a != t.shape[d]:
                t = t.narrow(d, a, b - a)
        return t.contiguous()

    def shard_params(self, params, specs):
        """Each rank's blocks of a tree of whole tensors, per its logical
        spec tree (a mesh-less context returns ``params``).  A dim whose
        size its mesh axes do not divide stays whole on every rank, with
        one ``RuntimeWarning`` per (param, dim, axis), as JAX's.  A
        ``QuantizedSuperpack`` shards its int8 codes like the dense buffer
        and its (rows, 1) scales along the row axis only.  A superpack
        (spec ``SUPERPACK_SPEC``) whose out-channels split comes back as a
        ``TPSuperpack`` (``ConvPlan.apply``'s tensor-parallel site), one
        whose rows split ('conv_taps') as a ``RowSuperpack`` (its
        row-parallel site), one split on both as a ``TPSuperpack`` of a
        ``RowSuperpack`` (the rank's row block of its column block); each
        names its split's mesh axes and those of them that carry the image
        batch."""
        if self.mesh is None:
            return params
        from repro_torch.core.plan import (QuantizedSuperpack, RowSuperpack,
                                           TPSuperpack)

        def put(path, p, sp):
            name = keystr(path)
            resolved = self.resolve(sp)
            if isinstance(p, QuantizedSuperpack):
                blk = QuantizedSuperpack(
                    self._block(p.q, resolved, name),
                    self._block(p.scale, resolved[:1], name))
                shape = p.q.shape
            else:
                blk = self._block(p, resolved, name)
                shape = p.shape
            if tuple(sp) != tuple(SUPERPACK_SPEC):
                return blk
            (rows, n) = shape
            if blk.shape[0] != rows:
                j, m = self.shard_of(resolved[0], rows)
                blk = RowSuperpack(blk, self.group(resolved[0]), j, m,
                                   (j * rows // m, (j + 1) * rows // m),
                                   rows, *self.axes_of(resolved[0]))
            if blk.shape[1] == n:
                return blk              # rows split, or replicated: whole
            j, m = self.shard_of(resolved[1], n)
            return TPSuperpack(blk, self.group(resolved[1]), j, m,
                               *self.axes_of(resolved[1]))

        return _tree_map_with_path(
            put, params, specs,
            leaf=lambda x: isinstance(x, QuantizedSuperpack))

    def constrain(self, x, spec=None, shape=None):
        """JAX's sharding constraint: the identity.  On a mesh, with the
        whole ``shape`` given, it checks that ``x`` is this rank's block
        under ``spec`` (``act_spec()`` by default); nothing moves."""
        if self.mesh is None or shape is None:
            return x
        spec = spec if spec is not None else self.act_spec()
        want = tuple(b - a for a, b in self._dims(shape, self.resolve(spec)))
        if tuple(x.shape) != want:
            raise ValueError(f"constrain: local shape {tuple(x.shape)} is "
                             f"not the block {want} of {tuple(shape)} under "
                             f"{spec}")
        return x

    # ---- the batch ---------------------------------------------------------
    def batch_ranks(self) -> tuple[Any, int]:
        """(mesh axis, extent) the image batch splits over: one axis name,
        a tuple of names where several axes of the batch spec have more
        than one rank (split major to minor in the order listed); (None,
        1) when none has."""
        if self.mesh is None:
            return None, 1
        axes = tuple(a for a in _axes(self.image_spec()[0])
                     if self.extent(a) > 1)
        if not axes:
            return None, 1
        return (axes[0] if len(axes) == 1 else axes), self.extent(axes)

    def split_batch(self, x):
        """(this rank's rows of ``x``, the group to join them over), as
        JAX's constraint to ``image_spec()`` splits the batch; ``(x,
        None)`` when the batch is whole on every rank (no batch axis, or a
        batch its extent does not divide: every rank runs all rows)."""
        axes, n = self.batch_ranks()
        if n == 1 or x.shape[0] % n:
            return x, None
        i, _ = self.shard_of(axes, x.shape[0])
        rows = x.shape[0] // n
        return x.narrow(0, i * rows, rows), self.group(axes)

    def join_batch(self, y, group):
        """Every rank's rows of ``y`` (``split_batch``'s group), in rank
        order; ``y`` itself for ``group=None``."""
        if group is None:
            return y
        import torch
        from repro_torch.core.comm import _all_gather
        return torch.cat(_all_gather(y.contiguous(), group))


def single_device_dist() -> Optional[DistContext]:
    """None-context for smoke tests (no mesh, constraints are no-ops)."""
    return None


def stack_specs(specs_tree, n_lead: int = 1):
    """Prepend ``n_lead`` None axes to every spec (JAX's stacked stages)."""
    return _spec_map(lambda sp: Spec(*((None,) * n_lead + tuple(sp))),
                     specs_tree)
