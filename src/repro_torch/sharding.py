"""Sharding rules: logical axes -> mesh axes, on ``torch.distributed``.

Counterpart of ``repro.sharding``, as far as serving images over a mesh
needs it.  ``DistContext`` maps the logical axes the serving path names
("batch", "plane_h", "plane_w") onto the axes of a ``DeviceMesh``
(``launch.mesh``), so a parallelism strategy is an edit of ``rules``.
``Spec`` is the port's logical-spec type, JAX's ``PartitionSpec``: a tuple
of axis names (or tuples of them, or None) per tensor dim.

Placement: a batch over 'data' is split by ``split_batch`` (each rank runs
its rows) and joined by ``join_batch``; a plane over 'sp_h'/'sp_w' is
split by the plane-parallel executor (``core.spatial``), which holds it as
blocks between conv sites.  Tensor-parallel superpacks and the models'
parameter specs are ROADMAP Queue 1 item 13b.
"""
from __future__ import annotations

import dataclasses
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


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True)
class DistContext:
    mesh: Any                       # a DeviceMesh, or None
    rules: dict = dataclasses.field(default_factory=lambda: dict(DEFAULT_RULES))

    def _sizes(self) -> dict[str, int]:
        return dict(zip(self.mesh.mesh_dim_names, self.mesh.shape))

    def image_spec(self) -> Spec:
        """(B, H, W, C) image batch spec: batch over the DP axes."""
        return Spec(self.rules["batch"])

    def spatial_tiles(self) -> tuple[int, int]:
        """(D_h, D_w): the extents of the mesh axes 'plane_h' / 'plane_w'
        resolve to (1 where unmapped or absent), what model configs feed
        into ``ConvSpec.spatial``."""
        if self.mesh is None:
            return (1, 1)
        sizes = self._sizes()
        out = []
        for logical in ("plane_h", "plane_w"):
            n = 1
            for a in _axes(self.rules.get(logical)):
                n *= sizes.get(a, 1)
            out.append(n)
        return tuple(out)

    def batch_ranks(self) -> tuple[Optional[str], int]:
        """(mesh axis, extent) the image batch splits over; (None, 1)
        when no axis of the image spec has more than one rank."""
        if self.mesh is None:
            return None, 1
        sizes = self._sizes()
        axes = [a for a in _axes(self.image_spec()[0]) if sizes.get(a, 1) > 1]
        if len(axes) > 1:
            raise NotImplementedError(
                f"a batch over several mesh axes {axes}: ROADMAP Queue 1 "
                f"item 13b")
        return (axes[0], sizes[axes[0]]) if axes else (None, 1)

    def split_batch(self, x):
        """(this rank's rows of ``x``, the group to join them over), as
        JAX's constraint to ``image_spec()`` splits the batch; ``(x,
        None)`` when the batch is whole on every rank (no batch axis, or a
        batch its extent does not divide: every rank runs all rows)."""
        axis, n = self.batch_ranks()
        if n == 1 or x.shape[0] % n:
            return x, None
        i = self.mesh.get_coordinate()[self.mesh.mesh_dim_names.index(axis)]
        rows = x.shape[0] // n
        return x.narrow(0, i * rows, rows), self.mesh.get_group(axis)

    def join_batch(self, y, group):
        """Every rank's rows of ``y`` (``split_batch``'s group), in rank
        order; ``y`` itself for ``group=None``."""
        if group is None:
            return y
        import torch
        from repro_torch.core.spatial import _all_gather
        return torch.cat(_all_gather(y.contiguous(), group))
