"""Collectives over ``torch.distributed`` groups for the mesh code.

Two layers:

- The transport helpers ``_send_recv``, ``_all_gather``, ``_gather_to``,
  ``_all_reduce``, ``_reduce_scatter``, ``_broadcast`` and ``_all_to_all``
  move tensors
  over one group.  On a gloo group (the
  one-card group: NCCL refuses two ranks on one device) a CUDA tensor goes
  through pinned host buffers, since gloo moves host tensors; the group's
  backend chooses this, not a caught failure.  On an NCCL group the same
  code runs on the device tensors.  The plane-parallel executor
  (``core.spatial``) and the layers below share them.
- The autograd Functions the tensor- and expert-parallel layers call,
  each with its conjugate backward, as in Megatron: ``copy_to`` (copy
  forward, all-reduce backward), ``reduce_from`` (all-reduce forward,
  copy backward), ``gather_from`` (all-gather along a dim forward, this
  rank's slice backward; ``reduce_bwd=True``: the cotangents summed over
  the group first, a reduce-scatter, where each rank reads its own part
  of the gathered tensor; ``gather_axes``: over several mesh axes in
  turn), ``split_to`` (this rank's slice forward,
  all-gather backward), ``reduce_scatter_to`` (the sum over the group,
  this rank's part along a dim, forward; all-gather backward: sequence
  parallelism's exit) and ``all_to_all`` (its own transpose).  A group
  of ``None`` is a one-rank group: every Function is then the identity.

The plain collectives ``all_reduce`` (sum or max), ``all_gather``,
``gather_to``, ``reduce_scatter``, ``broadcast`` and ``all_to_all`` serve the train
step's gradient buckets, the optimiser and the checkpoints; they carry no
backward.

Every Function call and every plain collective adds to ``traffic()``: per kind, the calls, the bytes
this rank hands to the collective (its input tensor's bytes; for a
backward, the cotangent's) and, under ``timed(True)``, the host seconds
of the transfer with the device synchronised before and after it.
``collectives()`` gives beside the calls and bytes what the roofline's
ring factors read (``launch.roofline.collective_bytes``): each kind's
``op`` (``all_reduce``, ``all_gather``, ``reduce_scatter``,
``all_to_all``, ``broadcast``, ``gather``, ``send_recv``) and its
``sizes``, {group size: bytes} summed over the calls in XLA's convention
(an all-gather's output, a reduce-scatter's output, what a send-receive
step lands here, the tensor itself otherwise).  ``_send_recv``, the
plane-parallel halo exchange, adds its steps under the kind
``halo_exchange``.
"""
from __future__ import annotations

import contextlib
import time

import torch
import torch.distributed as dist

# ---------------------------------------------------------------------------
# transport
# ---------------------------------------------------------------------------


def _staged(t: torch.Tensor, group) -> bool:
    """A CUDA tensor on a gloo group goes through host memory."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _host(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return h.copy_(t)


def _send_recv(sends, recvs, group) -> None:
    """Post every send ``(tensor, peer)`` and every receive ``(buffer,
    peer)`` of one exchange step as one batch and wait for all; peers are
    global ranks, receives land in their buffers."""
    if not sends and not recvs:
        return
    _record("halo_exchange", "send_recv", sum(_bytes(t) for t, _ in sends),
            2, size=sum(_bytes(b) for b, _ in recvs))
    probe = (sends or recvs)[0][0]
    staged = _staged(probe, group)
    hs = [(_host(t) if staged else t, p) for t, p in sends]
    hr = [(torch.empty(b.shape, dtype=b.dtype, pin_memory=True)
           if staged else b, p) for b, p in recvs]
    ops = ([dist.P2POp(dist.isend, t, p, group) for t, p in hs]
           + [dist.P2POp(dist.irecv, b, p, group) for b, p in hr])
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if staged:
        for (b, _), (h, _) in zip(recvs, hr):
            b.copy_(h)


def _all_gather(t: torch.Tensor, group) -> list[torch.Tensor]:
    staged = _staged(t, group)
    src = _host(t) if staged else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return [p.to(t.device) for p in parts] if staged else parts


def _all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    if _staged(t, group):
        h = _host(t)
        dist.all_reduce(h, op=op, group=group)
        return h.to(t.device)
    dist.all_reduce(t, op=op, group=group)
    return t


def _gather_to(t: torch.Tensor, group, dim: int):
    """Every rank's ``t`` concatenated along ``dim`` on the group's rank 0
    (in group rank order); None on the others."""
    staged = _staged(t, group)
    src = _host(t) if staged else t.contiguous()
    first = dist.get_rank(group) == 0
    parts = ([torch.empty_like(src) for _ in range(dist.get_world_size(
        group))] if first else None)
    dist.gather(src, parts, dst=dist.get_global_rank(group, 0), group=group)
    if not first:
        return None
    return torch.cat([p.to(t.device) for p in parts] if staged else parts,
                     dim)


def _reduce_scatter(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The sum of ``t`` over ``group``, this rank's equal part along
    ``dim``.  gloo (and so every staged transfer) sums whole and cuts;
    NCCL reduce-scatters."""
    n = dist.get_world_size(group)
    i = dist.get_rank(group)
    size = t.shape[dim] // n
    if dist.get_backend(group) == "gloo":
        # a staged transfer sums a host copy; a CPU tensor is summed in
        # place, so it is copied first
        src = t.contiguous() if _staged(t, group) else t.contiguous().clone()
        return _all_reduce(src, group).narrow(dim, i * size,
                                              size).contiguous()
    src = t.movedim(dim, 0).contiguous()
    out = torch.empty((size,) + src.shape[1:], dtype=t.dtype,
                      device=t.device)
    dist.reduce_scatter(out, list(src.chunk(n)), group=group)
    return out.movedim(0, dim).contiguous()


def _broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """``t`` of the group's rank ``src`` (a group rank) on every rank;
    the others pass a buffer of its shape and dtype."""
    peer = dist.get_global_rank(group, src)
    if _staged(t, group):
        h = _host(t)
        dist.broadcast(h, src=peer, group=group)
        return h.to(t.device)
    t = t.contiguous()
    dist.broadcast(t, src=peer, group=group)
    return t


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """Dim 0 of ``t`` cut into one equal block a rank of ``group``: block
    j goes to rank j, and the block rank j sent here lands at j."""
    staged = _staged(t, group)
    src = _host(t) if staged else t.contiguous()
    out = (torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
           if staged else torch.empty_like(src))
    dist.all_to_all_single(out, src, group=group)
    return out.to(t.device) if staged else out


# ---------------------------------------------------------------------------
# traffic accounting
# ---------------------------------------------------------------------------

_TRAFFIC: dict[str, list] = {}
_TIMED = [False]


def traffic() -> dict[str, dict]:
    """{kind: {"calls", "bytes", "seconds"}} since ``traffic_reset``."""
    return {k: {"calls": v[0], "bytes": v[1], "seconds": v[2]}
            for k, v in _TRAFFIC.items()}


def collectives() -> dict[str, dict]:
    """{kind: {"op", "calls", "bytes", "sizes"}} since ``traffic_reset``:
    ``traffic()``'s calls and bytes with what the ring factors read
    (module docstring)."""
    return {k: {"op": v[3], "calls": v[0], "bytes": v[1],
                "sizes": dict(v[4])}
            for k, v in _TRAFFIC.items()}


def traffic_reset() -> None:
    _TRAFFIC.clear()


@contextlib.contextmanager
def timed(on: bool = True):
    """Time every collective on the host clock, the device synchronised
    around it (what 4m reads; off, nothing synchronises)."""
    prev, _TIMED[0] = _TIMED[0], on
    try:
        yield
    finally:
        _TIMED[0] = prev


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# the size XLA's convention gives a collective, from its input's bytes and
# its group size: an all-gather's (and a gather's) output, a
# reduce-scatter's output, the input itself otherwise
_SIZE = {"all_gather": lambda b, n: b * n, "gather": lambda b, n: b * n,
         "reduce_scatter": lambda b, n: b // n}


def _record(kind: str, op: str, nbytes: int, n: int, size=None) -> list:
    """Add one call of ``op`` over ``n`` ranks to ``kind``: ``nbytes``
    handed to it, ``size`` in XLA's convention (from ``nbytes`` by
    default)."""
    rec = _TRAFFIC.setdefault(kind, [0, 0, 0.0, op, {}])
    rec[0] += 1
    rec[1] += nbytes
    if size is None:
        size = _SIZE.get(op, lambda b, n: b)(nbytes, n)
    rec[4][n] = rec[4].get(n, 0) + size
    return rec


def _run(kind: str, t: torch.Tensor, fn, op: str, group):
    rec = _record(kind, op, _bytes(t), 1 if group is None
                  else dist.get_world_size(group))
    if not _TIMED[0]:
        return fn()
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    out = fn()
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    rec[2] += time.perf_counter() - t0
    return out


def all_reduce(t: torch.Tensor, group, kind: str = "all_reduce",
               op: str = "sum"):
    """The sum (``op='max'``: the maximum) of ``t`` over ``group`` (a new
    tensor; ``t`` is left as it is), counted under ``kind``; ``t`` itself
    for a one-rank group (None)."""
    if group is None:
        return t
    rop = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
    return _run(kind, t, lambda: _all_reduce(t.contiguous().clone(), group,
                                             rop), "all_reduce", group)


def gather_to(t: torch.Tensor, group, dim: int, kind: str = "gather"):
    """Every rank's ``t`` concatenated along ``dim`` on the group's rank 0
    only (None on the others; ``t`` for a one-rank group)."""
    if group is None:
        return t
    return _run(kind, t, lambda: _gather_to(t, group, dim % t.dim()),
                "gather", group)


def reduce_scatter(t: torch.Tensor, group, dim: int = 0,
                   kind: str = "reduce_scatter") -> torch.Tensor:
    """The sum of ``t`` over ``group``, this rank's equal part along
    ``dim`` (in group rank order)."""
    if group is None:
        return t
    return _run(kind, t, lambda: _reduce_scatter(t, group, dim % t.dim()),
                "reduce_scatter", group)


def barrier(group) -> None:
    """Every rank of ``group`` meets here (nothing for None)."""
    if group is not None:
        dist.barrier(group=group)


def broadcast(t: torch.Tensor, src: int, group, kind: str = "broadcast"):
    """Group rank ``src``'s ``t`` on every rank of ``group``."""
    if group is None:
        return t
    return _run(kind, t, lambda: _broadcast(t, src, group), "broadcast",
                group)


def all_gather(t: torch.Tensor, group, dim: int,
               kind: str = "all_gather") -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in group rank order
    (``t`` for a one-rank group)."""
    if group is None:
        return t
    return _run(kind, t, lambda: torch.cat(
        _all_gather(t.contiguous(), group), dim=dim), "all_gather", group)


def all_to_all(t: torch.Tensor, group, kind: str = "all_to_all"):
    return _run(kind, t, lambda: _all_to_all(t, group), "all_to_all",
                group)


def _slice(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    i = dist.get_rank(group)
    size = t.shape[dim] // n
    return t.narrow(dim, i * size, size).contiguous()


# ---------------------------------------------------------------------------
# the autograd Functions
# ---------------------------------------------------------------------------


class _CopyTo(torch.autograd.Function):
    """Forward: ``x`` as it is; backward: the cotangent summed over the
    group (a replicated input read by every rank's block)."""

    @staticmethod
    def forward(ctx, x, group, kind):
        ctx.group, ctx.kind = group, kind
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group, ctx.kind + "_bwd"), None, None


class _ReduceFrom(torch.autograd.Function):
    """Forward: ``x`` summed over the group; backward: the cotangent as it
    is (every rank's partial gets the whole cotangent)."""

    @staticmethod
    def forward(ctx, x, group, kind):
        return all_reduce(x, group, kind)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFrom(torch.autograd.Function):
    """Forward: every rank's ``x`` concatenated along ``dim`` in rank
    order; backward: this rank's slice of the cotangent."""

    @staticmethod
    def forward(ctx, x, group, dim, kind):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim, kind)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.group, ctx.dim), None, None, None


class _GatherFromReduce(torch.autograd.Function):
    """Forward: every rank's ``x`` concatenated along ``dim`` in rank
    order; backward: the cotangents summed over the group, this rank's
    part (a reduce-scatter: each rank reads its own columns of the
    gathered tensor, so each part's gradient comes from every rank)."""

    @staticmethod
    def forward(ctx, x, group, dim, kind):
        ctx.group, ctx.dim, ctx.kind = group, dim, kind
        return all_gather(x, group, dim, kind)

    @staticmethod
    def backward(ctx, g):
        return (reduce_scatter(g, ctx.group, ctx.dim, ctx.kind + "_bwd"),
                None, None, None)


class _SplitTo(torch.autograd.Function):
    """Forward: this rank's equal slice of ``x`` along ``dim``; backward:
    every rank's cotangent slice gathered back along ``dim``."""

    @staticmethod
    def forward(ctx, x, group, dim, kind):
        ctx.group, ctx.dim, ctx.kind = group, dim, kind
        return _slice(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return (all_gather(g, ctx.group, ctx.dim, ctx.kind + "_bwd"),
                None, None, None)


class _ReduceScatterTo(torch.autograd.Function):
    """Forward: ``x`` summed over the group, this rank's equal part along
    ``dim``; backward: every rank's cotangent part gathered back along
    ``dim`` (every rank's partial gets the whole cotangent)."""

    @staticmethod
    def forward(ctx, x, group, dim, kind):
        ctx.group, ctx.dim, ctx.kind = group, dim, kind
        return reduce_scatter(x, group, dim, kind)

    @staticmethod
    def backward(ctx, g):
        return (all_gather(g, ctx.group, ctx.dim, ctx.kind + "_bwd"),
                None, None, None)


class _AllToAll(torch.autograd.Function):
    """Forward and backward: the equal-block all-to-all along dim 0 (its
    own transpose)."""

    @staticmethod
    def forward(ctx, x, group, kind):
        ctx.group, ctx.kind = group, kind
        return all_to_all(x, group, kind)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, ctx.group, ctx.kind + "_bwd"), None, None


def copy_to(x, group, kind: str = "copy_to"):
    return x if group is None else _CopyTo.apply(x, group, kind)


def reduce_from(x, group, kind: str = "all_reduce"):
    return x if group is None else _ReduceFrom.apply(x, group, kind)


def gather_from(x, group, dim: int = -1, kind: str = "all_gather",
                reduce_bwd: bool = False):
    """``reduce_bwd``: the ranks read different parts of the gathered
    tensor (the cotangents differ), so the backward sums them."""
    if group is None:
        return x
    fn = _GatherFromReduce if reduce_bwd else _GatherFrom
    return fn.apply(x, group, dim % x.dim(), kind)


def gather_axes(x, axes, dim: int, reduce=(), kind: str = "all_gather"):
    """``x``, a block split along ``dim`` over ``axes`` ((mesh axis,
    group) pairs, major to minor, as ``DistContext.shard_of`` counts
    blocks), gathered whole: over each axis in turn, minor first.  The
    backward keeps the rank's block of the cotangent, summed first over
    the axes named in ``reduce`` (``gather_from(reduce_bwd=True)``: their
    ranks read different inputs, so each block's gradient comes from all
    of them)."""
    for name, group in reversed(tuple(axes)):
        x = gather_from(x, group, dim, kind, reduce_bwd=name in reduce)
    return x


def split_to(x, group, dim: int = 0, kind: str = "split_to"):
    if group is None:
        return x
    return _SplitTo.apply(x, group, dim % x.dim(), kind)


def reduce_scatter_to(x, group, dim: int = 1,
                      kind: str = "reduce_scatter_to"):
    if group is None:
        return x
    return _ReduceScatterTo.apply(x, group, dim % x.dim(), kind)


def all_to_all_fn(x, group, kind: str = "all_to_all"):
    return x if group is None else _AllToAll.apply(x, group, kind)
