"""Shared layer primitives on plain dicts of tensors.

Counterpart of ``repro.layers.common``: the same parameter names and
layouts (dense weights ``(in, out)``, embeddings ``(vocab, dim)``).
Initialisers draw from an explicit seeded ``torch.Generator`` on the
device the tensors are made on; the logical sharding specs JAX's
initialisers return beside the params come from the ``*_specs``
functions (``dense_specs``, ``embed_specs``, ``rmsnorm_specs``), with
JAX's axis names.

On a mesh (``sharding.DistContext``) a dense layer is column-parallel
(its out dim split: ``dense_apply`` on the rank's columns gives the
rank's columns of the output) or row-parallel (its in dim split:
``row_parallel`` sums the ranks' f32 partial products over the group and
rounds once, as the single-rank product rounds once).

Sequence parallelism (``seq_parallel(group)``, which
``models.transformer`` enters around each layer where the residual
stream's S is split over ``group``): a tensor-parallel block takes its
input through ``tp_input`` (the S rows gathered on entry: over the
block's own group, with a reduce-scatter backward in place of
``copy_to``'s all-reduce) and leaves through ``row_parallel`` (a
reduce-scatter over S in place of the all-reduce); a block without tensor
parallelism gathers S on entry and keeps its rows of the output.
``sp_param`` puts a replicated parameter used on the rank's own rows (a
norm's gain) behind ``copy_to``, so its gradient is summed over the rows'
group.

``dense_apply`` and ``embed_logits`` accumulate in f32, as JAX's
``preferred_element_type=f32`` dots do.  On the CPU (and for f32 inputs)
both operands go up to f32 first, as JAX does on its CPU backend, so the
CPU tests compare like with like.  On the card a bf16 product stays bf16
in cuBLAS, which accumulates in f32: ``dense_apply`` rounds that sum once
to bf16, as JAX's dense layers do, and ``embed_logits`` writes it as f32
with no rounding (``mm_f32``: ``torch.mm(..., out_dtype=torch.float32)``),
as JAX's readout returns the dot's f32 result.  That overload has no
derivative, so ``mm_f32`` carries its own backward: the two products in
f32, as JAX's transpose of an f32-preferring dot computes them.
"""
from __future__ import annotations

import contextlib
from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.core import comm
from repro_torch.sharding import Spec


def spec(*axes) -> Spec:
    """Logical partition spec (axis names resolved later)."""
    return Spec(*axes)


def dense_specs(in_axis, out_axis, bias=False) -> dict:
    """JAX's ``dense_init`` specs: ``w`` (in_axis, out_axis), ``b``
    (out_axis,)."""
    s = {"w": spec(in_axis, out_axis)}
    if bias:
        s["b"] = spec(out_axis)
    return s


def rmsnorm_specs() -> dict:
    return {"g": spec(None)}


def embed_specs() -> dict:
    return {"w": spec("vocab", None)}


def tp(dist, logical, size: int):
    """(group, block index, block count) of a dim of ``size`` on the
    logical axis ``logical`` (or a mesh axis named as such) under ``dist``
    (``shard_params``' rule: (None, 0, 1) where it stays whole, and off a
    mesh)."""
    if dist is None or dist.mesh is None:
        return None, 0, 1
    entry = dist.resolve((logical,))[0]
    i, n = dist.shard_of(entry, size)
    return (dist.group(entry) if n > 1 else None), i, n


# the group the residual stream's S is split over in the layer running
# (None: whole)
_SEQ: list = [None]


@contextlib.contextmanager
def seq_parallel(group):
    """Run a layer whose residual stream holds this rank's S rows of
    ``group`` (None: the whole sequence)."""
    prev, _SEQ[0] = _SEQ[0], group
    try:
        yield
    finally:
        _SEQ[0] = prev


def tp_input(x, group):
    """A tensor-parallel block's input over ``group``: ``copy_to`` (its
    gradient summed over the group).  Under sequence parallelism ``x`` is
    the rank's S rows, gathered whole along dim 1: over the block's own
    group a gather whose backward reduce-scatters (the sum and the split
    in one), over another group a plain gather before the ``copy_to``."""
    sp = _SEQ[0]
    if sp is None:
        return comm.copy_to(x, group)
    if group is sp:
        return comm.gather_from(x, sp, dim=1, kind="sp_gather",
                                reduce_bwd=True)
    return comm.copy_to(comm.gather_from(x, sp, dim=1, kind="sp_gather"),
                        group)


def sp_param(p):
    """``p`` (a dict of tensors) as a layer reads it on the rank's own S
    rows: behind ``copy_to`` over the sequence's group, so the partial
    gradients of the rows are summed; ``p`` itself with S whole."""
    sp = _SEQ[0]
    if sp is None:
        return p
    return {k: comm.copy_to(v, sp, kind="sp_param") for k, v in p.items()}


def _randn(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32)


def dense_init(gen: torch.Generator, in_dim, out_dim, dtype=torch.bfloat16,
               bias=False, scale=None):
    scale = scale if scale is not None else in_dim ** -0.5
    params = {"w": (_randn(gen, (in_dim, out_dim)) * scale).to(dtype)}
    if bias:
        params["b"] = torch.zeros((out_dim,), dtype=dtype, device=gen.device)
    return params


def _f32_product(x: torch.Tensor) -> bool:
    return x.device.type == "cpu" or x.dtype == torch.float32


def dense_apply(p, x):
    """``x @ w (+ b)``: f32 accumulation, the bias added in f32, one
    rounding to ``x``'s dtype."""
    w = p["w"]
    if _f32_product(x):
        y = torch.matmul(x.float(), w.float())
        if "b" in p:
            y = y + p["b"].float()
        return y.to(x.dtype)
    w = w.to(x.dtype)
    if "b" in p:
        y = torch.addmm(p["b"].to(x.dtype), x.reshape(-1, x.shape[-1]), w)
        return y.reshape(*x.shape[:-1], w.shape[1])
    return torch.matmul(x, w)


def dense_partial(p, x):
    """``x @ w`` as its f32 sum (no bias, no rounding): the partial
    product of a row-parallel layer."""
    w = p["w"]
    if _f32_product(x):
        return torch.matmul(x.float(), w.float())
    y = mm_f32(x.reshape(-1, x.shape[-1]), w.to(x.dtype))
    return y.reshape(*x.shape[:-1], w.shape[1])


def row_parallel(p, x, group, kind="row_parallel_all_reduce"):
    """A row-parallel dense layer: the rank's rows of ``w`` on its
    columns of ``x``, the f32 partial products summed over ``group``, the
    bias added in f32, one rounding to ``x``'s dtype (``dense_apply``
    itself where ``group`` is None).  Under sequence parallelism
    (``seq_parallel``) the rank keeps its S rows of the output: over the
    sequence's own group the all-reduce is a reduce-scatter over S."""
    sp = _SEQ[0]
    if group is None:
        y = dense_apply(p, x)
        return y if sp is None else comm.split_to(y, sp, dim=1,
                                                  kind="sp_split")
    y = dense_partial(p, x)
    if sp is group:
        y = comm.reduce_scatter_to(y, group, dim=1,
                                   kind="sp_reduce_scatter")
    else:
        y = comm.reduce_from(y, group, kind)
        if sp is not None:
            y = comm.split_to(y, sp, dim=1, kind="sp_split")
    if "b" in p:
        y = y + p["b"].float()
    return y.to(x.dtype)


def rmsnorm_init(dim, device="cpu", dtype=torch.float32):
    return {"g": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm_apply(p, x, eps=1e-6, gemma_style=False):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    g = p["g"].float()
    y = y * (1.0 + g) if gemma_style else y * g
    return y.to(x.dtype)


def embed_init(gen: torch.Generator, vocab, dim, dtype=torch.bfloat16):
    return {"w": (_randn(gen, (vocab, dim)) * dim ** -0.5).to(dtype)}


def embed_apply(p, ids):
    return p["w"][ids]


class _MmF32(torch.autograd.Function):
    """``a @ b`` (2-D or batched 3-D, one dtype) with its f32 sum as the
    result (``out_dtype=torch.float32``, no rounding to the inputs'
    dtype).  Backward: ``da = g @ bᵀ`` and ``db = aᵀ @ g`` as f32 products
    of the f32 cotangent and the operands cast up, each rounded once to
    its operand's dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.dim() == 3:
            return torch.bmm(a, b, out_dtype=torch.float32)
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.float()
        da = db = None
        if ctx.needs_input_grad[0]:
            da = torch.matmul(g, b.float().transpose(-1, -2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = torch.matmul(a.float().transpose(-1, -2), g).to(b.dtype)
        return da, db


def mm_f32(a, b):
    """``a @ b`` for 2-D or 3-D ``a``, ``b`` of one dtype on the card: the
    f32 sum of the products (bf16 inputs on the tensor cores), with a
    backward (``_MmF32``)."""
    return _MmF32.apply(a, b)


def embed_logits(p, x):
    """Tied readout: (..., D) @ (V, D)^T, float32: the f32 sum itself, with
    no rounding to ``x``'s dtype on the way."""
    w = p["w"]
    if _f32_product(x):
        return torch.matmul(x.float(), w.float().t())
    y = mm_f32(x.reshape(-1, x.shape[-1]), w.to(x.dtype).t())
    return y.reshape(*x.shape[:-1], w.shape[0])


ACTS: dict[str, Callable] = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_exact": lambda x: F.gelu(x, approximate="none"),
    "relu": F.relu,
}
