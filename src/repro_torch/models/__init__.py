"""Models on the port's engine, and the one way JAX weights come across."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import comm
from repro_torch.core.plan import QuantizedSuperpack
from repro_torch.layers import common as cm


def shard(p: dict, specs: dict, dist) -> dict:
    """``p`` placed per ``specs`` on ``dist``'s mesh (each rank's blocks;
    superpacks split on their out-channels as ``TPSuperpack``s); ``p``
    itself for ``dist=None``."""
    return p if dist is None else dist.shard_params(p, specs)


def dense_cols(x: torch.Tensor, w: torch.Tensor, dist, full: int,
               b: torch.Tensor | None = None) -> torch.Tensor:
    """``x @ w (+ b)`` whole on every rank, for a (None, 'conv_out') weight
    ``w`` of ``full`` columns and its bias ``b``, each rank holding their
    column blocks (``w``, ``b`` themselves where they stay whole).  Where
    the 'conv_out' axes carry the image batch (each rank holds other rows
    of ``x``), the blocks are gathered whole first, their gradients summed
    over those axes; otherwise the product's columns are gathered over the
    'conv_out' axes in rank order, ``x`` entering through ``copy_to`` (its
    gradient summed over them)."""
    group, _, _ = cm.tp(dist, "conv_out", full)
    if group is not None:
        axes, batch = dist.axes_of(dist.resolve(("conv_out",))[0])
        if batch:
            w = comm.gather_axes(w, axes, -1, batch, "feature_weight_gather")
            if b is not None:
                b = comm.gather_axes(b, axes, -1, batch,
                                     "feature_bias_gather")
            group = None
        else:
            x = comm.copy_to(x, group, kind="feature_input")
    y = torch.matmul(x, w)
    if b is not None:
        y = y + b
    if group is None:
        return y
    return comm.gather_from(y, group, dim=-1, kind="feature_gather")


def params_from_numpy(np_params: dict, want: dict,
                      dev: torch.device) -> dict:
    """Copy the entries ``want`` names (name -> shape) from a dict of numpy
    arrays onto ``dev``, checking each shape.  A quantized superpack (any
    leaf with ``.q`` and ``.scale``, as JAX's ``QuantizedSuperpack`` holds
    them after ``np.asarray``) comes across as a ``QuantizedSuperpack`` of
    its int8 codes ``(rows, N)`` and f32 scale column ``(rows, 1)``."""
    out = {}
    for name, shape in want.items():
        leaf = np_params[name]
        if hasattr(leaf, "q") and hasattr(leaf, "scale"):
            q = np.asarray(leaf.q)
            scale = np.asarray(leaf.scale, np.float32)
            if q.dtype != np.int8 or q.shape != shape \
                    or scale.shape != (shape[0], 1):
                raise ValueError(f"{name}: int8 superpack {q.dtype} "
                                 f"{q.shape} with scales {scale.shape}, "
                                 f"config wants {shape}")
            out[name] = QuantizedSuperpack(
                torch.from_numpy(q.copy()),
                torch.from_numpy(scale.copy())).to(dev)
            continue
        arr = np.asarray(leaf, np.float32)
        if arr.shape != shape:
            raise ValueError(f"{name}: shape {arr.shape}, config wants "
                             f"{shape}")
        out[name] = torch.from_numpy(arr.copy()).to(dev)
    return out
