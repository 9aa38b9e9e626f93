"""CUDA graphs for the serving executables: one captured program per image
bucket (``DynamicImageBatcher``) and per decode slot (``ContinuousBatcher``).

Counterpart of the JAX package's jitted executables (one ``jax.jit`` per
bucket shape in ``repro.serving.image_batcher``, the one jitted B = 1
``_step1`` in ``repro.serving.batcher``): a graph is one captured launch
sequence, replayed with one host call, so the host's Python per planned
site runs once at capture and never again.

A capture records the hand-written kernels' wrappers once each, and a
replay launches the same kernels without passing through a wrapper, so
the wrappers' launch counters do not move on a replay.  ``CapturedGraph``
keeps the counters' deltas over its capture (``kernels``) and its
``replays``, and ``launches()`` gives the kernel launches the replays
made: captured count × replays.

A graph holds one rank's work only.  A bucket whose plans split a plane
across ranks (a spatial mesh, ``core.spatial``) moves halos between
processes, which no capture records: the image batcher runs such buckets
eagerly and captures none.  Nothing here falls back to eager execution:
a capture or a replay that fails raises.
"""
from __future__ import annotations

from typing import Callable

import torch


def launch_counts() -> dict[str, int]:
    """The hand-written kernels' launch counters, by kernel: A, B, C, D and
    their int8 entries, and F."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.untangled_conv import (
        untangled_conv2d_superpack as conv, untangled_deconv2d as deconv)
    return {"A": deconv.launches, "A_int8": deconv.launches_int8,
            "D": deconv.launches_tiled, "D_int8": deconv.launches_tiled_int8,
            "B": conv.launches, "B_int8": conv.launches_int8,
            "C": conv.launches_tiled, "C_int8": conv.launches_tiled_int8,
            "F": flash_attention.launches}


class CapturedGraph:
    """``fn()`` captured once into a ``torch.cuda.CUDAGraph``: ``out`` is
    its static output (overwritten by every replay), ``kernels`` the
    hand-written kernel launches the capture recorded, ``replays`` the
    replays so far.  ``fn`` reads its inputs from the static tensors
    ``inputs``, which the caller writes before each replay.  The caller
    runs ``fn`` eagerly
    right before the capture (kernel builds, cached tables and workspaces
    happen there, never inside a capture).  ``pool`` is a
    ``torch.cuda.graph_pool_handle()`` shared with graphs that never run
    concurrently with this one; ``grad_mode`` the context ``fn`` runs in
    (``torch.inference_mode`` or ``torch.no_grad``)."""

    def __init__(self, fn: Callable, inputs: tuple, *, pool=None,
                 grad_mode: Callable = torch.inference_mode):
        self.inputs = inputs
        self.graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        with grad_mode(), torch.cuda.graph(self.graph, pool=pool):
            self.out = fn()
        after = launch_counts()
        self.kernels = {k: after[k] - before[k] for k in after
                        if after[k] != before[k]}
        self.replays = 0

    def replay(self):
        self.graph.replay()
        self.replays += 1

    def launches(self) -> dict[str, int]:
        """Kernel launches of the replays so far, by kernel."""
        return {k: n * self.replays for k, n in self.kernels.items()}
