"""Fault-tolerant checkpointing: atomic directory swap, async save
thread, ``latest``-pointer resume, keep-k GC.

Counterpart of ``repro.train.checkpoint``, JAX's on-disk layout: a flat
{path: array} npz of the state tree (paths as ``train.tree.tree_paths``
gives them) and a JSON manifest.  bf16 tensors are stored as f32, which
is lossless, and ``restore`` casts each array back to its template
leaf's dtype and device.  The snapshot to host memory happens on the
caller's thread; the write on a background thread.

On a mesh (``CheckpointManager(..., dist=)``) every rank of the mesh
calls ``save``, ``wait`` and ``restore`` at the same points: ``save``
gathers each leaf whole on the mesh's first rank over its
``sharding.Placement`` (the spec's axes and a ZeRO-1 part over 'data'),
which writes the same
mesh-independent npz as on one card, and ``wait`` joins that writer and
then meets every rank at a barrier, so no rank reads ``latest`` before
it is published.  ``restore(..., shardings=)`` gives each rank its block
of every leaf (``Placement.block``), whatever mesh wrote the file."""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.train.tree import tree_leaves, tree_paths, tree_unflatten


def _placement_leaves(tree) -> list:
    """The ``Placement`` leaves of a tree (a dataclass, not a node)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _placement_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [p for c in tree for p in _placement_leaves(c)]
    return [tree]


def _flatten(tree) -> dict[str, np.ndarray]:
    flat = {}
    for key, leaf in tree_paths(tree):
        t = torch.as_tensor(leaf).detach()
        if t.dtype == torch.bfloat16:       # numpy has no bf16: f32 is
            t = t.float()                   # lossless, restore casts back
        flat[key] = t.cpu().numpy()
    return flat


class CheckpointManager:
    """Directory layout::

        dir/step_000100/arrays.npz        (atomic: written to .tmp, renamed)
        dir/step_000100/manifest.json     {"step": 100, "meta": {...}}
        dir/latest                        -> "step_000100"
    """

    def __init__(self, directory: str, keep: int = 3, async_save: bool = True,
                 dist=None):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self.dist = dist if dist is not None and dist.mesh is not None \
            else None
        self._thread: Optional[threading.Thread] = None
        if self.dist is None or self.dist.is_first():
            os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state: Any, meta: Optional[dict] = None,
             block: bool = False, placements: Any = None):
        """Snapshot ``state`` to host memory now, write it (off-thread
        unless ``block`` or the manager is synchronous).  The previous
        writer is joined first: two writers on one step's tmp dir would
        race.  On a mesh ``placements`` (a tree of ``Placement`` matching
        ``state``; None: every leaf whole on every rank) gathers each
        leaf, and only the mesh's first rank writes."""
        self.wait()
        if self.dist is not None and placements is not None:
            leaves = [pl.gather(torch.as_tensor(t), root=True) for t, pl in
                      zip(tree_leaves(state), _placement_leaves(placements))]
            state = None if leaves[0] is None else tree_unflatten(state,
                                                                  leaves)
        if self.dist is not None and not self.dist.is_first():
            return
        flat = _flatten(state)
        if self.async_save and not block:
            self._thread = threading.Thread(
                target=self._write, args=(step, flat, meta or {}), daemon=True)
            self._thread.start()
        else:
            self._write(step, flat, meta or {})

    def _write(self, step: int, flat: dict, meta: dict):
        name = f"step_{step:08d}"
        tmp = os.path.join(self.dir, name + ".tmp")
        final = os.path.join(self.dir, name)
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "meta": meta,
                       "time": time.time()}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                      # atomic publish
        with open(os.path.join(self.dir, "latest.tmp"), "w") as f:
            f.write(name)
        os.replace(os.path.join(self.dir, "latest.tmp"),
                   os.path.join(self.dir, "latest"))
        self._gc()

    def wait(self):
        """Join the writer; on a mesh then meet every rank of it."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.dist is not None:
            from repro_torch.core import comm
            comm.barrier(self.dist.mesh_group())

    def _gc(self):
        steps = sorted(d for d in os.listdir(self.dir)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for d in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        p = os.path.join(self.dir, "latest")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            name = f.read().strip()
        man = os.path.join(self.dir, name, "manifest.json")
        if not os.path.exists(man):
            return None
        with open(man) as f:
            return json.load(f)["step"]

    def restore(self, template: Any, step: Optional[int] = None,
                shardings: Any = None) -> Any:
        """The checkpoint at ``step`` (default: the latest) in the structure
        of ``template``: each leaf a tensor of its template leaf's dtype on
        its device (numpy arrays stay numpy, cast to the leaf's dtype).
        ``shardings``: a tree of ``Placement`` matching ``template``; each
        leaf is then this rank's block of the whole array (how an elastic
        restart re-shards onto another mesh).  The template may hold a
        part of the saved state (its keys are read)."""
        pls = (_placement_leaves(shardings) if shardings is not None
               else None)
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError("no checkpoint found")
        name = f"step_{step:08d}"
        # the template's arrays only: a template of part of the state
        # reads that part of the file
        with np.load(os.path.join(self.dir, name, "arrays.npz")) as z:
            flat = {k: z[k] for k, _ in tree_paths(template)}
        leaves = []
        for j, (key, leaf) in enumerate(tree_paths(template)):
            arr = flat[key]
            if pls is not None:
                arr = pls[j].block(torch.from_numpy(arr))
                dev = leaf.device if torch.is_tensor(leaf) else "cpu"
                dt = leaf.dtype if torch.is_tensor(leaf) else arr.dtype
                leaves.append(arr.to(device=dev, dtype=dt))
                continue
            if torch.is_tensor(leaf):
                arr = torch.from_numpy(np.array(arr)).to(
                    device=leaf.device, dtype=leaf.dtype)
            elif hasattr(leaf, "dtype"):
                arr = arr.astype(leaf.dtype)
            leaves.append(arr)
        return tree_unflatten(template, leaves)
