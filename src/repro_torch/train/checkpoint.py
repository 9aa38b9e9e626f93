"""Fault-tolerant checkpointing: atomic directory swap, async save
thread, ``latest``-pointer resume, keep-k GC.

Counterpart of ``repro.train.checkpoint``, JAX's on-disk layout: a flat
{path: array} npz of the state tree (paths as ``train.tree.tree_paths``
gives them) and a JSON manifest.  bf16 tensors are stored as f32, which
is lossless, and ``restore`` casts each array back to its template
leaf's dtype and device.  The snapshot to host memory happens on the
caller's thread; the write on a background thread."""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.train.tree import tree_paths, tree_unflatten


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

    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state: Any, meta: Optional[dict] = None,
             block: bool = False):
        """Snapshot ``state`` to host memory now, write it (off-thread
        unless ``block`` or the manager is synchronous).  The previous
        writer is joined first: two writers on one step's tmp dir would
        race."""
        self.wait()
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
        if self._thread is not None:
            self._thread.join()
            self._thread = None

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

    def restore(self, template: Any, step: Optional[int] = None) -> Any:
        """The checkpoint at ``step`` (default: the latest) in the structure
        of ``template``: each leaf a tensor of its template leaf's dtype on
        its device (numpy arrays stay numpy, cast to the leaf's dtype)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError("no checkpoint found")
        name = f"step_{step:08d}"
        with np.load(os.path.join(self.dir, name, "arrays.npz")) as z:
            flat = {k: z[k] for k in z.files}
        leaves = []
        for key, leaf in tree_paths(template):
            arr = flat[key]
            if torch.is_tensor(leaf):
                arr = torch.from_numpy(np.array(arr)).to(
                    device=leaf.device, dtype=leaf.dtype)
            elif hasattr(leaf, "dtype"):
                arr = arr.astype(leaf.dtype)
            leaves.append(arr)
        return tree_unflatten(template, leaves)
