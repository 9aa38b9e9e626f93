"""Device meshes over ``torch.distributed``, and the port's SPMD launcher.

Counterpart of ``repro.launch.mesh``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
initialised default group, with JAX's axis names, so the logical rules of
``sharding.DEFAULT_RULES`` resolve on it unchanged.  The constructors are
functions, never module state, and build over the first ``prod(shape)``
ranks; every rank of the default group calls them (a rank outside the
mesh gets ``get_coordinate() is None``).

A process that joined no group is a world of one, as JAX's host mesh is
one local device: the constructors then start a one-rank gloo group on an
in-memory store, so a one-rank mesh (``degrade(1)``) needs no launcher.
That group is the process's default group from then on, until
``one_rank_world_end`` (or ``dist.destroy_process_group``) ends it.

``run_spmd`` is the one launcher the tests and ``chip_smoke.py`` share:
it spawns ``world`` processes that meet through a ``FileStore`` in a
fresh temporary directory (no port, so concurrent launches cannot
collide), puts every rank on the card unless asked for the CPU, and
returns what each rank's function returned.  On one card the ranks share
it: NCCL refuses two ranks on one device, so the group is gloo whenever
ranks outnumber cards (and on the CPU), NCCL only with a card per rank.
"""
from __future__ import annotations

import math
import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Callable, Sequence

import torch
import torch.distributed as dist

_AXES_SPATIAL = ("data", "sp_h", "sp_w")


_ONE_RANK = [False]          # the default group is ``_ensure_world``'s


def _ensure_world():
    """Join a one-rank gloo group when this process joined none."""
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
        _ONE_RANK[0] = True


def one_rank_world_end():
    """End the one-rank group a mesh constructor started (a group the
    caller initialised is left alone)."""
    if _ONE_RANK[0] and dist.is_initialized():
        dist.destroy_process_group()
    _ONE_RANK[0] = False


def _mesh(shape: Sequence[int], axes: Sequence[str]):
    from torch.distributed.device_mesh import DeviceMesh
    _ensure_world()
    n = math.prod(shape)
    if n > dist.get_world_size():
        raise ValueError(f"mesh {tuple(shape)} needs {n} ranks, the group "
                         f"has {dist.get_world_size()}")
    device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def mesh_shape(mesh) -> dict[str, int]:
    """{axis name: extent} of a mesh (JAX's ``Mesh.shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def make_host_mesh(data: int = 1, model: int = 1, pod: int = 0):
    """Small explicit (data, model) mesh; with ``pod`` a (pod, data,
    model) one, the 'pod' axis the outer data-parallel axis (the batch
    over ('pod', 'data'), major to minor)."""
    if pod:
        return _mesh((pod, data, model), ("pod", "data", "model"))
    return _mesh((data, model), ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False):
    """JAX's production mesh: (data 16, model 16), or (pod 2, data 16,
    model 16) with ``multi_pod``; ``ValueError`` in a smaller world."""
    if multi_pod:
        return _mesh((2, 16, 16), ("pod", "data", "model"))
    return _mesh((16, 16), ("data", "model"))


def make_spatial_mesh(sp_h: int, sp_w: int = 1, data: int = 1):
    """Mesh for plane-parallel conv execution (``core.spatial``): 'sp_h' /
    'sp_w' carry one plane's rows / columns (the 'plane_h' / 'plane_w'
    targets of ``DEFAULT_RULES``), the leading 'data' axis the batch.
    Axis order (data, sp_h, sp_w), as JAX's: neighbouring row blocks land
    on neighbouring ranks."""
    return _mesh((data, sp_h, sp_w), _AXES_SPATIAL)


# ---------------------------------------------------------------------------
# the SPMD launcher
# ---------------------------------------------------------------------------

def _rank_main(rank, world, store_path, device, fn, args, out):
    try:
        use_nccl = (device == "cuda"
                    and torch.cuda.device_count() >= world)
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        store = dist.FileStore(store_path, world)
        dist.init_process_group("nccl" if use_nccl else "gloo", store=store,
                                rank=rank, world_size=world)
        dev = (torch.device("cuda", torch.cuda.current_device())
               if device == "cuda" else torch.device("cpu"))
        res = (rank, True, fn(rank, world, dev, *args))
    except BaseException:                   # reported to the parent, raised
        res = (rank, False, traceback.format_exc())
    # reported before the group goes, so a failing rank is heard before the
    # peers its exit disconnects
    out.put(res)
    if dist.is_initialized():
        dist.destroy_process_group()


def _more_failures(out, wait: float = 2.0) -> str:
    """Other ranks' failures reported within ``wait`` seconds (a rank's
    failure often breaks its peers' collectives a moment later)."""
    more = []
    deadline = time.monotonic() + wait
    while time.monotonic() < deadline:
        try:
            rank, ok, val = out.get(timeout=max(0.01, deadline
                                                - time.monotonic()))
        except queue.Empty:
            break
        if not ok:
            more.append(f"\n--- and rank {rank} failed:\n{val}")
    return "".join(more)


def run_spmd(fn: Callable, world: int, *args, device: str = "cuda",
             timeout: float = 600.0) -> list:
    """Run ``fn(rank, world, device, *args)`` on ``world`` spawned ranks of
    one default group and return the ranks' results in rank order.

    ``fn`` and ``args`` are pickled (``fn`` by its import path).  Ranks go
    on ``cuda`` unless ``device='cpu'``; there is no fallback from the
    card.  A rank that raises, or a launch that outlives ``timeout``
    seconds, stops every rank and raises here with the rank's traceback."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_spmd(device='cuda') needs a CUDA device; "
                           "pass device='cpu' for CPU ranks")
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="spmd-")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, os.path.join(tmp, "store"), device,
                               fn, args, out), daemon=True)
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        results: dict = {}
        deadline = time.monotonic() + timeout
        while len(results) < world:
            try:
                rank, ok, val = out.get(timeout=1.0)
            except queue.Empty:
                died = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode not in (None, 0)]
                if died or time.monotonic() >= deadline:
                    raise RuntimeError(
                        f"run_spmd: rank(s) {died or 'all'} gave no result "
                        f"(exit codes {[p.exitcode for p in procs]}, "
                        f"timeout {timeout} s)") from None
                continue
            if not ok:
                raise RuntimeError(f"run_spmd: rank {rank} of {world} "
                                   f"failed:\n{val}{_more_failures(out)}")
            results[rank] = val
        for p in procs:
            p.join(timeout=60)
        return [results[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        out.close()
        shutil.rmtree(tmp, ignore_errors=True)
