"""Elastic scaling: restore a checkpoint onto another mesh.

Counterpart of ``repro.runtime.elastic``.  Checkpoints are
mesh-independent (``train.checkpoint``: every leaf whole), so elasticity
is each rank cutting its block of every leaf for the surviving mesh.
``shrink_mesh`` models the coordinator's decision after node loss: drop
the data-parallel extent to the largest power of two the surviving ranks
support, keeping the model-parallel extent (tensor-parallel groups stay
whole; only whole data-parallel replicas are dropped).  The survivors are
the first ranks of the default group; every rank of the group builds the
mesh (a rank left out gets no coordinate, and ``restore_on_mesh`` gives
it None).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.launch.mesh import make_host_mesh
from repro_torch.sharding import DistContext, Placement, Spec
from repro_torch.train.checkpoint import CheckpointManager


def shrink_mesh(devices_left: int, model: int, pod: int = 0):
    """Largest (data, model) mesh from the surviving ranks ((pod, data,
    model) with ``pod``), model-parallel extent preserved."""
    if devices_left < model:
        raise ValueError(f"cannot keep TP={model} with {devices_left} chips")
    data = 1
    while data * 2 * model * max(pod, 1) <= devices_left:
        data *= 2
    return make_host_mesh(data=data, model=model, pod=pod)


def _placements(specs, dist):
    if isinstance(specs, Spec):
        return dist.sharding(specs)
    if isinstance(specs, Placement):
        return specs
    if isinstance(specs, dict):
        return {k: _placements(v, dist) for k, v in specs.items()}
    return type(specs)(_placements(v, dist) for v in specs)


def restore_on_mesh(ckpt: CheckpointManager, template, logical_specs,
                    dist: DistContext, step: Optional[int] = None):
    """``template``-shaped state restored as this rank's blocks on the
    (new) mesh of ``dist``: ``logical_specs`` a tree of logical ``Spec``
    (resolved by ``dist``) or of ``Placement`` (``launch.steps.
    train_state_specs(cfg, dist, opt_cfg)[1]`` for a train state) matching
    ``template``.  None on a rank the mesh left out."""
    if dist.mesh is not None and dist.mesh.get_coordinate() is None:
        return None
    return ckpt.restore(template, step=step,
                        shardings=_placements(logical_specs, dist))
