"""Elastic scaling: the mesh the surviving ranks form after node loss.

Counterpart of ``repro.runtime.elastic``.  ``shrink_mesh`` models the
coordinator's decision: drop the data-parallel extent to the largest power
of two the surviving ranks support, keeping the model-parallel extent
(tensor-parallel groups stay whole; only whole data-parallel replicas are
dropped).  The survivors are the first ranks of the default group; every
rank of the group builds the mesh (a rank left out gets no coordinate).
Restoring a checkpoint onto the new mesh places sharded parameters, which
is ROADMAP Queue 1 item 13c.
"""
from __future__ import annotations

from repro_torch.launch.mesh import make_host_mesh


def shrink_mesh(devices_left: int, model: int):
    """Largest (data, model) mesh from the surviving ranks, model-parallel
    extent preserved."""
    if devices_left < model:
        raise ValueError(f"cannot keep TP={model} with {devices_left} chips")
    data = 1
    while data * 2 * model <= devices_left:
        data *= 2
    return make_host_mesh(data=data, model=model)
