"""The port's sharding rules (``repro_torch.sharding``) and meshes
(``repro_torch.launch.mesh``) against the JAX package's: ``image_spec``
and ``DEFAULT_RULES``, ``spatial_tiles`` on the launcher's meshes (four
gloo ranks on the CPU) against JAX's reading of the same axis extents,
``split_batch``/``join_batch`` (each rank's rows, joined in order), the
one-rank world and its end, and the launcher's failure path."""
import dataclasses
import math
import types

import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from repro import sharding as jsh
from repro_torch import sharding as tsh
from repro_torch.launch.mesh import run_spmd

RULES = [
    dict(jsh.DEFAULT_RULES),
    {**jsh.DEFAULT_RULES, "batch": ("pod", "data"), "seq": "model"},
    {**jsh.DEFAULT_RULES, "plane_h": ("data", "sp_h"), "plane_w": None},
    # make_dist's dp_only rules: the batch over every axis
    {**jsh.DEFAULT_RULES, "batch": ("data", "model"), "heads": None,
     "ffn": None, "vocab": None, "kv_heads": None},
]
# (constructor, args) of the meshes the launcher's ranks build
MESHES = [("make_spatial_mesh", (2, 2)), ("make_spatial_mesh", (4, 1)),
          ("make_spatial_mesh", (2, 1, 2)), ("make_spatial_mesh", (1, 4)),
          ("make_host_mesh", (2, 2)), ("make_host_mesh", (4, 1))]


def same(spec_t, spec_j) -> bool:
    return tuple(spec_t) == tuple(spec_j)


@pytest.mark.parametrize("rules", range(len(RULES)))
def test_specs_match_jax(rules):
    jd = jsh.DistContext(mesh=None, rules=dict(RULES[rules]))
    td = tsh.DistContext(mesh=None, rules=dict(RULES[rules]))
    assert same(td.image_spec(), jd.image_spec())
    assert td.spatial_tiles() == jd.spatial_tiles() == (1, 1)
    assert td.batch_ranks() == (None, 1)
    x = object()
    assert td.split_batch(x) == (x, None) and td.join_batch(x, None) is x


def test_constants_match_jax():
    assert tsh.DEFAULT_RULES == jsh.DEFAULT_RULES
    assert same(tsh.Spec(("data",), None), P(("data",), None))
    assert same(tsh.Spec(("pod", "data")), P(("pod", "data")))


def test_one_rank_world_without_a_launcher():
    """A process that joined no group is a world of one: a one-rank mesh
    needs no launcher, a mesh larger than the world is refused, and
    ``one_rank_world_end`` ends the group it started."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import (make_host_mesh, make_spatial_mesh,
                                         mesh_shape, one_rank_world_end)
    assert not dist.is_initialized()
    try:
        mesh = make_host_mesh()
        assert mesh_shape(mesh) == {"data": 1, "model": 1}
        assert tsh.DistContext(mesh).spatial_tiles() == (1, 1)
        assert tsh.DistContext(mesh).batch_ranks() == (None, 1)
        with pytest.raises(ValueError, match="needs 4 ranks"):
            make_spatial_mesh(2, 2)
    finally:
        one_rank_world_end()
    assert not dist.is_initialized()


def _mesh_rank(rank, world, dev):
    import torch
    from repro_torch.launch import mesh as lm
    out = []
    for make, args in MESHES:
        mesh = getattr(lm, make)(*args)
        per_rules = []
        for rules in RULES:
            d = tsh.DistContext(mesh, rules=dict(rules))
            x = torch.arange(16.0).reshape(8, 2)
            part, group = d.split_batch(x)
            back = d.join_batch(part, group)
            per_rules.append((d.spatial_tiles(), d.batch_ranks(),
                              part[:, 0].tolist(), bool(torch.equal(back, x))))
        # each rank's rows of a batch of 8 (and of 3, which no extent of 2
        # or 4 divides), joined back in rank order
        d = tsh.DistContext(mesh)
        rows = []
        for b in (8, 3):
            x = torch.arange(b * 2.0).reshape(b, 2) + 100 * b
            part, group = d.split_batch(x)
            back = d.join_batch(part * 2.0, group)
            rows.append((part[:, 0].tolist(), bool(torch.equal(back, x * 2))))
        out.append((lm.mesh_shape(mesh), per_rules, rows))
    return out


def _failing_rank(rank, world, dev):
    if rank == 1:
        raise KeyError("planted failure on rank 1")
    import torch.distributed as dist
    dist.barrier()


def test_spatial_tiles_on_the_launchers_meshes():
    """Four CPU ranks build each mesh: its axis extents, and
    ``spatial_tiles`` under every rule set equal to JAX's reading of the
    same extents; the batch axes and their extent, and each rank's rows
    of a batch over several axes (split major to minor in the order
    listed, as JAX's ``P(('data', 'model'))``), joined back in order."""
    results = run_spmd(_mesh_rank, 4, device="cpu", timeout=120)
    for r, res in enumerate(results):
        for (make, args), (shape, per_rules, _) in zip(MESHES, res):
            assert math.prod(shape.values()) == math.prod(args)
            fake = types.SimpleNamespace(shape=shape)
            coord = dict(zip(shape, np.unravel_index(
                r, tuple(shape.values())))) if r < math.prod(
                    shape.values()) else None
            for rules, (tiles, ranks, part, joined) in zip(RULES,
                                                           per_rules):
                jd = jsh.DistContext(mesh=fake, rules=dict(rules))
                assert tiles == jd.spatial_tiles(), (make, args, rules)
                axes = jd.image_spec()[0]
                axes = axes if isinstance(axes, tuple) else (axes,)
                split = [a for a in axes if shape.get(a, 1) > 1]
                n = math.prod(shape[a] for a in split)
                if len(split) > 1:
                    assert ranks == (tuple(split), n)
                else:
                    assert ranks == ((split[0], n) if split else (None, 1))
                i = 0
                for a in split:
                    i = i * shape[a] + int(coord[a])
                rows = 8 // n
                assert part == [2.0 * k for k in range(i * rows,
                                                       (i + 1) * rows)]
                assert joined
    assert results[0][0][0] == {"data": 1, "sp_h": 2, "sp_w": 2}
    assert results[0][2][0] == {"data": 2, "sp_h": 2, "sp_w": 1}
    assert results[0][5][0] == {"data": 4, "model": 1}


def test_split_batch_gives_each_rank_its_rows():
    """``split_batch`` hands each rank its rows of the batch along 'data'
    (the rank's coordinate on that axis picks them), ``join_batch`` joins
    every rank's rows back in order; a batch the extent does not divide
    stays whole on every rank."""
    results = run_spmd(_mesh_rank, 4, device="cpu", timeout=120)
    for r, res in enumerate(results):
        for (make, args), (shape, _, rows) in zip(MESHES, res):
            n = shape.get("data", 1)
            (part8, ok8), (part3, ok3) = rows
            coord = r // (math.prod(shape.values()) // n) if n > 1 else 0
            want = [100 * 8 + 2.0 * i for i in range(8)]
            assert part8 == want[coord * 8 // n:(coord + 1) * 8 // n], \
                (make, args, r)
            assert part3 == [100 * 3 + 2.0 * i for i in range(3)]
            assert ok8 and ok3


def test_launcher_reports_a_failing_rank():
    """A rank that raises stops the launch; its traceback comes back (with
    its peer's, whose barrier the failure broke)."""
    with pytest.raises(RuntimeError, match="of 2 failed") as e:
        run_spmd(_failing_rank, 2, device="cpu", timeout=120)
    assert "KeyError: 'planted failure on rank 1'" in str(e.value)


def test_distcontext_fields_match_jax():
    assert [f.name for f in dataclasses.fields(tsh.DistContext)] == \
        [f.name for f in dataclasses.fields(jsh.DistContext)]
