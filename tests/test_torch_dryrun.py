"""``launch.dryrun`` and ``launch.report`` against the JAX package's
dry-run, with no card and no compile:

- ``make_dist``'s rules, and a rank's param and decode-cache bytes, equal
  JAX's (its rules, and ``NamedSharding.shard_shape`` under its
  ``shard_params`` rule) on a (2, 4) mesh for every architecture's reduced
  config; JAX's side comes from one subprocess with 8 forced host devices
  that traces shapes only (``eval_shape``);
- ``count_cell`` of a reduced llama3.2-1b (head dim 32, kernel F's
  least) on the 16x16 fake world, train, prefill and decode;
- the port's ``CONVPLANE_SITES`` and ``DEFAULT_DEV_TILES`` equal JAX's,
  and ``count_convplane``'s halo geometry equals JAX's ``spatial_plan``
  at the three sites;
- the CLI writes one record (and a skip) into a temporary results
  directory, and ``report`` renders them.

The full sweep runs from the CLI, not here."""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch.distributed as tdist

from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch import hlo_analysis as ha
from repro_torch.launch import report
from repro_torch.launch.mesh import make_host_mesh, one_rank_world_end
from repro_torch.launch.steps import make_dist

MESH = (2, 4)
DECODE = ShapeConfig("d", "decode", 64, 4)
TRAIN = ShapeConfig("t", "train", 32, 8)

JAX_SIDE = r"""
import json, sys
import jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import registry
from repro.configs.base import ShapeConfig
from repro.launch import specs, steps
from repro.launch.mesh import make_host_mesh

conf = json.loads(sys.argv[1])
mesh = make_host_mesh(data=conf["mesh"][0], model=conf["mesh"][1])

def shard_bytes(dist, sds, logical):
    # JAX's shard_params rule: a dim its axes do not divide stays whole
    total = 0
    leaves = jax.tree.leaves(sds)
    specs_ = jax.tree.leaves(logical, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(specs_)
    for s, sp in zip(leaves, specs_):
        res = tuple(dist.resolve(sp))
        res += (None,) * (len(s.shape) - len(res))
        axes = []
        for dim, ax in zip(s.shape, res):
            names = ax if isinstance(ax, tuple) else (ax,)
            n = int(np.prod([mesh.shape[a] for a in names])) if ax else 1
            axes.append(ax if ax is not None and dim % n == 0 else None)
        shp = NamedSharding(mesh, P(*axes)).shard_shape(s.shape)
        total += int(np.prod(shp)) * np.dtype(s.dtype).itemsize
    return total

out = {"cells": {}}
for arch in conf["archs"]:
    cfg = registry.get_reduced(arch)
    rec = {}
    for name, (kind, s, b) in conf["shapes"].items():
        dist = steps.make_dist(mesh, cfg, ShapeConfig(name, kind, s, b))
        rec[name] = {k: (list(v) if isinstance(v, tuple) else v)
                     for k, v in dist.rules.items()}
        if kind == "decode":
            rec["param_bytes"] = shard_bytes(dist, *specs.param_specs(cfg))
            rec["cache_bytes"] = shard_bytes(
                dist, *specs.cache_specs(cfg, ShapeConfig(name, kind, s, b)))
    out["cells"][arch] = rec

# import after the mesh: the module sets XLA_FLAGS for its own 512 devices
from repro.core import spatial
from repro.launch import dryrun as jdry
out["sites"] = {k: {f: (json.loads(json.dumps(v)) if not isinstance(v, str)
                        else v) for f, v in g.items()}
                for k, g in jdry.CONVPLANE_SITES.items()}
out["tiles"] = [list(t) for t in jdry.DEFAULT_DEV_TILES]
out["halo"] = {}
for site in jdry.CONVPLANE_SITES:
    for t in jdry.DEFAULT_DEV_TILES:
        sp = spatial.spatial_plan(jdry.convplane_spec(site, t))
        out["halo"][f"{site}/{t[0]}x{t[1]}"] = None if sp is None else [
            {"block": d.block, "tin": d.tin, "halo_lo": d.halo_lo,
             "halo_hi": d.halo_hi, "pad_to": d.pad_to} for d in sp.dims]
json.dump(out, sys.stdout)
"""


def _cfg(arch):
    cfg = registry.get_reduced(arch)
    return dataclasses.replace(cfg, head_dim=max(cfg.head_dim, 32))


@pytest.fixture(autouse=True)
def _no_world():
    one_rank_world_end()
    yield
    assert not tdist.is_initialized()


@pytest.fixture(scope="module")
def jax_side():
    conf = {"mesh": MESH, "archs": list(registry.ARCH_IDS),
            "shapes": {"decode": ["decode", DECODE.seq_len,
                                  DECODE.global_batch],
                       "train": ["train", TRAIN.seq_len,
                                 TRAIN.global_batch]}}
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..",
                                       "src"))
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(JAX_SIDE),
                        json.dumps(conf)], env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout)


def _rules(dist):
    return {k: (list(v) if isinstance(v, tuple) else v)
            for k, v in dist.rules.items()}


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_rules_and_rank_bytes_equal_jax(jax_side, arch):
    want = jax_side["cells"][arch]
    cfg = registry.get_reduced(arch)
    with ha.fake_world(MESH[0] * MESH[1]):
        mesh = make_host_mesh(*MESH)
        assert _rules(make_dist(mesh, cfg, TRAIN)) == want["train"]
        dist = make_dist(mesh, cfg, DECODE)
        assert _rules(dist) == want["decode"]
        _, _, mem, _ = dryrun.rank_inputs(cfg, DECODE, dist)
    assert mem["param_bytes"] == want["param_bytes"]
    assert mem["cache_bytes"] == want["cache_bytes"]


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_count_cell_on_the_16x16_fake_world(monkeypatch, shape):
    monkeypatch.setattr(registry, "get_config", _cfg)
    rec = dryrun.count_cell("llama3.2-1b", shape, False)
    cfg = _cfg("llama3.2-1b")
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["chips"]) == (
        "llama3.2-1b", shape, "16x16", 256)
    assert rec["layouts"] == len(dryrun.candidate_ranks(
        cfg, SHAPES[shape], False)) >= 1
    m = rec["memory"]
    assert m["param_bytes"] > 0 and m["peak_activation_bytes"] > 0
    assert rec["bytes_per_chip"] >= sum(m.values())
    r = rec["roofline"]
    assert r["chips"] == 256 and r["dominant"] in ("compute", "memory",
                                                   "collective")
    assert r["hlo_flops_per_chip"] == rec["product_flops"] + sum(
        k["flops"] for k in rec["kernels"].values())
    layers = len(dryrun.tfm.layer_kinds(cfg))
    if shape == "train_4k":
        # each microbatch's forward and its remat'd recompute
        assert rec["kernels"]["F"]["launches"] == 2 * layers \
            * rec["grad_accum"]
        assert m["opt_state_bytes"] > 0 and rec["optimizer"] == "adamw"
    elif shape == "prefill_32k":
        assert rec["kernels"]["F"]["launches"] == layers
        assert rec["collectives"]["num_ops"] > 0
    else:
        assert "F" not in rec["kernels"] and m["cache_bytes"] > 0


def test_convplane_sites_and_halos_equal_jax(jax_side):
    assert [list(t) for t in dryrun.DEFAULT_DEV_TILES] == jax_side["tiles"]
    assert json.loads(json.dumps(dryrun.CONVPLANE_SITES)) == \
        jax_side["sites"]
    for site in dryrun.CONVPLANE_SITES:
        for t in dryrun.DEFAULT_DEV_TILES:
            want = jax_side["halo"][f"{site}/{t[0]}x{t[1]}"]
            if t not in ((2, 1), (2, 2)):
                continue          # two tilings a site keep the test short
            rec = dryrun.count_convplane(site, t)
            if want is None:
                assert "skipped" in rec
                continue
            assert [rec["halo"]["h"], rec["halo"]["w"]] == want
            assert rec["devices"] == t[0] * t[1]
            assert rec["route"] == "cuda"
            assert rec["kernels"], rec
            sends = rec["collectives"]["per_kind"].get(
                "collective-permute", 0)
            assert (sends > 0) == (max(t) > 1)


def test_cli_record_and_report(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(registry, "get_config", _cfg)
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    dryrun.main(["--arch", "llama3.2-1b", "--shape", "decode_32k",
                 "--mesh", "single"])
    dryrun.main(["--arch", "llama3.2-1b", "--shape", "long_500k",
                 "--mesh", "single"])
    ok = tmp_path / "llama3.2-1b__decode_32k__single.json"
    skip = tmp_path / "llama3.2-1b__long_500k__single.json"
    assert ok.exists() and skip.exists()
    assert "skipped" in json.loads(skip.read_text())
    rec = json.loads(ok.read_text())
    dryrun.main(["--arch", "llama3.2-1b", "--shape", "decode_32k",
                 "--mesh", "single"])                 # cached, kept
    assert json.loads(ok.read_text()) == rec
    capsys.readouterr()
    report.main(str(tmp_path))
    text = capsys.readouterr().out
    assert "cells counted: 1; skipped (documented): 1; errors: 0" in text
    row = [line for line in text.splitlines()
           if line.startswith("| llama3.2-1b | decode_32k |")]
    assert len(row) == 3          # the summary and the single-pod roofline
    assert f"**{rec['roofline']['dominant']}**" in row[1]
    assert "MISSING" in text      # the cells not run
