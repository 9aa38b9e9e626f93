"""The port's mesh rules and spec trees against the JAX package's, with no
processes: ``make_dist``'s rules for every architecture of the registry
and every shape of ``SHAPES`` on JAX's duck-typed 16x16 mesh and on (2, 2)
and (1, 4) meshes, ``auto`` and ``dp_only``; ``resolve``,
``SUPERPACK_SPEC``, ``image_spec``, ``plane_spec`` and ``act_spec``;
every model's logical spec tree (the transformer's for every
architecture at its published config, JAX's stacked specs with the
leading None taken off; the four image models'); ``shard_params``' blocks
against the numpy slice a mesh coordinate selects, its replicate-with-one-
warning rule, ``QuantizedSuperpack`` scales and the ``TPSuperpack`` it
makes of a superpack split on its out-channels."""
import dataclasses
import itertools
import warnings

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import sharding as jsh
from repro.configs import registry as jreg
from repro.configs.base import SHAPES as JSHAPES
from repro.launch import steps as jsteps
from repro.models import gan as jgan
from repro.models import segnet as jsegnet
from repro.models import transformer as jtfm
from repro.models import unet as junet
from repro.models import vae as jvae
from repro_torch import sharding as tsh
from repro_torch.configs import registry as treg
from repro_torch.configs.base import SHAPES
from repro_torch.core.plan import QuantizedSuperpack, TPSuperpack
from repro_torch.launch import steps as tsteps
from repro_torch.models import gan, segnet, unet, vae
from repro_torch.models import transformer as tfm


class FakeMesh:
    """JAX's duck-typed mesh (``axis_names``, ``shape`` mapping): enough
    for ``make_dist``'s rule logic."""

    def __init__(self, shape):
        self._shape = dict(shape)
        self.axis_names = tuple(self._shape)

    @property
    def shape(self):
        return self._shape


class PortMesh:
    """What the port's ``DistContext`` reads of a ``DeviceMesh``: axis
    names, extents in axis order, this rank's coordinate and a stand-in
    group per axis."""

    def __init__(self, shape, coord):
        self.mesh_dim_names = tuple(a for a, _ in shape)
        self.shape = tuple(n for _, n in shape)
        self.coord = list(coord)

    def get_coordinate(self):
        return self.coord

    def get_group(self, axis):
        return f"group:{axis}"


MESHES = [(("data", 16), ("model", 16)), (("data", 2), ("model", 2)),
          (("data", 1), ("model", 4))]


@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_make_dist_rules_match_jax(arch):
    """Every shape, mesh and parallelism: the port's rules equal JAX's."""
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    for (name, shape), mesh, par in itertools.product(
            SHAPES.items(), MESHES, ("auto", "dp_only")):
        want = jsteps.make_dist(FakeMesh(mesh), jcfg, JSHAPES[name],
                                parallelism=par).rules
        got = tsteps.make_dist(FakeMesh(mesh), tcfg, shape,
                               parallelism=par).rules
        assert got == want, (arch, name, mesh, par)
        assert tsteps.dp_total(FakeMesh(mesh)) == \
            jsteps.dp_total(FakeMesh(mesh))


def test_resolve_and_activation_specs_match_jax():
    for rules in (dict(jsh.DEFAULT_RULES),
                  dict(jsh.DEFAULT_RULES, conv_taps="model", conv_out=None),
                  dict(jsh.DEFAULT_RULES, batch=("data", "model"),
                       seq="model")):
        jd = jsh.DistContext(mesh=None, rules=dict(rules))
        td = tsh.DistContext(mesh=None, rules=dict(rules))
        for spec in (jsh.SUPERPACK_SPEC, jsh.PLANE_SPEC, P(None, "heads"),
                     P("vocab", None), P("expert", None, "expert_ffn"),
                     P("batch", "model")):
            assert tuple(td.resolve(tsh.Spec(*spec))) == \
                tuple(jd.resolve(spec))
        assert tuple(td.image_spec()) == tuple(jd.image_spec())
        assert tuple(td.plane_spec()) == tuple(jd.plane_spec())
        for seq in (True, False):
            assert tuple(td.act_spec(seq_dim=seq)) == \
                tuple(jd.act_spec(seq_dim=seq))
    assert tuple(tsh.SUPERPACK_SPEC) == tuple(jsh.SUPERPACK_SPEC)
    assert tuple(tsh.PLANE_SPEC) == tuple(jsh.PLANE_SPEC)
    assert tsh.single_device_dist() is None and jsh.single_device_dist() \
        is None
    stacked = tsh.stack_specs({"a": tsh.Spec("heads", None)}, 2)
    assert tuple(stacked["a"]) == (None, None, "heads", None)


def _tuple_tree(tree):
    """A spec tree with every leaf a plain tuple (JAX's ``P`` or the
    port's ``Spec``)."""
    if isinstance(tree, dict):
        return {k: _tuple_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tuple_tree(v) for v in tree]
    return tuple(tree)


def _jax_init_specs(cfg):
    """JAX's ``init`` spec tree, traced only (no arrays allocated)."""
    cell = {}

    def f(k):
        p, s = jtfm.init(k, cfg)
        cell["s"] = s
        return p

    jax.eval_shape(f, jax.random.PRNGKey(0))
    return cell["s"]


def _unstack(stage_defs, stages):
    """JAX's stacked stage specs as one spec dict a layer, the leading
    None taken off, in the port's execution order."""
    out = []
    for (kinds, reps), stage in zip(stage_defs, stages):
        for _ in range(reps):
            for i in range(len(kinds)):
                out.append(jax.tree.map(
                    lambda sp: P(*tuple(sp)[1:]), stage[f"l{i}"],
                    is_leaf=lambda x: isinstance(x, P)))
    return out


@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_transformer_spec_tree_matches_jax(arch):
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    js = _jax_init_specs(jcfg)
    want = {k: v for k, v in js.items()
            if k not in ("stages", "enc_stages")}
    want["layers"] = _unstack(jcfg.stages, js["stages"])
    if "enc_stages" in js:
        want["enc_layers"] = _unstack(jcfg.encoder_stages, js["enc_stages"])
    got = tfm.specs(tcfg)
    assert _tuple_tree(got) == _tuple_tree(want)
    for i, kinds in enumerate(jcfg.stages):
        got_b = tfm.block_specs(kinds[0], tcfg)
        want_b = jtfm.block_specs(kinds[0], jcfg)
        assert _tuple_tree(got_b) == _tuple_tree(want_b), (arch, i)


def _jax_specs(init, *args, **kw):
    cell = {}

    def f(k):
        p, s = init(k, *args, **kw)
        cell["s"] = s
        return p

    jax.eval_shape(f, jax.random.PRNGKey(0))
    return cell["s"]


IMAGE_SPECS = {
    "generator": (lambda: gan.generator_specs(gan.CGAN),
                  lambda: _jax_specs(jgan.generator_init, jgan.CGAN)),
    "discriminator": (lambda: gan.discriminator_specs(gan.DCGAN),
                      lambda: _jax_specs(jgan.discriminator_init,
                                         jgan.DCGAN)),
    "segnet": (lambda: segnet.segnet_specs(segnet.SEGNET),
               lambda: _jax_specs(jsegnet.segnet_init, jsegnet.SEGNET)),
    "vae": (lambda: vae.vae_specs(vae.VAE),
            lambda: _jax_specs(jvae.vae_init, jvae.VAE)),
    "unet": (lambda: unet.unet_specs(unet.UNET_TINY),
             lambda: _jax_specs(junet.unet_init, junet.UNET_TINY)),
}


@pytest.mark.parametrize("model", list(IMAGE_SPECS))
def test_image_model_spec_trees_match_jax(model):
    port, jax_ = IMAGE_SPECS[model]
    assert _tuple_tree(port()) == _tuple_tree(jax_())


def _want_block(arr, spec, mesh, coord):
    """The numpy slice JAX's ``NamedSharding`` gives the device at
    ``coord`` (axes of one dim major to minor), a dim its axes do not
    divide whole."""
    sizes = dict(mesh)
    c = dict(zip(sizes, coord))
    idx = []
    for d, ax in enumerate(tuple(spec) + (None,) * (arr.ndim - len(spec))):
        axes = () if ax is None else (ax if isinstance(ax, tuple) else (ax,))
        n = int(np.prod([sizes[a] for a in axes])) if axes else 1
        if n == 1 or arr.shape[d] % n:
            idx.append(slice(None))
            continue
        i = 0
        for a in axes:
            i = i * sizes[a] + c[a]
        size = arr.shape[d] // n
        idx.append(slice(i * size, (i + 1) * size))
    return arr[tuple(idx)]


SHARD_MESH = (("data", 2), ("model", 2))


@pytest.mark.parametrize("coord", list(itertools.product(range(2),
                                                         range(2))))
def test_shard_params_blocks_are_the_mesh_slice(coord):
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((8, 6)).astype(np.float32),
            "b": rng.standard_normal((4, 10, 3)).astype(np.float32),
            "c": rng.standard_normal((12,)).astype(np.float32),
            "e": rng.standard_normal((8, 4, 6)).astype(np.float32)}
    specs = {"a": tsh.Spec("vocab", "heads"),
             "b": tsh.Spec(None, ("data", "model")),
             "c": tsh.Spec(("data", "model")),
             "e": tsh.Spec("expert", None, None)}
    rules = dict(tsh.DEFAULT_RULES, expert=("data", "model"))
    d = tsh.DistContext(PortMesh(SHARD_MESH, coord), rules=rules)
    got = d.shard_params({k: torch.from_numpy(v) for k, v in tree.items()},
                         specs)
    places = d.param_shardings(specs)
    for k, arr in tree.items():
        want = _want_block(arr, d.resolve(specs[k]), SHARD_MESH, coord)
        np.testing.assert_array_equal(got[k].numpy(), want)
        np.testing.assert_array_equal(
            places[k].block(torch.from_numpy(arr)).numpy(), want)


def test_shard_params_replicates_with_one_warning():
    """A dim its axis does not divide stays whole, warned once per
    (param, dim, axis) however often the tree is placed, as JAX's."""
    tsh._REPLICATION_WARNED.clear()
    d = tsh.DistContext(PortMesh(SHARD_MESH, (1, 1)))
    p = {"w": torch.arange(30.0).reshape(3, 10), "v": torch.arange(6.0)}
    sp = {"w": tsh.Spec("heads", "heads"), "v": tsh.Spec("heads")}
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        for _ in range(3):
            out = d.shard_params(p, sp)
    msgs = [str(w.message) for w in rec
            if issubclass(w.category, RuntimeWarning)]
    assert len(msgs) == 1 and "['w'] dim 0 (size 3)" in msgs[0]
    np.testing.assert_array_equal(out["w"].numpy(),
                                  p["w"].numpy()[:, 5:])
    np.testing.assert_array_equal(out["v"].numpy(), p["v"].numpy()[3:])


@pytest.mark.parametrize("coord", [(0, 1), (1, 0)])
def test_shard_params_superpacks(coord):
    """A superpack split on its out-channels becomes a ``TPSuperpack`` of
    the rank's columns (codes and the whole rows' scales for int8); an
    out-channel count the axis does not divide stays a whole superpack."""
    d = tsh.DistContext(PortMesh(SHARD_MESH, coord))
    rng = np.random.default_rng(1)
    dense = rng.standard_normal((12, 8)).astype(np.float32)
    q = rng.integers(-127, 128, (12, 8)).astype(np.int8)
    scale = rng.uniform(0.1, 1.0, (12, 1)).astype(np.float32)
    thin = rng.standard_normal((12, 3)).astype(np.float32)
    p = {"w0": torch.from_numpy(dense),
         "w1": QuantizedSuperpack(torch.from_numpy(q),
                                  torch.from_numpy(scale)),
         "w2": torch.from_numpy(thin)}
    sp = {k: tsh.SUPERPACK_SPEC for k in p}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        out = d.shard_params(p, sp)
    m = coord[1]
    assert isinstance(out["w0"], TPSuperpack) and out["w0"].index == m \
        and out["w0"].n == 2 and out["w0"].group == "group:model"
    np.testing.assert_array_equal(out["w0"].block.numpy(),
                                  dense[:, 4 * m:4 * m + 4])
    assert out["w0"].shape == (12, 8)
    blk = out["w1"].block
    assert isinstance(blk, QuantizedSuperpack)
    np.testing.assert_array_equal(blk.q.numpy(), q[:, 4 * m:4 * m + 4])
    np.testing.assert_array_equal(blk.scale.numpy(), scale)
    assert isinstance(out["w2"], torch.Tensor)
    np.testing.assert_array_equal(out["w2"].numpy(), thin)


def test_multi_axis_batch_index():
    """A batch over ('data', 'model') splits major to minor: rank (d, m)
    of a (2, 2) mesh holds block 2·d + m, as JAX's ``P(('data',
    'model'))``."""
    rules = dict(tsh.DEFAULT_RULES, batch=("data", "model"))
    for coord in itertools.product(range(2), range(2)):
        d = tsh.DistContext(PortMesh(SHARD_MESH, coord), rules=rules)
        assert d.batch_ranks() == (("data", "model"), 4)
        assert d.shard_of(("data", "model"), 8) == (2 * coord[0] + coord[1],
                                                    4)
        assert d.shard_of(("data", "model"), 6) == (0, 1)
    d = tsh.DistContext(PortMesh(SHARD_MESH, (1, 0)))
    x = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="not the block"):
        d.constrain(x, tsh.Spec("batch", "heads"), (8, 8))
    assert d.constrain(x, tsh.Spec("batch", "heads"), (8, 6)) is x
    assert dataclasses.fields(d)[0].name == "mesh"


@pytest.mark.parametrize("arch,kind", [("recurrentgemma-2b", "rec"),
                                       ("mamba2-130m", "ssd"),
                                       ("seamless-m4t-large-v2", "dec")])
def test_unsharded_kinds_refuse_a_mesh_that_splits_them(arch, kind):
    """No kind refuses a mesh whose rules split its weights over 'heads':
    ``ssd`` runs tensor-parallel there (its in-projection's columns
    gathered, ``layers.ssm``), as ``rec`` and ``dec`` do, its mixer's
    block the mesh's slice; under ``dp_only`` rules (nothing split) the
    mixer's weights stay whole."""
    cfg = treg.get_config(arch)
    d = tsh.DistContext(PortMesh(SHARD_MESH, (0, 1)))
    dp = tsh.DistContext(PortMesh(SHARD_MESH, (0, 1)), rules=dict(
        tsh.DEFAULT_RULES, heads=None, ffn=None, vocab=None,
        batch=("data", "model")))
    i = tfm.layer_kinds(cfg).index(kind)
    leaf, spec = tfm.param_shapes(cfg)["layers"][i], \
        tfm.layer_specs(kind, cfg)
    for key in {"ssd": ("ssd", "in"), "rec": ("rec", "in_x"),
                "dec": ("cross", "q", "w")}[kind]:
        leaf, spec = leaf[key], spec[key]
    whole = tuple(leaf.shape)
    assert d.block_shape(whole, spec) == (whole[0], whole[1] // 2)
    assert dp.block_shape(whole, spec) == whole


def test_row_parallel_and_two_way_superpack_blocks():
    """A superpack split on its rows ('conv_taps' over 'model') becomes a
    ``RowSuperpack`` of the rank's rows (its int8 codes' scale rows with
    them); one split on both its rows and its out-channels a
    ``TPSuperpack`` of a ``RowSuperpack``: the rank's row block of its
    column block, both groups, the scale rows following the rows only,
    and the split axes that carry the batch named."""
    from repro_torch.core.plan import QuantizedSuperpack, RowSuperpack
    d = tsh.DistContext(PortMesh(SHARD_MESH, (0, 1)), rules=dict(
        tsh.DEFAULT_RULES, conv_taps="model", conv_out=None))
    w = torch.arange(32.0).reshape(8, 4)
    q = QuantizedSuperpack(torch.ones((8, 4), dtype=torch.int8),
                           torch.arange(8.0).reshape(8, 1))
    out = d.shard_params({"w": w, "q": q}, {"w": tsh.SUPERPACK_SPEC,
                                            "q": tsh.SUPERPACK_SPEC})
    assert isinstance(out["w"], RowSuperpack) and out["w"].rows == (4, 8)
    assert torch.equal(out["w"].block, w[4:]) and out["w"].total == 8
    assert torch.equal(out["q"].block.scale, q.scale[4:])
    assert out["w"].axes == (("model", "group:model"),)
    assert out["w"].batch == frozenset()
    both = tsh.DistContext(PortMesh(SHARD_MESH, (0, 1)), rules=dict(
        tsh.DEFAULT_RULES, conv_taps="data", conv_out="model"))
    out = both.shard_params({"w": w, "q": q}, {"w": tsh.SUPERPACK_SPEC,
                                               "q": tsh.SUPERPACK_SPEC})
    tp = out["w"]
    assert isinstance(tp, TPSuperpack) and (tp.index, tp.n) == (1, 2)
    assert tp.group == "group:model" and tp.batch == frozenset()
    rows = tp.block
    assert isinstance(rows, RowSuperpack) and rows.rows == (0, 4)
    assert rows.group == "group:data" and rows.batch == {"data"}
    assert torch.equal(rows.block, w[:4, 2:]) and tp.shape == (8, 4)
    qb = out["q"].block.block
    assert torch.equal(qb.q, q.q[:4, 2:])
    assert torch.equal(qb.scale, q.scale[:4])
