"""``launch/specs.py`` and the decode cache's specs against the JAX
package's, with no processes, for every architecture of the registry at
its published config: ``cache_specs_only`` (JAX's stacked stage specs
unstacked, a dict a layer) and its resolution under ``make_dist``'s
decode rules on a duck-typed (2, 2) mesh at ``decode_32k`` and
``long_500k``; ``batch_specs``, ``cache_specs``, ``decode_specs`` and
``param_specs``' shapes, dtypes and logical specs (JAX's
``ShapeDtypeStruct``s against the port's meta tensors); ``SRC_FRAMES``;
``param_specs`` and ``cache_specs`` allocating nothing (every leaf on
the meta device: deepseek-v3-671b's 1.3 TB of bf16 params included)."""
import jax
import numpy as np
import pytest

from repro.configs import registry as jreg
from repro.configs.base import SHAPES as JSHAPES
from repro.launch import specs as jspecs
from repro.launch import steps as jsteps
from repro.models import transformer as jtfm
from repro_torch.configs import registry as treg
from repro_torch.configs.base import SHAPES
from repro_torch.launch import specs as tspecs
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as tfm
from repro_torch.train.tree import tree_leaves

DECODE = ("decode_32k", "long_500k")


class FakeMesh:
    """JAX's duck-typed mesh: enough for ``make_dist``'s rule logic."""

    def __init__(self, shape):
        self._shape = dict(shape)
        self.axis_names = tuple(self._shape)

    @property
    def shape(self):
        return self._shape


MESH = (("data", 2), ("model", 2))


def _unstack(cfg, stages):
    """JAX's stage trees (cache specs, or ShapeDtypeStructs with the
    stack dim first) as one dict a layer in execution order, the stack
    dim taken off."""
    out = []
    for (kinds, reps), st in zip(cfg.stages, stages):
        for _ in range(reps):
            for i in range(len(kinds)):
                out.append({k: (tuple(v)[1:] if isinstance(
                    v, jax.sharding.PartitionSpec)
                    else (tuple(v.shape[1:]), str(v.dtype)))
                            for k, v in st[f"l{i}"].items()})
    return out


def _meta(t):
    return tuple(t.shape), str(t.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_cache_specs_match_jax(arch):
    """``cache_specs_only`` equals JAX's, layer by layer, and resolves to
    JAX's mesh specs under each package's own ``make_dist`` decode
    rules; ``cache_specs``' meta shapes and dtypes are JAX's."""
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    want = _unstack(jcfg, jtfm.cache_specs_only(jcfg))
    got = tfm.cache_specs_only(tcfg)
    assert [{k: tuple(v) for k, v in layer.items()} for layer in got] == want
    for name in DECODE:
        jd = jsteps.make_dist(FakeMesh(MESH), jcfg, JSHAPES[name])
        td = tsteps.make_dist(FakeMesh(MESH), tcfg, SHAPES[name])
        assert td.rules == jd.rules, name
        assert [{k: tuple(td.resolve(v)) for k, v in layer.items()}
                for layer in got] == _unstack(jcfg, _resolved(jcfg, jd)), name
        j_sds, j_specs = jspecs.cache_specs(jcfg, JSHAPES[name])
        t_sds, t_specs = tspecs.cache_specs(tcfg, SHAPES[name])
        assert [{k: _meta(v) for k, v in layer.items()} for layer in t_sds] \
            == [{k: (tuple(s), d) for k, (s, d) in layer.items()}
                for layer in _unstack(jcfg, j_sds)], name
        assert [{k: tuple(v) for k, v in layer.items()} for layer in t_specs] \
            == want
        assert all(t.device.type == "meta" for layer in t_sds
                   for t in layer.values())


def _resolved(cfg, dist):
    """JAX's cache spec stages, each spec resolved on ``dist``."""
    return [jax.tree.map(lambda s: dist.resolve(s), st,
                         is_leaf=lambda x: isinstance(
                             x, jax.sharding.PartitionSpec))
            for st in jtfm.cache_specs_only(cfg)]


@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_batch_and_decode_specs_match_jax(arch):
    """``batch_specs`` at every shape and ``decode_specs`` at the decode
    shapes: the same keys, shapes, dtypes and logical specs as JAX's."""
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    assert tspecs.SRC_FRAMES == jspecs.SRC_FRAMES
    for name in SHAPES:
        j_sds, j_shard = jspecs.batch_specs(jcfg, JSHAPES[name])
        t_sds, t_shard = tspecs.batch_specs(tcfg, SHAPES[name])
        assert {k: _meta(v) for k, v in t_sds.items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in j_sds.items()}
        assert {k: tuple(v) for k, v in t_shard.items()} == \
            {k: tuple(v) for k, v in j_shard.items()}
    for name in DECODE:
        jt, jts, jm, jms = jspecs.decode_specs(jcfg, JSHAPES[name])
        tt, tts, tm, tms = tspecs.decode_specs(tcfg, SHAPES[name])
        assert _meta(tt) == (tuple(jt.shape), str(jt.dtype))
        assert tuple(tts) == tuple(jts)
        if jm is None:
            assert tm is None and tms is None
        else:
            assert _meta(tm) == (tuple(jm.shape), str(jm.dtype))
            assert tuple(tms) == tuple(jms)


def _jax_leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))


@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_param_specs_match_jax_and_allocate_nothing(arch):
    """``param_specs``: every leaf a meta tensor (no storage), the leaf
    count, the total size, the dtypes' sizes and the set of logical
    specs equal to JAX's ``param_specs`` (whose stages stack the
    layers)."""
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    j_sds, j_specs = jspecs.param_specs(jcfg)
    t_sds, t_specs = tspecs.param_specs(tcfg)
    leaves = tree_leaves(t_sds)
    assert all(t.device.type == "meta" for t in leaves)
    assert sum(t.numel() for t in leaves) == sum(
        int(np.prod(s.shape)) for s in jax.tree.leaves(j_sds))
    assert sum(t.numel() * t.element_size() for t in leaves) == sum(
        int(np.prod(s.shape)) * s.dtype.itemsize
        for s in jax.tree.leaves(j_sds))
    spec_set = {tuple(s) for s in _flat_specs(t_specs)}
    # JAX's stacked specs carry the stack's leading None
    assert spec_set == {tuple(s)[1:] if k else tuple(s)
                        for k, s in _jax_spec_items(j_specs)}


def _flat_specs(tree):
    if isinstance(tree, dict):
        return [s for v in tree.values() for s in _flat_specs(v)]
    if isinstance(tree, list):
        return [s for v in tree for s in _flat_specs(v)]
    return [tree]


def _jax_spec_items(specs):
    """(stacked, spec) of every leaf of JAX's param spec tree."""
    out = []
    for key, tree in specs.items():
        stacked = key in ("stages", "enc_stages")
        out += [(stacked, s) for s in _jax_leaves(tree)]
    return out
