"""The port's ``launch.roofline`` against the JAX package's, in one
process with no devices: the model FLOPs of every architecture at every
shape of ``SHAPES`` (published and reduced configs), the ring factors of
every collective kind, the ``Roofline`` record under the port's
constants, the H100 peaks, and ``collective_bytes`` over what
``core.comm`` records."""
import itertools

import pytest

from repro.configs import registry as jreg
from repro.configs.base import SHAPES as JSHAPES
from repro.launch import roofline as jrl
from repro_torch.configs import registry as treg
from repro_torch.configs.base import SHAPES
from repro_torch.launch import roofline as rl

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")


@pytest.mark.parametrize("arch,shape,reduced", [
    (a, s, r) for a in treg.ARCH_IDS for s in SHAPES for r in (False, True)])
def test_model_flops_equal_jax(arch, shape, reduced):
    get_t = treg.get_reduced if reduced else treg.get_config
    get_j = jreg.get_reduced if reduced else jreg.get_config
    cfg, jcfg = get_t(arch), get_j(arch)
    assert rl.active_param_count(cfg) == jrl.active_param_count(jcfg)
    assert rl.model_flops_for(cfg, SHAPES[shape]) == \
        jrl.model_flops_for(jcfg, JSHAPES[shape])


@pytest.mark.parametrize("kind,n", list(itertools.product(KINDS,
                                                           (1, 2, 16))))
def test_ring_factors_equal_jax(kind, n):
    for size in (0, 1, 4096, 3 * 2 ** 20 + 7):
        assert rl._traffic(kind, size, n) == jrl._traffic(kind, size, n)


def test_roofline_equals_jax_under_port_constants(monkeypatch):
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(jrl, name, getattr(rl, name))
    for cost, coll, chips, mf in (
            ({"flops": 3.1e14, "bytes accessed": 2.2e11}, {"total": 4e9},
             256, 5e16),
            ({"flops": 1e9, "bytes accessed": 8e12}, {"total": 0.0}, 512,
             2e11),
            ({"flops": 0.0, "bytes accessed": 0.0}, {"total": 9e12}, 256,
             0.0)):
        want = jrl.roofline_from(cost, coll, chips, mf)
        got = rl.roofline_from(cost, coll, chips, mf)
        assert got.to_dict() == want.to_dict()
        assert got.step_time_s == want.step_time_s


def test_h100_peaks():
    assert (rl.PEAK_FLOPS, rl.PEAK_FLOPS_F32, rl.HBM_BW) == \
        (989e12, 67e12, 3.35e12)
    assert rl.card_peaks("NVIDIA H100 80GB HBM3") == (67e12, 3.35e12, 989e12)
    assert rl.card_peaks("NVIDIA H100 PCIe") == (51e12, 2.0e12, 756e12)
    assert rl.card_peaks("NVIDIA H100 NVL") == (60e12, 3.9e12, 835e12)
    with pytest.raises(RuntimeError):
        rl.card_peaks("NVIDIA A100-SXM4-80GB")


def test_collective_bytes_of_records():
    """``comm.traffic()``'s records under the ring factors: an all-gather
    is read at its output, a reduce-scatter at its output, a halo send as
    one collective-permute; a record with no ``sizes`` is one collective
    over ``default_group`` ranks."""
    recs = {
        "a": {"op": "all_reduce", "calls": 2, "bytes": 800,
              "sizes": {4: 800}},
        "b": {"op": "all_gather", "calls": 1, "bytes": 100,
              "sizes": {4: 400, 2: 200}},
        "c": {"op": "reduce_scatter", "calls": 1, "bytes": 400,
              "sizes": {4: 100}},
        "d": {"op": "send_recv", "calls": 3, "bytes": 90, "sizes": {2: 90}},
        "e": {"op": "all_to_all", "calls": 1, "bytes": 64},
    }
    got = rl.collective_bytes(recs, default_group=8)
    want = {"all-reduce": 2 * 800 * 3 / 4,
            "all-gather": 400 * 3 / 4 + 200 / 2,
            "reduce-scatter": 100 * 3.0,
            "collective-permute": 90.0,
            "all-to-all": 64 * 7 / 8}
    assert got["per_kind"] == pytest.approx(want, rel=1e-15)
    assert got["per_record"] == pytest.approx(
        {"a": 2 * 800 * 3 / 4, "b": 400 * 3 / 4 + 200 / 2, "c": 100 * 3.0,
         "d": 90.0, "e": 64 * 7 / 8}, rel=1e-15)
    assert got["total"] == pytest.approx(sum(want.values()), rel=1e-15)
    assert got["num_ops"] == 8
