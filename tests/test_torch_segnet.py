"""The port's SegNet against the JAX package's, on JAX's weights: plan
geometry for ``SEGNET`` and ``SEGNET_TINY``, ``segnet_apply`` in f32 and
int8 under both plan policies, ``segnet_loss`` and its gradients (the f32
leaves and the int8 scale leaves) against ``jax.value_and_grad``, the int8
model against its f32 twin (rel L∞ ≤ L/127), ``upsample_logits``, and
``python -m repro_torch.serve_segnet`` driven in process."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.plan import QuantizedSuperpack as JQuantized
from repro.models import segnet as jseg
from repro_torch import serve_segnet
from repro_torch.core.plan import QuantizedSuperpack
from repro_torch.models import segnet as tseg

from tests.conftest import TOL_FWD, TOL_GRAD, assert_close


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def configs(base_name, backend, wdtype):
    jbase = {"tiny": jseg.SEGNET_TINY, "full": jseg.SEGNET}[base_name]
    tbase = {"tiny": tseg.SEGNET_TINY, "full": tseg.SEGNET}[base_name]
    return (dataclasses.replace(jbase, wdtype=wdtype),
            dataclasses.replace(tbase, backend=backend, wdtype=wdtype))


@functools.lru_cache(maxsize=None)
def jax_params(base_name, wdtype, seed=0):
    jcfg, _ = configs(base_name, "torch", wdtype)
    p, _ = jseg.segnet_init(jax.random.PRNGKey(seed), jcfg)
    return jax.tree.map(np.asarray, p)


def images(cfg, b=2, seed=1):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (b, cfg.in_hw, cfg.in_hw, cfg.in_c)) \
        .astype(np.float32)


@pytest.mark.parametrize("base_name", ["tiny", "full"])
@pytest.mark.parametrize("wdtype", ["float32", "int8"])
def test_plans_match_jax(base_name, wdtype):
    jcfg, tcfg = configs(base_name, "torch", wdtype)
    assert [vars(l) for l in tcfg.layers] == [vars(l) for l in jcfg.layers]
    assert tcfg.out_hw == jcfg.out_hw
    jplans, tplans = jseg.segnet_plans(jcfg), tseg.segnet_plans(tcfg)
    assert len(tplans) == len(jplans) == 10
    for jp, tp in zip(jplans, tplans):
        assert dataclasses.asdict(tp.spec) == {
            **dataclasses.asdict(jp.spec), "backend": "torch"}
        for field in ("out_hw", "gpad", "total_taps", "sum_uv", "uniform",
                      "bwd_pad", "dx_taps"):
            assert getattr(tp, field) == getattr(jp, field), field
        assert [dataclasses.asdict(ex) for ex in tp.phases] == \
            [dataclasses.asdict(ex) for ex in jp.phases]
        assert [(r.batch, r.path, r.fused_bwd) for r in tp.routes] == \
            [(r.batch, r.path, r.fused_bwd) for r in jp.routes]
    for k, d in ((3, 1), (3, 2), (3, 8), (1, 1)):
        assert tseg.atrous_padding(k, d) == jseg.atrous_padding(k, d)


# the full config runs on 'torch' only: its 'cuda' route on the CPU is the
# same plain version the tiny config's checks
APPLY_CASES = [("tiny", w, b) for w in ("float32", "int8")
               for b in ("torch", "cuda")]
APPLY_CASES += [("full", w, "torch") for w in ("float32", "int8")]


@pytest.mark.parametrize("base_name,wdtype,backend", APPLY_CASES)
def test_segnet_apply_matches_jax_on_its_weights(base_name, wdtype,
                                                 backend):
    jcfg, tcfg = configs(base_name, backend, wdtype)
    np_params = jax_params(base_name, wdtype)
    params = tseg.params_from_jax(np_params, tcfg, device="cpu")
    if wdtype == "int8":
        assert all(isinstance(params[f"w{i}"], QuantizedSuperpack)
                   for i in range(10))
    x = images(tcfg)
    want = np.asarray(jax.jit(functools.partial(jseg.segnet_apply,
                                                cfg=jcfg))(np_params, x))
    got = tseg.segnet_apply(params, torch.from_numpy(x), tcfg)
    assert got.shape == want.shape == (2, tcfg.out_hw, tcfg.out_hw,
                                       tcfg.num_classes)
    assert_close(got.numpy(), want, TOL_FWD)


def _grad_close(got, want):
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               rtol=TOL_GRAD, atol=TOL_GRAD * scale)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("wdtype", ["float32", "int8"])
def test_segnet_loss_and_grads_match_jax(wdtype, backend):
    """``segnet_loss`` and its gradient w.r.t. every trainable leaf: the
    f32 superpacks and biases, or the int8 superpacks' scale columns (the
    codes take none: float0 in JAX) and the biases."""
    jcfg, tcfg = configs("tiny", backend, wdtype)
    np_params = jax_params("tiny", wdtype)
    x = images(tcfg, b=3, seed=4)
    labels = np.random.default_rng(5).integers(
        0, tcfg.num_classes, (3, tcfg.out_hw, tcfg.out_hw)).astype(np.int32)
    loss_j, g_j = jax.jit(jax.value_and_grad(
        lambda p: jseg.segnet_loss(p, x, labels, jcfg),
        allow_int=True))(np_params)
    params = tseg.params_from_jax(np_params, tcfg, device="cpu")
    leaves, named = {}, {}
    for k, v in params.items():
        if isinstance(v, QuantizedSuperpack):
            scale = v.scale.clone().requires_grad_()
            named[k] = QuantizedSuperpack(v.q, scale)
            leaves[k] = scale
        else:
            named[k] = leaves[k] = v.clone().requires_grad_()
    loss = tseg.segnet_loss(named, torch.from_numpy(x),
                            torch.from_numpy(labels), tcfg)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(
        leaves.values()))))
    assert_close(float(loss.detach()), float(loss_j), TOL_FWD)
    for k, g in grads.items():
        want = g_j[k]
        if isinstance(want, JQuantized):
            assert want.q.dtype == jax.dtypes.float0
            want = want.scale
        assert g.shape == want.shape, k
        _grad_close(g.numpy(), want)


def test_int8_segnet_tracks_its_f32_twin():
    """The int8 model within rel L∞ ≤ L/127 of its f32 twin from the same
    seed (``tests/test_quantized.py``'s gate, on the port alone), with int8
    weights at most half the f32 bytes."""
    cfg = dataclasses.replace(tseg.SEGNET_TINY, wdtype="int8")
    twin = dataclasses.replace(cfg, wdtype="float32")
    pq = tseg.segnet_init(0, cfg, device="cpu")
    pf = tseg.segnet_init(0, twin, device="cpu")
    for i in range(10):
        assert isinstance(pq[f"w{i}"], QuantizedSuperpack)
        assert torch.equal(pq[f"w{i}"].q, tseg.segnet_plans(cfg)[i].pack(
            tseg.segnet_unpack(pf, twin)[f"w{i}"]).q)
    x = torch.from_numpy(images(cfg))
    lq = tseg.segnet_apply(pq, x, cfg)
    lf = tseg.segnet_apply(pf, x, twin)
    rel = float((lq - lf).abs().max() / lf.abs().max())
    assert 0 < rel <= len(cfg.layers) / 127.0
    assert serve_segnet.weight_bytes(pq) <= 0.5 * serve_segnet.weight_bytes(
        pf)
    gate = serve_segnet.int8_gate(cfg, pq, "cpu")
    assert gate["rel_err"] <= gate["bound"] == len(cfg.layers) / 127.0


def test_upsample_logits_matches_jax():
    y = np.random.default_rng(2).standard_normal((2, 3, 5, 4)) \
        .astype(np.float32)
    for factor in (1, 4):
        want = np.asarray(jseg.upsample_logits(jnp.asarray(y), factor))
        got = tseg.upsample_logits(torch.from_numpy(y), factor).numpy()
        np.testing.assert_array_equal(got, want)


def test_params_from_jax_checks_shapes_and_unpack_matches_jax():
    jcfg, tcfg = configs("tiny", "torch", "int8")
    np_params = jax_params("tiny", "int8")
    want = jseg.segnet_unpack(np_params, jcfg)
    got = tseg.segnet_unpack(tseg.params_from_jax(np_params, tcfg,
                                                  device="cpu"), tcfg)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    bad = dict(np_params, w3=JQuantized(np_params["w3"].q[:-1],
                                        np_params["w3"].scale[:-1]))
    with pytest.raises(ValueError, match="w3"):
        tseg.params_from_jax(bad, tcfg, device="cpu")
    init = tseg.segnet_init(3, tcfg, device="cpu")
    assert set(init) == set(np_params)


@pytest.mark.parametrize("wdtype", ["float32", "int8"])
def test_serve_segnet_cli_in_process(wdtype):
    st = serve_segnet.main(["--device", "cpu", "--backend", "torch",
                            "--requests", "8", "--wdtype", wdtype])
    assert st["completed"] == 8 and st["launches"] >= 1
    gate = st["int8_gate"]
    if wdtype == "int8":
        assert gate["rel_err"] <= gate["bound"]
        assert gate["int8_bytes"] <= 0.5 * gate["f32_bytes"]
    else:
        assert gate is None


def test_serve_segnet_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_segnet.main(["--requests", "1"])
