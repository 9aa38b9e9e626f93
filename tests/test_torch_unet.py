"""The port's diffusion U-Net against the JAX package's, on JAX's weights
(``params_from_jax``): sites and route summaries for ``UNET_TINY`` and
``UNET``, ``unet_apply`` on the 'torch' route and on the 'cuda' route (the
kernels' plain versions on the CPU) against JAX's 'xla' forward, the same
with both packages' tile budgets shrunk so the 'cuda' route walks kernels
C's and D's plain versions (against JAX's 'pallas' route in interpret
mode), ``unet_loss`` and its gradients against ``jax.value_and_grad``,
``denoise_loop`` against sequential ``denoise_step``s, the int8 twin, and
``python -m repro_torch.denoise_unet`` driven in process."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.plan import QuantizedSuperpack as JQuantized
from repro.models import unet as junet
from repro_torch import denoise_unet
from repro_torch.core import plan as tplan
from repro_torch.core.plan import QuantizedSuperpack
from repro_torch.kernels import untangled_conv as tk
from repro_torch.models import unet as tunet

from tests.conftest import TOL_FWD, TOL_GRAD, assert_close
from tests.test_torch_tiled import SHRUNK, both_budgets


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


BASES = {"tiny": (junet.UNET_TINY, tunet.UNET_TINY),
         "full": (junet.UNET, tunet.UNET)}


def configs(base_name, backend, wdtype, jbackend="xla"):
    jbase, tbase = BASES[base_name]
    return (dataclasses.replace(jbase, wdtype=wdtype, backend=jbackend),
            dataclasses.replace(tbase, backend=backend, wdtype=wdtype))


def as_port_config(jcfg, backend):
    fields = dataclasses.asdict(jcfg)
    fields["backend"] = backend
    return tunet.UNetConfig(**fields)


@functools.lru_cache(maxsize=None)
def jax_params(jcfg, seed=0):
    p, _ = junet.unet_init(jax.random.PRNGKey(seed), jcfg)
    return jax.tree.map(np.asarray, p)


@functools.lru_cache(maxsize=None)
def jax_forward(jcfg):
    """JAX's forward on ``inputs(jcfg)`` (one compile per config, shared by
    the port's routes)."""
    x, t = inputs(jcfg)
    return np.asarray(jax.jit(functools.partial(junet.unet_apply, cfg=jcfg))(
        jax_params(jcfg), x, t))


@functools.lru_cache(maxsize=None)
def jax_loss_and_grads(jcfg, b=3, seed=4):
    """``jax.value_and_grad`` of JAX's ``unet_loss`` on ``inputs(jcfg, b,
    seed)`` with the key 7, and the draws of t and the noise it makes."""
    x, _ = inputs(jcfg, b=b, seed=seed)
    key = jax.random.PRNGKey(7)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: junet.unet_loss(p, x, key, jcfg), allow_int=True))(
            jax_params(jcfg))
    kt, kn = jax.random.split(key)
    t = np.array(jax.random.uniform(kt, (b,), jnp.float32))
    noise = np.array(jax.random.normal(kn, x.shape, jnp.float32))
    return x, t, noise, float(loss), grads


def inputs(cfg, b=2, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, cfg.image_hw, cfg.image_hw, cfg.in_c)) \
        .astype(np.float32)
    t = rng.uniform(0.0, 1.0, (b,)).astype(np.float32)
    return x, t


@pytest.mark.parametrize("base_name", ["tiny", "full"])
@pytest.mark.parametrize("wdtype", ["float32", "int8"])
def test_sites_and_route_summary_match_jax(base_name, wdtype):
    jcfg, tcfg = configs(base_name, "torch", wdtype)
    jsites, tsites = junet.unet_sites(jcfg), tunet.unet_sites(tcfg)
    assert [n for n, _ in tsites] == [n for n, _ in jsites]
    for (_, js), (_, ts) in zip(jsites, tsites):
        assert dataclasses.asdict(ts) == {**dataclasses.asdict(js),
                                          "backend": "torch"}
    # 'torch' rows are JAX's 'xla' rows, at every bucket
    for b in tplan.BATCH_BUCKETS:
        assert tunet.unet_route_summary(tcfg, b) == \
            junet.unet_route_summary(jcfg, b)
    cuda = dataclasses.replace(tcfg, backend="cuda")
    assert {p for _, p in tunet.unet_route_summary(cuda).values()} == \
        {"cuda"}
    assert tunet.unet_route_summary(cuda).keys() == \
        junet.unet_route_summary(jcfg).keys()


def test_schema_fields_refuse_what_is_not_ported():
    """``spatial`` waits for the plane-parallel slice; ``autotune`` takes
    an ``AutotunePolicy`` and refuses anything else."""
    cfg = dataclasses.replace(tunet.UNET_TINY, autotune=object())
    with pytest.raises(TypeError, match="AutotunePolicy"):
        tunet.unet_plans(cfg)
    cfg = dataclasses.replace(tunet.UNET_TINY, name="sp", spatial=(2, 1))
    with pytest.raises(NotImplementedError):
        tunet.unet_plans(cfg)


APPLY_CASES = [(base, w, b) for base in ("tiny", "full")
               for w in ("float32", "int8") for b in ("torch", "cuda")]


@pytest.mark.parametrize("base_name,wdtype,backend", APPLY_CASES)
def test_unet_apply_matches_jax_on_its_weights(base_name, wdtype, backend):
    jcfg, tcfg = configs(base_name, backend, wdtype)
    np_params = jax_params(jcfg)
    params = tunet.params_from_jax(np_params, tcfg, device="cpu")
    if wdtype == "int8":
        assert all(isinstance(params[n], QuantizedSuperpack)
                   for n, _ in tunet.unet_sites(tcfg))
    x, t = inputs(tcfg)
    want = jax_forward(jcfg)
    got = tunet.unet_apply(params, torch.from_numpy(x), torch.from_numpy(t),
                           tcfg)
    assert got.shape == want.shape == x.shape
    assert_close(got.numpy(), want, TOL_FWD)


@pytest.mark.parametrize("wdtype", ["float32", "int8"])
@pytest.mark.parametrize("base,budget,tiled", SHRUNK,
                         ids=[c[0].name for c in SHRUNK])
def test_tiled_cuda_route_matches_jax_pallas(base, budget, tiled, wdtype,
                                             monkeypatch):
    """Both packages' budgets shrunk: the port's 'cuda' route runs the
    tiled sites through kernels C's and D's plain versions (counted by the
    wrappers' plain-version calls), JAX's 'pallas' route through its tiled
    Pallas kernels in interpret mode; the forwards agree within
    ``TOL_FWD``."""
    jcfg = dataclasses.replace(base, wdtype=wdtype, backend="pallas")
    tcfg = as_port_config(jcfg, "cuda")
    np_params = jax_params(dataclasses.replace(jcfg, backend="xla"))
    x, t = inputs(tcfg, b=1, seed=3)
    calls = {"conv": 0, "deconv": 0}

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tk, "untangled_conv2d_superpack_tiled_ref", counting(
        "conv", tk.untangled_conv2d_superpack_tiled_ref))
    monkeypatch.setattr(tk, "untangled_deconv2d_tiled_ref", counting(
        "deconv", tk.untangled_deconv2d_tiled_ref))
    with both_budgets(budget):
        plans = tunet.unet_plans(tcfg)
        assert [n for n, p in plans.items()
                if p.routes[0].sp_tiles is not None] == tiled
        want = np.asarray(junet.unet_apply(np_params, x, t, jcfg))
        params = tunet.params_from_jax(np_params, tcfg, device="cpu")
        got = tunet.unet_apply(params, torch.from_numpy(x),
                               torch.from_numpy(t), tcfg)
    assert calls == {"conv": sum(n != "up0" for n in tiled),
                     "deconv": int("up0" in tiled)}
    assert_close(got.numpy(), want, TOL_FWD)


def _grad_close(got, want):
    """Per leaf: ``max|Δ| ≤ TOL_GRAD·max|g|``."""
    want = np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    assert scale > 0
    assert float(np.abs(np.asarray(got, np.float64) - want).max()) \
        <= TOL_GRAD * scale


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("wdtype", ["float32", "int8"])
def test_unet_loss_and_grads_match_jax(wdtype, backend):
    """``unet_loss`` and its gradient w.r.t. every trainable leaf (the f32
    superpacks, or the int8 scale columns; biases, ``temb_*``,
    ``tproj*``) against ``jax.value_and_grad`` on the same draws of t and
    the noise (JAX's, from its key)."""
    jcfg, tcfg = configs("tiny", backend, wdtype)
    x, t, noise, loss_j, g_j = jax_loss_and_grads(jcfg)
    params = tunet.params_from_jax(jax_params(jcfg), tcfg, device="cpu")
    leaves, named = {}, {}
    for k, v in params.items():
        if isinstance(v, QuantizedSuperpack):
            scale = v.scale.clone().requires_grad_()
            named[k] = QuantizedSuperpack(v.q, scale)
            leaves[k] = scale
        else:
            named[k] = leaves[k] = v.clone().requires_grad_()
    loss = tunet.unet_loss(named, torch.from_numpy(x), None, tcfg,
                           t=torch.from_numpy(t),
                           noise=torch.from_numpy(noise))
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(
        leaves.values()))))
    assert_close(float(loss.detach()), loss_j, TOL_FWD)
    assert set(grads) == set(g_j)
    for k, g in grads.items():
        want = g_j[k]
        if isinstance(want, JQuantized):
            assert want.q.dtype == jax.dtypes.float0
            want = want.scale
        assert g.shape == want.shape, k
        _grad_close(g.numpy(), want)


def test_denoise_loop_is_sequential_steps_and_matches_jax():
    jcfg, tcfg = configs("tiny", "torch", "float32")
    np_params = jax_params(jcfg)
    params = tunet.params_from_jax(np_params, tcfg, device="cpu")
    steps = 3
    x, _ = inputs(tcfg, b=1, seed=9)
    want = torch.from_numpy(x)
    for s in reversed(range(steps)):
        tf = torch.full((1,), (s + 1) / steps)
        want = tunet.denoise_step(params, want, tf, tcfg, 1.0 / steps)
    got = tunet.denoise_loop(params, torch.from_numpy(x), tcfg, steps)
    assert_close(got.numpy(), want.numpy(), 1e-6)
    assert bool(torch.isfinite(got).all())
    ref = np.asarray(junet.denoise_loop(np_params, jnp.asarray(x), jcfg,
                                        steps))
    assert_close(got.numpy(), ref, TOL_FWD)


def test_schedule_and_embedding_match_jax():
    t = np.linspace(0.0, 1.0, 33).astype(np.float32)
    assert_close(tunet.alpha_bar(torch.from_numpy(t)).numpy(),
                 np.asarray(junet.alpha_bar(jnp.asarray(t))), 1e-6)
    for dim in (16, 64):
        assert_close(tunet.time_embedding(torch.from_numpy(t), dim).numpy(),
                     np.asarray(junet.time_embedding(jnp.asarray(t), dim)),
                     TOL_FWD)


def test_int8_twin_same_routes_and_bounded_forward():
    """``tests/test_unet.py``'s int8 gate on the port alone: the int8 twin
    plans the same route paths and its forward stays within
    ``0.15·max|y32| + 1e-3`` of the f32 model from the same seed."""
    cfg = tunet.UNET_TINY
    cfg8 = dataclasses.replace(cfg, name="unet-tiny-w8", wdtype="int8")
    for backend in ("torch", "cuda"):
        assert tunet.unet_route_summary(dataclasses.replace(
            cfg8, backend=backend)) == tunet.unet_route_summary(
                dataclasses.replace(cfg, backend=backend))
    p32 = tunet.unet_init(0, cfg, device="cpu")
    p8 = tunet.unet_init(0, cfg8, device="cpu")
    plans = tunet.unet_plans(cfg)
    for name, plan in plans.items():
        assert torch.equal(p8[name].q, tunet.unet_plans(cfg8)[name].pack(
            plan.unpack(p32[name])).q)
    x, t = inputs(cfg)
    x, t = torch.from_numpy(x), torch.full((2,), 0.5)
    y32 = tunet.unet_apply(p32, x, t, cfg)
    y8 = tunet.unet_apply(p8, x, t, cfg8)
    dev = float((y8 - y32).abs().max())
    ref = float(y32.abs().max())
    assert 0 < dev < 0.15 * ref + 1e-3, (dev, ref)


def test_params_from_jax_checks_shapes():
    jcfg, tcfg = configs("tiny", "torch", "int8")
    np_params = jax_params(jcfg)
    params = tunet.params_from_jax(np_params, tcfg, device="cpu")
    assert set(params) == set(np_params) == set(
        tunet.unet_init(0, tcfg, device="cpu"))
    bad = dict(np_params, up0=JQuantized(np_params["up0"].q[:-1],
                                         np_params["up0"].scale[:-1]))
    with pytest.raises(ValueError, match="up0"):
        tunet.params_from_jax(bad, tcfg, device="cpu")
    bad = dict(np_params, tproj2=np_params["tproj2"][:, :-1])
    with pytest.raises(ValueError, match="tproj2"):
        tunet.params_from_jax(bad, tcfg, device="cpu")


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_denoise_unet_cli_in_process(backend):
    out = denoise_unet.main(["--device", "cpu", "--backend", backend,
                             "--steps", "2"])
    assert np.isfinite(out["loss"]) and out["out"].shape == (2, 16, 16, 3)
    paths = {p for _, p in out["routes"].values()}
    assert paths == ({"cuda"} if backend == "cuda"
                     else {"fused_tap", "pixel_shuffle"})


def test_denoise_unet_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        denoise_unet.main(["--steps", "1"])
