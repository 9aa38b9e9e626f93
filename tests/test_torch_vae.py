"""The port's VAE against the JAX package's, on JAX's weights
(``params_from_jax``) and JAX's draws of the reparameterization noise and
the prior: config and layers, plans and routes per bucket ('torch' against
JAX's 'xla', 'cuda' against JAX's 'pallas' verdict), ``encode``,
``decode``, ``vae_apply``, ``elbo_loss`` and every gradient against
``jax.value_and_grad``, at ``VAE_TINY`` and the full ``VAE``, f32 and int8,
on both backends ('cuda' on CPU tensors runs kernels A's and B's plain
versions); ``sample``, the decoder against the transposed oracle, the int8
twin, and ``python -m repro_torch.vae_train`` in process."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.plan import QuantizedSuperpack as JQuantized
from repro.models import vae as jvae
from repro_torch import vae_train
from repro_torch.core import reference as tref
from repro_torch.core.plan import QuantizedSuperpack
from repro_torch.models import vae as tvae

from tests.conftest import TOL_FWD, TOL_GRAD, assert_close


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


BASES = {"tiny": (jvae.VAE_TINY, tvae.VAE_TINY),
         "full": (jvae.VAE, tvae.VAE)}
CASES = [(base, w, b) for base in ("tiny", "full")
         for w in ("float32", "int8") for b in ("torch", "cuda")]


def configs(base_name, backend, wdtype):
    jbase, tbase = BASES[base_name]
    return (dataclasses.replace(jbase, wdtype=wdtype),
            dataclasses.replace(tbase, backend=backend, wdtype=wdtype))


@functools.lru_cache(maxsize=None)
def jax_params(jcfg, seed=0):
    p, _ = jvae.vae_init(jax.random.PRNGKey(seed), jcfg)
    return jax.tree.map(np.asarray, p)


def inputs(cfg, b=3, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, cfg.image_hw, cfg.image_hw, cfg.in_c)) \
        .astype(np.float32)


def jax_eps(cfg, b, key):
    """The noise JAX's ``reparameterize`` draws from ``key``."""
    return np.array(jax.random.normal(key, (b, cfg.latent_dim), jnp.float32))


@functools.lru_cache(maxsize=None)
def jax_results(jcfg):
    """JAX's (mu, logvar, recon, loss, grads) on ``inputs(jcfg)`` with the
    key 7 (jitted once per config, shared by the port's backends)."""
    x = inputs(jcfg)
    key = jax.random.PRNGKey(7)
    p = jax_params(jcfg)
    mu, lv = jax.jit(functools.partial(jvae.encode, cfg=jcfg))(p, x)
    recon, _, _ = jax.jit(functools.partial(jvae.vae_apply, cfg=jcfg))(
        p, x, key)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jvae.elbo_loss(p, x, key, jcfg), allow_int=True))(p)
    return (np.asarray(mu), np.asarray(lv), np.asarray(recon), float(loss),
            grads)


def test_config_and_layers_mirror_jax():
    for jcfg, tcfg in BASES.values():
        jf = {f.name for f in dataclasses.fields(jcfg)}
        assert {f.name for f in dataclasses.fields(tcfg)} == jf
        for name in jf - {"backend"}:
            assert getattr(tcfg, name) == getattr(jcfg, name), name
        assert (tcfg.feat_hw, tcfg.feat_c) == (jcfg.feat_hw, jcfg.feat_c)
        assert [dataclasses.astuple(l) for l in tcfg.encoder_layers] == \
            [dataclasses.astuple(l) for l in jcfg.encoder_layers]
        assert [dataclasses.astuple(l) for l in tcfg.decoder_layers] == \
            [dataclasses.astuple(l) for l in jcfg.decoder_layers]
    enc, dec = tvae.VAE_TINY.encoder_layers, tvae.VAE_TINY.decoder_layers
    assert [(l.in_c, l.out_c) for l in dec] == \
        [(l.out_c, l.in_c) for l in reversed(enc)]
    # device tiling waits for the plane-parallel slice
    with pytest.raises(NotImplementedError, match="item 13"):
        tvae.vae_plans(dataclasses.replace(tvae.VAE_TINY, spatial=(2, 1)))


@pytest.mark.parametrize("base_name", ["tiny", "full"])
@pytest.mark.parametrize("wdtype", ["float32", "int8"])
def test_plans_and_routes_match_jax(base_name, wdtype):
    """Geometry field for field; 'torch' rows are JAX's 'xla' rows at
    every bucket; 'cuda' runs every site on its kernel (B at the encoder,
    A at the decoder), whole-plane wherever JAX's 'pallas' is."""
    jcfg, tcfg = configs(base_name, "torch", wdtype)
    jplans = jvae.vae_plans(dataclasses.replace(jcfg, backend="xla"))
    jpallas = jvae.vae_plans(dataclasses.replace(jcfg, backend="pallas"))
    tplans = tvae.vae_plans(tcfg)
    cplans = tvae.vae_plans(dataclasses.replace(tcfg, backend="cuda"))
    assert [p.spec.kind for p in tplans] == \
        ["conv", "conv", "transposed", "transposed"]
    for jp, jq, tp, cp in zip(jplans, jpallas, tplans, cplans):
        assert dataclasses.asdict(tp.spec) == {
            **dataclasses.asdict(jp.spec), "backend": "torch"}
        for field in ("out_hw", "gpad", "total_taps", "sum_uv", "uniform",
                      "bwd_pad", "dx_taps"):
            assert getattr(tp, field) == getattr(jp, field), field
        assert [dataclasses.astuple(r) for r in tp.routes] == \
            [dataclasses.astuple(r) for r in jp.routes]
        assert [r.path for r in cp.routes] == ["cuda"] * 4
        assert [r.sp_tiles is None for r in cp.routes] == \
            [r.sp_tiles is None for r in jq.routes]
    if base_name == "full":
        assert all(r.path == "pallas" and r.sp_tiles is None
                   for p in jpallas for r in p.routes)


@pytest.mark.parametrize("wdtype", ["float32", "int8"])
def test_params_from_jax_checks_shapes(wdtype):
    jcfg, tcfg = configs("tiny", "torch", wdtype)
    np_params = jax_params(jcfg)
    params = tvae.params_from_jax(np_params, tcfg, device="cpu")
    mine = tvae.vae_init(0, tcfg, device="cpu")
    assert set(params) == set(np_params) == set(mine)
    for k, v in params.items():
        assert type(v) is type(mine[k]), k
        assert tuple(v.shape) == tuple(mine[k].shape), k
    for k in ("enc0", "enc1", "dec0", "dec1"):
        assert isinstance(params[k], QuantizedSuperpack) == \
            (wdtype == "int8")
    leaf = np_params["dec1"]
    bad = dict(np_params, dec1=JQuantized(leaf.q[:-1], leaf.scale[:-1])
               if wdtype == "int8" else leaf[:-1])
    with pytest.raises(ValueError, match="dec1"):
        tvae.params_from_jax(bad, tcfg, device="cpu")
    bad = dict(np_params, mu_w=np_params["mu_w"][:, :-1])
    with pytest.raises(ValueError, match="mu_w"):
        tvae.params_from_jax(bad, tcfg, device="cpu")


@pytest.mark.parametrize("base_name,wdtype,backend", CASES)
def test_forward_matches_jax(base_name, wdtype, backend):
    """``encode``, ``decode`` and ``vae_apply`` on JAX's weights and
    noise, within ``TOL_FWD``."""
    jcfg, tcfg = configs(base_name, backend, wdtype)
    mu_j, lv_j, recon_j, _, _ = jax_results(jcfg)
    params = tvae.params_from_jax(jax_params(jcfg), tcfg, device="cpu")
    x = torch.from_numpy(inputs(tcfg))
    eps = torch.from_numpy(jax_eps(tcfg, 3, jax.random.PRNGKey(7)))
    with torch.no_grad():
        mu, lv = tvae.encode(params, x, tcfg)
        recon, mu2, lv2 = tvae.vae_apply(params, x, None, tcfg, eps=eps)
        z = torch.from_numpy(np.asarray(mu_j + np.exp(0.5 * lv_j)
                                        * eps.numpy()))
        dec = tvae.decode(params, z, tcfg)
    assert_close(mu.numpy(), mu_j, TOL_FWD)
    assert_close(lv.numpy(), lv_j, TOL_FWD)
    assert torch.equal(mu, mu2) and torch.equal(lv, lv2)
    assert recon.shape == x.shape
    assert_close(recon.numpy(), recon_j, TOL_FWD)
    assert_close(dec.numpy(), recon_j, TOL_FWD)


def _grad_close(got, want):
    """Per leaf: ``max|Δ| ≤ TOL_GRAD·max|g|``."""
    want = np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    assert scale > 0
    assert float(np.abs(np.asarray(got, np.float64) - want).max()) \
        <= TOL_GRAD * scale


def trainable(params):
    """(named params, leaves requiring grad): every f32 tensor, and the
    scale column of every int8 superpack (its codes take no gradient)."""
    leaves, named = {}, {}
    for k, v in params.items():
        if isinstance(v, QuantizedSuperpack):
            scale = v.scale.clone().requires_grad_()
            named[k] = QuantizedSuperpack(v.q, scale)
            leaves[k] = scale
        else:
            named[k] = leaves[k] = v.clone().requires_grad_()
    return named, leaves


@pytest.mark.parametrize("base_name,wdtype,backend", CASES)
def test_elbo_loss_and_grads_match_jax(base_name, wdtype, backend):
    """``elbo_loss`` and its gradient w.r.t. every trainable leaf against
    ``jax.value_and_grad`` with JAX's noise: the encoder's backward runs
    ``_ps_bwd``, the decoder's ``_pt_bwd``."""
    jcfg, tcfg = configs(base_name, backend, wdtype)
    _, _, _, loss_j, g_j = jax_results(jcfg)
    params = tvae.params_from_jax(jax_params(jcfg), tcfg, device="cpu")
    named, leaves = trainable(params)
    eps = torch.from_numpy(jax_eps(tcfg, 3, jax.random.PRNGKey(7)))
    loss = tvae.elbo_loss(named, torch.from_numpy(inputs(tcfg)), None, tcfg,
                          eps=eps)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(
        leaves.values()))))
    assert_close(float(loss.detach()) / abs(loss_j), loss_j / abs(loss_j),
                 TOL_FWD)
    assert set(grads) == set(g_j)
    for k, g in grads.items():
        want = g_j[k]
        if isinstance(want, JQuantized):
            assert want.q.dtype == jax.dtypes.float0
            want = want.scale
        assert g.shape == want.shape, k
        _grad_close(g.numpy(), want)


def test_elbo_kl_term_and_one_step_improves():
    """beta = 0 drops the KL (≥ 0); one SGD step on the port's own init
    lowers the loss on a fixed batch and noise."""
    cfg = tvae.VAE_TINY
    p = tvae.vae_init(0, cfg, device="cpu")
    x = torch.zeros((2, cfg.image_hw, cfg.image_hw, cfg.in_c))
    gen = torch.Generator().manual_seed(3)
    eps = torch.randn((2, cfg.latent_dim), generator=gen)
    full = float(tvae.elbo_loss(p, x, None, cfg, beta=1.0, eps=eps))
    recon_only = float(tvae.elbo_loss(p, x, None, cfg, beta=0.0, eps=eps))
    assert full >= recon_only
    xb = torch.from_numpy(vae_train.batch_at(cfg, 4, 0))
    l0 = float(tvae.elbo_loss(p, xb, None, cfg, eps=eps.repeat(2, 1)))
    p2, _ = vae_train.sgd_step(p, xb, torch.Generator().manual_seed(0), cfg,
                               1e-3)
    assert float(tvae.elbo_loss(p2, xb, None, cfg,
                                eps=eps.repeat(2, 1))) < l0


@pytest.mark.parametrize("base_name", ["tiny", "full"])
def test_sample_matches_jax(base_name):
    jcfg, tcfg = configs(base_name, "cuda", "float32")
    p = jax_params(jcfg)
    key = jax.random.PRNGKey(2)
    want = np.asarray(jvae.sample(p, key, jcfg, n=5))
    z = np.array(jax.random.normal(key, (5, jcfg.latent_dim)))
    params = tvae.params_from_jax(p, tcfg, device="cpu")
    with torch.no_grad():
        got = tvae.sample(params, None, tcfg, n=5, z=torch.from_numpy(z))
        drawn = tvae.sample(params, torch.Generator().manual_seed(0), tcfg,
                            n=5)
    assert got.shape == drawn.shape == (5, tcfg.image_hw, tcfg.image_hw,
                                        tcfg.in_c)
    assert_close(got.numpy(), want, TOL_FWD)
    assert float(drawn.abs().max()) <= 1.0          # tanh output


def test_decoder_matches_transposed_oracle():
    """The decoder == a chain of the lhs-dilated oracle on the unpacked
    HWIO kernels (same nonlinearity schedule)."""
    cfg = tvae.VAE_TINY
    p = tvae.vae_init(1, cfg, device="cpu")
    z = torch.randn((2, cfg.latent_dim),
                    generator=torch.Generator().manual_seed(1))
    plans = tvae.decoder_plans(cfg)
    h = torch.relu(z @ p["proj"] + p["projb"])
    x = h.reshape(2, cfg.feat_hw, cfg.feat_hw, cfg.feat_c)
    for i, plan in enumerate(plans):
        x = tref.oracle_conv_transpose2d(
            x, plan.unpack(p[f"dec{i}"]), strides=plan.spec.strides,
            padding=plan.spec.padding) + p[f"decb{i}"]
        x = torch.tanh(x) if i == len(plans) - 1 else torch.relu(x)
    with torch.no_grad():
        assert_close(tvae.decode(p, z, cfg).numpy(), x.numpy(), 1e-3)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_int8_twin_within_its_bound(backend):
    """The int8 VAE from the same seed quantizes the f32 model's
    superpacks, plans the same routes, and its reconstruction stays within
    L/127 rel L∞ of the f32 model's (L = 4 quantized sites; the card's
    smoke holds the same gate)."""
    cfg = dataclasses.replace(tvae.VAE, backend=backend)
    cfg8 = dataclasses.replace(cfg, wdtype="int8")
    assert [p.routes for p in tvae.vae_plans(cfg8)] == \
        [p.routes for p in tvae.vae_plans(cfg)]
    p32, p8 = (tvae.vae_init(0, c, device="cpu") for c in (cfg, cfg8))
    for k, plan in zip(("enc0", "enc1", "dec0", "dec1"),
                       tvae.vae_plans(cfg8)):
        assert torch.equal(p8[k].q, plan.as_superpack(p32[k]).q)
    x = torch.from_numpy(inputs(cfg, b=4, seed=5))
    eps = torch.randn((4, cfg.latent_dim),
                      generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        y32, _, _ = tvae.vae_apply(p32, x, None, cfg, eps=eps)
        y8, _, _ = tvae.vae_apply(p8, x, None, cfg8, eps=eps)
    rel = float((y8 - y32).abs().max() / y32.abs().max())
    assert 0 < rel <= 4 / 127.0, rel


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_vae_train_cli_in_process(backend):
    out = vae_train.main(["--device", "cpu", "--backend", backend,
                          "--steps", "1"])
    assert out["final"] < out["before"]
    assert np.isfinite(out["losses"]).all()


def test_vae_train_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vae_train.main(["--steps", "1"])
