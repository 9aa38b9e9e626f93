"""The port's DCGAN against the JAX package's, on JAX's weights:
``params_from_jax`` / ``dparams_from_jax`` carry the superpacks across as
plain arrays; the generator, the discriminator, ``gan_losses`` and one
``train_step`` match under both plan policies."""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.models import gan as jgan
from repro_torch import train_gan
from repro_torch.models import gan as tgan
from repro_torch.train.data import GANPipeline

from tests.conftest import TOL_FWD, TOL_GRAD, assert_close

# examples/serve_dcgan.py's SMALL_LAYERS (4x4x128 -> 32x32x3) and an
# odd-width variant, in both packages
SMALL = ((4, 128, 64, 5, 2), (8, 64, 32, 5, 2), (16, 32, 3, 5, 2))
ODD = ((3, 24, 12, 4, 2), (6, 12, 3, 4, 2))


def configs(layers, backend, z_dim=100):
    jcfg = jgan.GANConfig("g", tuple(jgan.DeconvLayer(*l) for l in layers),
                          z_dim=z_dim)
    tcfg = tgan.GANConfig("g", tuple(tgan.DeconvLayer(*l) for l in layers),
                          z_dim=z_dim, backend=backend)
    return jcfg, tcfg


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def jax_params(jcfg):
    p, _ = jgan.generator_init(jax.random.PRNGKey(0), jcfg)
    return {k: np.asarray(v) for k, v in p.items()}


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("layers,z_dim", [(SMALL, 100), (ODD, 7)],
                         ids=["small", "odd"])
def test_generator_matches_jax_on_its_weights(layers, z_dim, backend):
    jcfg, tcfg = configs(layers, backend, z_dim)
    np_params = jax_params(jcfg)
    params = tgan.params_from_jax(np_params, tcfg, device="cpu")
    z = np.random.default_rng(3).standard_normal((5, z_dim)) \
        .astype(np.float32)
    want = np.asarray(jgan.generator_apply(np_params, z, jcfg))
    got = tgan.generator_apply(params, torch.from_numpy(z), tcfg)
    hw = layers[-1][0] * layers[-1][4]
    assert got.shape == want.shape == (5, hw, hw, 3)
    assert_close(got.numpy(), want, TOL_FWD)


def test_generator_unpack_matches_jax():
    jcfg, tcfg = configs(SMALL, "torch")
    np_params = jax_params(jcfg)
    want = jgan.generator_unpack(np_params, jcfg)
    got = tgan.generator_unpack(
        tgan.params_from_jax(np_params, tcfg, device="cpu"), tcfg)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_params_from_jax_rejects_wrong_shapes():
    jcfg, tcfg = configs(SMALL, "torch")
    np_params = jax_params(jcfg)
    np_params["dc1"] = np_params["dc1"][:-1]
    with pytest.raises(ValueError, match="dc1"):
        tgan.params_from_jax(np_params, tcfg, device="cpu")


def test_generator_init_is_seeded_and_packed():
    _, tcfg = configs(SMALL, "torch")
    a = tgan.generator_init(7, tcfg, device="cpu")
    b = tgan.generator_init(torch.Generator().manual_seed(7), tcfg,
                            device="cpu")
    plans = tgan.generator_plans(tcfg)
    for i, (l, plan) in enumerate(zip(tcfg.layers, plans)):
        assert a[f"dc{i}"].shape == (plan.total_taps * l.in_c, l.out_c)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_table1_configs_match_jax():
    for jl, tl in ((jgan.DCGAN_LAYERS, tgan.DCGAN_LAYERS),
                   (jgan.CGAN_LAYERS, tgan.CGAN_LAYERS)):
        assert [vars(l) for l in jl] == [vars(l) for l in tl]
    for k, s in ((5, 2), (4, 2), (3, 2), (4, 3)):
        assert tgan.deconv_padding(k, s) == jgan.deconv_padding(k, s)
    assert (tgan.DCGAN.z_dim, tgan.CGAN.z_dim) == \
        (jgan.DCGAN.z_dim, jgan.CGAN.z_dim)


def test_entry_points_default_to_the_card():
    """Without ``device=`` the entry points run on CUDA, and raise on a
    machine without a card instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.serving.image_batcher import DynamicImageBatcher
    _, tcfg = configs(SMALL, "cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgan.generator_init(0, tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgan.params_from_jax({}, tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DynamicImageBatcher(lambda z: z)


# test_gan_models.py's SMALL (16x16 images), and ODD's cGAN-like k4 s2 sites
# (asymmetric pads ((2, 1), (2, 1)) on the discriminator)
TINY = ((4, 32, 16, 5, 2), (8, 16, 3, 5, 2))
GAN_CASES = [(TINY, 16), (ODD, 7)]
GAN_IDS = ["tiny", "odd"]


def jax_dparams(jcfg):
    p, _ = jgan.discriminator_init(jax.random.PRNGKey(1), jcfg)
    return {k: np.asarray(v) for k, v in p.items()}


def batch(tcfg, b=4, seed=0):
    hw = tcfg.layers[-1].in_hw * tcfg.layers[-1].stride
    return GANPipeline(tcfg, b, image_hw=hw, seed=seed).batch_at(0)


def assert_grad_close(got, want):
    """Within TOL_GRAD relative to the gradient's own scale."""
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               rtol=TOL_GRAD, atol=TOL_GRAD * scale)


@functools.lru_cache(maxsize=None)
def jax_reference(layers, z_dim):
    """JAX's params, a batch, and (jitted, once per config) the
    discriminator's logits, the loss pair and both players' gradients as
    ``examples/train_gan.py``'s step takes them."""
    jcfg, tcfg = configs(layers, "torch", z_dim)
    gp_np, dp_np = jax_params(jcfg), jax_dparams(jcfg)
    b = batch(tcfg, seed=3)

    @jax.jit
    def step(gp, dp, z, real):
        d_loss, d_grad = jax.value_and_grad(
            lambda d: jgan.gan_losses(gp, d, z, real, jcfg)[1])(dp)
        g_loss, g_grad = jax.value_and_grad(
            lambda g: jgan.gan_losses(g, dp, z, real, jcfg)[0])(gp)
        logits = jgan.discriminator_apply(dp, real, jcfg)
        return logits, g_loss, d_loss, g_grad, d_grad

    out = jax.tree.map(np.asarray, step(gp_np, dp_np, b["z"], b["real"]))
    return (gp_np, dp_np, b) + tuple(out)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("layers,z_dim", GAN_CASES, ids=GAN_IDS)
def test_discriminator_and_losses_match_jax(layers, z_dim, backend):
    _, tcfg = configs(layers, backend, z_dim)
    gp_np, dp_np, b, logits, g_loss, d_loss, _, _ = \
        jax_reference(layers, z_dim)
    gp = tgan.params_from_jax(gp_np, tcfg, device="cpu")
    dp = tgan.dparams_from_jax(dp_np, tcfg, device="cpu")
    real = torch.from_numpy(b["real"])
    got = tgan.discriminator_apply(dp, real, tcfg)
    assert got.shape == logits.shape == (4, 1)
    assert_close(got.numpy(), logits, TOL_FWD)
    got_l = tgan.gan_losses(gp, dp, torch.from_numpy(b["z"]), real, tcfg)
    for g, w in zip(got_l, (g_loss, d_loss)):
        assert_close(float(g), float(w), TOL_FWD)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("layers,z_dim", GAN_CASES, ids=GAN_IDS)
def test_train_step_matches_jax_value_and_grad(layers, z_dim, backend):
    """One ``train_step`` against JAX's step (``examples/train_gan.py``):
    the d-grads of ``gan_losses[1]`` w.r.t. dp and the g-grads of
    ``gan_losses[0]`` w.r.t. gp, both from the old params."""
    _, tcfg = configs(layers, backend, z_dim)
    gp_np, dp_np, b, _, g_loss, d_loss, g_grad, d_grad = \
        jax_reference(layers, z_dim)
    gp = tgan.params_from_jax(gp_np, tcfg, device="cpu")
    dp = tgan.dparams_from_jax(dp_np, tcfg, device="cpu")
    z, real = torch.from_numpy(b["z"]), torch.from_numpy(b["real"])
    gl, dl, gg, dg = train_gan.step_grads(gp, dp, z, real, tcfg)
    assert_close(float(gl), float(g_loss), TOL_FWD)
    assert_close(float(dl), float(d_loss), TOL_FWD)
    for got, want in ((gg, g_grad), (dg, d_grad)):
        assert set(got) == set(want)
        for k in want:
            assert got[k].shape == want[k].shape, k
            assert float(np.abs(want[k]).max()) > 0, k
            assert_grad_close(got[k].numpy(), want[k])
    lr = 0.1
    gp2, dp2, gl2, dl2 = train_gan.train_step(gp, dp, z, real, tcfg, lr)
    assert (float(gl2), float(dl2)) == (float(gl), float(dl))
    # plain SGD from the old params; the update is ~1e-8 of ~0.02-scale
    # weights, so it is checked against the step's own (JAX-checked)
    # gradients and JAX's update within TOL_FWD
    for new, old, got, want in ((gp2, gp, gg, g_grad), (dp2, dp, dg, d_grad)):
        for k in want:
            assert torch.equal(new[k], old[k] - lr * got[k]), k
            assert_close(new[k].numpy(), old[k].numpy() - lr * want[k],
                         TOL_FWD)


def test_discriminator_steps_reduce_d_loss():
    """12 d-only SGD steps lower ``d_loss`` (``test_gan_models.py``)."""
    _, tcfg = configs(TINY, "torch", 16)
    gp = tgan.generator_init(3, tcfg, device="cpu")
    dp = tgan.discriminator_init(4, tcfg, device="cpu")
    b = batch(tcfg, b=8, seed=5)
    z, real = torch.from_numpy(b["z"]), torch.from_numpy(b["real"])
    losses = []
    for _ in range(12):
        leaves = {k: v.detach().requires_grad_() for k, v in dp.items()}
        loss = tgan.gan_losses(gp, leaves, z, real, tcfg)[1]
        grads = torch.autograd.grad(loss, list(leaves.values()))
        dp = {k: (v - 0.05 * g).detach()
              for (k, v), g in zip(leaves.items(), grads)}
        losses.append(float(loss.detach()))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_discriminator_params_from_jax_and_unpack():
    jcfg, tcfg = configs(TINY, "torch", 16)
    dp_np = jax_dparams(jcfg)
    dp = tgan.dparams_from_jax(dp_np, tcfg, device="cpu")
    want = jgan.discriminator_unpack(dp_np, jcfg)
    got = tgan.discriminator_unpack(dp, tcfg)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    bad = dict(dp_np, head=dp_np["head"][:-1])
    with pytest.raises(ValueError, match="head"):
        tgan.dparams_from_jax(bad, tcfg, device="cpu")
    a = tgan.discriminator_init(9, tcfg, device="cpu")
    assert set(a) == set(dp_np)
    assert all(a[k].shape == dp[k].shape for k in a)
    assert all(torch.equal(a[k], v) for k, v in
               tgan.discriminator_init(9, tcfg, device="cpu").items())


def test_softplus_matches_jax_beyond_the_threshold():
    """``F.softplus`` returns x itself above 20; ``jax.nn.softplus`` (and
    the port's) keeps log1p(e^x)."""
    x = np.array([-30.0, -1.0, 0.0, 1.0, 19.0, 20.5, 25.0, 40.0],
                 np.float32)
    want = np.asarray(jax.nn.softplus(x))
    got = tgan.softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_gan_pipeline_matches_jax():
    from repro.train.data import GANPipeline as JPipe
    jcfg, tcfg = configs(TINY, "torch", 16)
    for step in (0, 7):
        a = GANPipeline(tcfg, 3, image_hw=16, seed=2).batch_at(step)
        b = JPipe(jcfg, 3, image_hw=16, seed=2).batch_at(step)
        for k in ("z", "real"):
            np.testing.assert_array_equal(a[k], b[k])


def test_training_entry_points_default_to_the_card():
    """Without ``device=`` the training entry points run on CUDA, and
    raise on a machine without a card instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tcfg = configs(TINY, "cuda", 16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgan.discriminator_init(0, tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgan.dparams_from_jax({}, tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_gan.main(["--small", "--steps", "1"])


def test_train_gan_cli_on_the_cpu():
    out = train_gan.main(["--device", "cpu", "--backend", "torch",
                          "--small", "--steps", "2", "--batch", "2"])
    assert len(out["d_loss"]) == 2 and np.isfinite(out["d_loss"]).all()


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("layers,z_dim", GAN_CASES, ids=GAN_IDS)
def test_int8_generator_and_discriminator_match_jax(layers, z_dim, backend):
    """``GANConfig.wdtype='int8'``: JAX's int8 params (numpy codes and
    scales) carried across, the generator and discriminator within TOL_FWD
    of JAX's on the same dequantized weights, and the int8 generator within
    L/127 of its f32 twin (the serving gate's bound, L = its layers)."""
    from repro_torch.core.plan import QuantizedSuperpack
    jcfg, tcfg = configs(layers, backend, z_dim)
    jq, tq = (dataclasses.replace(c, wdtype="int8") for c in (jcfg, tcfg))
    gp_np = jax.tree.map(np.asarray, jgan.generator_init(
        jax.random.PRNGKey(0), jq)[0])
    dp_np = jax.tree.map(np.asarray, jgan.discriminator_init(
        jax.random.PRNGKey(1), jq)[0])
    gp = tgan.params_from_jax(gp_np, tq, device="cpu")
    dp = tgan.dparams_from_jax(dp_np, tq, device="cpu")
    assert all(isinstance(gp[f"dc{i}"], QuantizedSuperpack)
               and isinstance(dp[f"c{i}"], QuantizedSuperpack)
               for i in range(len(layers)))
    b = batch(tcfg, seed=6)
    z, real = b["z"], b["real"]
    want_g = np.asarray(jax.jit(functools.partial(
        jgan.generator_apply, cfg=jq))(gp_np, z))
    want_d = np.asarray(jax.jit(functools.partial(
        jgan.discriminator_apply, cfg=jq))(dp_np, real))
    got_g = tgan.generator_apply(gp, torch.from_numpy(z), tq)
    got_d = tgan.discriminator_apply(dp, torch.from_numpy(real), tq)
    assert_close(got_g.numpy(), want_g, TOL_FWD)
    assert_close(got_d.numpy(), want_d, TOL_FWD)
    # the f32 twin: JAX's f32 init from the same key, run by the port
    gf = tgan.params_from_jax(jax_params(jcfg), tcfg, device="cpu")
    y_f = tgan.generator_apply(gf, torch.from_numpy(z), tcfg)
    rel = float((got_g - y_f).abs().max() / y_f.abs().max())
    assert 0 < rel <= len(layers) / 127.0, rel


def test_int8_init_quantizes_the_f32_draws():
    """``generator_init`` / ``discriminator_init`` under int8 quantize at
    pack the very draws the f32 config makes from the same seed."""
    from repro_torch.runtime.compress import quantize_int8_rows
    _, tcfg = configs(TINY, "torch", 16)
    tq = dataclasses.replace(tcfg, wdtype="int8")
    for init, key in ((tgan.generator_init, "dc"),
                      (tgan.discriminator_init, "c")):
        pf, pq = init(5, tcfg, device="cpu"), init(5, tq, device="cpu")
        for i in range(len(TINY)):
            q, s = quantize_int8_rows(pf[f"{key}{i}"])
            assert torch.equal(pq[f"{key}{i}"].q, q)
            assert torch.equal(pq[f"{key}{i}"].scale, s)
        assert pq[f"{key}0"].nbytes() <= 0.5 * pf[f"{key}0"].numel() * 4
