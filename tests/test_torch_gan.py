"""The port's DCGAN generator against the JAX package's, on JAX's weights:
``params_from_jax`` carries the superpacks across as plain arrays, and the
forward matches under both plan policies."""
import jax
import numpy as np
import pytest
import torch

from repro.models import gan as jgan
from repro_torch.models import gan as tgan

from tests.conftest import TOL_FWD, assert_close

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
