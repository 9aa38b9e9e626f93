"""The plain references against the program at tiny sizes on the CPU:
the same weights, packed by the program's plans for the program and left
HWIO for the reference."""
import dataclasses

import numpy as np
import pytest
import torch

from bench.families import gan as gan_family
from bench.reference import gan as gan_ref
from bench.reference.common import to_tf32
from bench.tests.tiny import GAN_LAYERS

CPU = torch.device("cpu")
GAN = {"name": "tiny-gan", "layers": GAN_LAYERS, "z_dim": 8, "std": 0.02,
       "bias_std": 0.02}


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_generator_and_discriminator(backend):
    cfg = dict(GAN, backend=backend)
    w = gan_family.make_weights(cfg, 11, CPU, train=True)
    pcfg, gp, dp = gan_family.pack(cfg, w)
    from repro_torch.models import gan
    z = torch.randn(5, 8, generator=torch.Generator().manual_seed(0))
    img = gan.generator_apply(gp, z, pcfg)
    assert rel(img, gan_ref.generator(w, z, cfg)) < 1e-5
    assert rel(gan.discriminator_apply(dp, img, pcfg),
               gan_ref.discriminator(w, img, cfg)) < 1e-5


def test_train_step():
    cfg = dict(GAN, backend="torch")
    w = gan_family.make_weights(cfg, 12, CPU, train=True)
    z, real = gan_ref.batch_at(5, 0, 4, 8, 16)
    tr = gan_family.Trainer(cfg, w, 5, 4, 2e-4, CPU)
    zb, rb = tr.batch(0)
    assert np.array_equal(zb.numpy(), z) and np.array_equal(rb.numpy(),
                                                            real)
    p0 = tr.params()
    gl, dl = tr.step(zb, rb)
    new, rgl, rdl = gan_ref.sgd_step(w, torch.from_numpy(z),
                                     torch.from_numpy(real), cfg, 2e-4)
    assert gl == pytest.approx(rgl, rel=1e-6)
    assert dl == pytest.approx(rdl, rel=1e-6)
    for k, v in tr.params().items():
        a = float((p0[k] - v).norm())
        b = float((w[k] - new[k]).norm())
        assert a == pytest.approx(b, rel=1e-4), k


def test_tf32_rounding():
    x = torch.tensor([1 + 2 ** -11, 1 + 2 ** -12, -(1 + 3 * 2 ** -11), 3.0])
    assert to_tf32(x).tolist() == [1 + 2 ** -10, 1.0, -(1 + 2 * 2 ** -10),
                                   3.0]


def test_tf32_reference_is_off_the_f32_one():
    cfg = dict(GAN, backend="torch")
    w = gan_family.make_weights(cfg, 14, CPU, train=False)
    z = torch.randn(4, 8)
    f32 = gan_ref.generator(w, z, cfg)
    err = rel(gan_ref.generator(w, z, cfg, tf32=True), f32)
    assert 1e-5 < err < 1e-2
    assert dataclasses.is_dataclass(gan_family.sites(cfg, False, 1)[0][0])
