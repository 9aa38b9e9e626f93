"""The yardstick against hand counts and against PyTorch's own FLOP
counter on the plain reference."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench import work
from bench.families import gan as gan_family
from bench.harness import Cell
from bench.reference import gan as gan_ref
from bench.tests.tiny import GAN_LAYERS


def sites(config, train=False):
    fam = __import__(f"bench.families.{Cell(config).config['family']}",
                     fromlist=["sites"])
    return [s for s, _ in fam.sites(Cell(config).config, train, 64)]


def test_dcgan_generator_flops_by_hand():
    s = sites("dcgan.gen.closed")
    deconv = [x for x in s if x.kind == "transposed"]
    # 4² · 25 · 1024 · 512 = 8² · 25 · 512 · 256 = 16² · 25 · 256 · 128
    # = 209 715 200 MACs, and 32² · 25 · 128 · 3 = 9 830 400
    assert [x.macs() for x in deconv] == [209_715_200] * 3 + [9_830_400]
    assert work.forward_flops(deconv) == 1.277952e9
    assert work.forward_flops(s) == 1.277952e9 + 2 * 100 * 16384


def test_bytes_count_input_weights_output_once():
    s = work.Site("x", "transposed", 4, 1024, 512, 5, 2, bias=True)
    assert s.bytes(2) == 4 * (2 * (16 * 1024 + 64 * 512)
                              + 25 * 1024 * 512 + 512)
    peaks = work.Peaks(67e12, 3.35e12)
    assert s.bound_s(64, peaks) == pytest.approx(64 * 2 * s.macs() / 67e12)
    assert s.bound_s(1, peaks) == pytest.approx(s.bytes(1) / 3.35e12)


@pytest.mark.parametrize("train", [False, True])
def test_flops_equal_pytorch_counter_on_reference(train):
    cfg = {"name": "t", "backend": "torch", "layers": GAN_LAYERS,
           "z_dim": 8, "std": 0.02, "bias_std": 0.02}
    w = gan_family.make_weights(cfg, 3, torch.device("cpu"), train)
    all_sites = [s for s, _ in gan_family.sites(cfg, train, 4)]
    z, real = torch.randn(4, 8), torch.rand(4, 16, 16, 3)
    with FlopCounterMode(display=False) as fc:
        if train:
            gan_ref.sgd_step(w, z, real, cfg, 2e-4)
        else:
            gan_ref.generator(w, z, cfg)
    if train:
        gen = [s for s in all_sites
               if s.name == "proj" or s.name.startswith("dc")]
        disc = [s for s in all_sites if s not in gen]
        want = work.gan_step_flops(gen, disc, 4)
    else:
        want = work.forward_flops(all_sites, 4)
    assert fc.get_total_flops() == want


def test_card_peaks_by_name():
    assert work.card_peaks("NVIDIA H100 80GB HBM3") == work.Peaks(67e12,
                                                                 3.35e12)
    assert work.card_peaks("NVIDIA H100 PCIe").flops == 51e12
    assert work.card_peaks("Tesla T4") is None
