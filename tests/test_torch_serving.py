"""The port's image batcher against the JAX package's, serving the small
DCGAN on the CPU: same queue and clock, same launches; each request gets
its own row; the same stats."""
import numpy as np
import pytest
import torch

from repro.serving import image_batcher as jib
from repro.serving import metrics as jmetrics
from repro_torch import serve_dcgan
from repro_torch.models import gan as tgan
from repro_torch.serving import image_batcher as tib
from repro_torch.serving import metrics as tmetrics

from tests.conftest import TOL_FWD


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def small_model():
    cfg, params = serve_dcgan.load_model(small=True, backend="cuda",
                                         device="cpu")
    return cfg, params


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-4
        return self.t


def latents(n, dim=100):
    rng = np.random.default_rng(11)
    return [rng.standard_normal(dim).astype(np.float32) for _ in range(n)]


def both_batchers(small_model, **kw):
    cfg, params = small_model
    port = tib.DynamicImageBatcher(
        lambda z: tgan.generator_apply(params, z, cfg), device="cpu",
        clock=FakeClock(), **kw)
    # the JAX batcher needs only the schedule here: an echo serve function
    ref = jib.DynamicImageBatcher(lambda x: x, clock=FakeClock(), **kw)
    return port, ref


@pytest.mark.parametrize("n,costs,want", [
    (11, None, [(16, 11)]),
    (5, {1: 1.0, 4: 2.0, 16: 7.0, 64: 100.0}, [(4, 4), (1, 1)]),
    (70, None, [(64, 64), (16, 6)]),
])
def test_same_queue_same_launches_as_jax(small_model, n, costs, want):
    port, ref = both_batchers(small_model)
    for b in (port, ref):
        if costs:
            b.bucket_cost_s = dict(costs)
        b.run([jib.ImageRequest(rid=i, payload=z) if b is ref else
               tib.ImageRequest(rid=i, payload=z)
               for i, z in enumerate(latents(n))])
    assert port.launches == ref.launches == want
    st_p, st_r = port.stats(), ref.stats()
    assert set(st_p) == set(st_r)
    assert st_p["pad_fraction"] == pytest.approx(st_r["pad_fraction"])
    assert st_p["bucket_histogram"] == st_r["bucket_histogram"]
    assert st_p["completed"] == st_r["completed"] == n


def test_each_request_gets_its_own_row(small_model):
    cfg, params = small_model
    port, _ = both_batchers(small_model)
    zs = latents(7)
    done = port.run([tib.ImageRequest(rid=i, payload=z)
                     for i, z in enumerate(zs)])
    assert sorted(r.rid for r in done) == list(range(7))
    for r in done:
        assert r.out.shape == (32, 32, 3) and np.isfinite(r.out).all()
        one = tgan.generator_apply(params, torch.from_numpy(zs[r.rid][None]),
                                   cfg)
        np.testing.assert_allclose(r.out, one[0].numpy(), rtol=TOL_FWD,
                                   atol=TOL_FWD)
        assert r.latency_s > 0


def test_deadline_pump_and_warmup(small_model):
    port, ref = both_batchers(small_model, max_wait_ms=10_000)
    for b, cls in ((port, tib.ImageRequest), (ref, jib.ImageRequest)):
        for i, z in enumerate(latents(2)):
            b.submit(cls(rid=i, payload=z))
        assert b.pump() == []                      # still coalescing
        assert len(b.pump(drain=True)) == 2
    port.warmup(np.zeros(100, np.float32), iters=1)
    assert set(port.bucket_cost_s) == set(port.buckets)
    assert all(v > 0 for v in port.bucket_cost_s.values())
    with pytest.raises(ValueError):
        tib.DynamicImageBatcher(lambda z: z, device="cpu").warmup()


def test_latency_stats_are_jax_math():
    lat = [0.010, 0.020, 0.030, 0.045, 0.2]
    assert tmetrics.latency_stats(lat, window_s=0.5) == \
        jmetrics.latency_stats(lat, window_s=0.5)
    assert tmetrics.latency_stats([]) == jmetrics.latency_stats([])
    st = tmetrics.latency_stats(lat, window_s=0.5)
    assert tmetrics.format_stats(st) == jmetrics.format_stats(st)


def test_serve_driver_on_cpu(capsys):
    st = serve_dcgan.main(["--device", "cpu", "--backend", "torch",
                           "--small", "--requests", "8"])
    assert st["completed"] == 8
    assert "served 8 of 8" in capsys.readouterr().out
