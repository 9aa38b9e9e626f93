"""Card-side tests of the port: kernel A on CUDA tensors against the float64
oracle's ULP bound and its plain version, the wrapper's refusals, and the
generator and serve driver on the 'cuda' route.

Every test here skips without a CUDA device (decided inside the fixture).
The file imports no JAX, so it runs on the GPU machine, which has none:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

``tests/test_torch_kernels.py`` shares ``CASES``/``inputs`` and holds the
same geometries to the JAX package on the CPU."""
import numpy as np
import pytest
import torch

from repro_torch.core import reference as ref
from repro_torch.core.plan import conv_spec, plan_conv
from repro_torch.core.untangle import pad_or_crop
from repro_torch.kernels import untangled_conv as tk

# (name, b, h, c, n, k, s, pads): DCGAN-like, cGAN-like, non-uniform
# phases (7 -> 11), an empty phase (stride 3 > kernel 2), ragged C and N
CASES = [
    ("dcgan_like", 2, 4, 16, 8, 5, 2, ((2, 3), (2, 3))),
    ("cgan_like", 2, 8, 8, 4, 4, 2, ((1, 3), (1, 3))),
    ("nonuniform_7_to_11", 2, 7, 16, 8, 5, 2, ((1, 1), (1, 1))),
    ("empty_phase_s3_k2", 2, 4, 8, 8, 2, 3, ((1, 1), (1, 1))),
    ("ragged_c5_n3", 3, 5, 5, 3, 3, 2, ((1, 1), (1, 1))),
]
CASE_IDS = [c[0] for c in CASES]


def inputs(case):
    """(x, kernel) float32 numpy arrays drawn from a per-case seed."""
    name, b, h, c, n, k, s, pads = case
    rng = np.random.default_rng(sum(map(ord, name)))
    x = rng.standard_normal((b, h, h, c)).astype(np.float32)
    kern = rng.standard_normal((k, k, c, n)).astype(np.float32)
    return x, kern


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def case_on(case, device):
    _, b, h, c, n, k, s, pads = case
    x, kern = inputs(case)
    plan = plan_conv(conv_spec("transposed", x.shape, kern.shape,
                               strides=(s, s), padding=pads, backend="cuda"))
    xt, kt = torch.from_numpy(x).to(device), torch.from_numpy(kern).to(device)
    kw = dict(phases=plan.phases, out_hw=plan.out_hw, strides=(s, s),
              sum_uv=plan.sum_uv)
    return plan, xt, kt, pad_or_crop(xt, plan.gpad), plan.pack(kt), kw


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_kernel_within_ulp_bound_and_plain_version(case, cuda_device):
    _, b, h, c, n, k, s, pads = case
    plan, xt, kt, xg, packed, kw = case_on(case, cuda_device)
    torch.full((b * plan.out_hw[0] * plan.out_hw[1] * n,), float("nan"),
               device=cuda_device)          # poison what torch.empty reuses
    launches = tk.untangled_deconv2d.launches
    y = tk.untangled_deconv2d(xg, packed, **kw)
    torch.cuda.synchronize()
    assert tk.untangled_deconv2d.launches == launches + 1
    y_ref = tk.untangled_deconv2d_ref(xg, packed, **kw)
    y64, amax = ref.conv_oracle_f64(ref.zero_insert(xt, (s, s)), kt,
                                    padding=pads)
    terms = torch.zeros(plan.out_hw, dtype=torch.float64, device=cuda_device)
    for ex in plan.phases:
        terms[ex.q[0]::s, ex.q[1]::s] = ex.taps[0] * ex.taps[1] * c
    bound = ref.ulp_bound(y64, amax, terms[None, :, :, None])
    assert bool(((y.double() - y64).abs() <= bound).all())
    assert bool(((y_ref.double() - y64).abs() <= bound).all())
    for ex in plan.phases:
        if ex.taps[0] * ex.taps[1] == 0:
            assert not bool(y[:, ex.q[0]::s, ex.q[1]::s].ne(0).any())


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    plan, xt, kt, xg, packed, kw = case_on(CASES[0], cuda_device)
    with pytest.raises(NotImplementedError):
        tk.untangled_deconv2d(xg.clone().requires_grad_(), packed, **kw)
    with pytest.raises(TypeError):
        tk.untangled_deconv2d(xg.double(), packed.double(), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        tk.untangled_deconv2d(xg.transpose(1, 2), packed, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        tk.untangled_deconv2d(xg, packed.cpu(), **kw)


def test_generator_cuda_route_matches_torch_route(cuda_device):
    from repro_torch.models import gan
    layers = ((4, 128, 64, 5, 2), (8, 64, 32, 5, 2), (16, 32, 3, 5, 2))
    cfgs = [gan.GANConfig("g", tuple(gan.DeconvLayer(*l) for l in layers),
                          backend=be) for be in ("cuda", "torch")]
    params = gan.generator_init(0, cfgs[0], device=cuda_device)
    z = torch.randn((5, 100), generator=torch.Generator().manual_seed(1))
    z = z.to(cuda_device)
    launches = tk.untangled_deconv2d.launches
    with torch.inference_mode():
        y_cuda, y_torch = (gan.generator_apply(params, z, cfg)
                           for cfg in cfgs)
        torch.cuda.synchronize()
    assert tk.untangled_deconv2d.launches == launches + 3
    torch.testing.assert_close(y_cuda, y_torch, rtol=2e-4, atol=2e-4)


def test_serve_driver_on_the_card(cuda_device):
    from repro_torch import serve_dcgan
    launches = tk.untangled_deconv2d.launches
    st = serve_dcgan.main(["--small", "--requests", "20"])
    assert st["completed"] == 20
    assert tk.untangled_deconv2d.launches > launches
