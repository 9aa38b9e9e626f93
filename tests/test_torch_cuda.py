"""Card-side tests of the port: kernels A and B on CUDA tensors against the
float64 oracle's ULP bound and their plain versions (kernel A also at the
full-width generator sites, kernel B at the full-width discriminator and
SegNet sites, split and unsplit, f32 and int8, on NaN-filled output and
workspace memory, two launches bit-equal), the wrappers'
refusals, the generator and serve entry point on the 'cuda' route, one
'cuda' train step against the 'torch' one, the tiled kernels C and D, the
U-Net's 'cuda' route, and kernel F (flash attention) against its plain
version and the f64 oracle (f32 on FFMA; bf16 on the tensor cores at
every head dim, GQA group, ragged length, offset, window and unaligned
view), with its launches in the llama3.2-1b prefill and in the reduced LM
families' (one an attention layer, against the plain route); the tied
readout's
f32 logits and ``dense_apply``'s f32 accumulation at llama's widths; the
serving CUDA graphs (a bucket's replay bit-equal to its eager forward with
its captured launches, the decode graphs' tokens equal to eager decode's,
also over the local-KV, RG-LRU and SSD state caches, a capture that fails
raising); training: the tied readout's gradients against the f32
products, the attention core's backward (kernel F forward) against the
f64 oracle's gradients, the encoder-decoder's prefill and slot graphs on
F, and train steps launching F under remat.

Every test here skips without a CUDA device (decided inside the fixture).
The file imports no JAX, so it runs on the GPU machine, which has none:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

``tests/test_torch_kernels.py`` shares ``CASES``/``inputs`` and
``CONV_CASES``/``conv_inputs`` and holds the same geometries to the JAX
package on the CPU."""
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


# (name, b, h, c, n, k, s, d, pads) for kernel B: the DCGAN
# discriminator's first site (C = 3) and a wide one, the cGAN's asymmetric
# pad, dilated sites (d = 2, 4), ragged C/N, an odd output (9 -> 5)
CONV_CASES = [
    ("disc_c3_k5s2", 2, 16, 3, 8, 5, 2, 1, ((2, 2), (2, 2))),
    ("disc_wide_k5s2", 2, 8, 32, 24, 5, 2, 1, ((2, 2), (2, 2))),
    ("cgan_asym_k4s2", 2, 8, 16, 8, 4, 2, 1, ((2, 1), (2, 1))),
    ("dilated_d2", 1, 17, 8, 8, 3, 1, 2, ((2, 2), (2, 2))),
    ("dilated_d4", 1, 17, 4, 4, 3, 1, 4, ((4, 4), (4, 4))),
    ("ragged_c5_n3", 3, 9, 5, 3, 3, 2, 1, ((1, 1), (1, 1))),
    ("ragged_c6_n20", 2, 9, 6, 20, 5, 1, 1, ((2, 2), (2, 2))),
    ("odd_9_k5s2", 2, 9, 8, 8, 5, 2, 1, ((2, 2), (2, 2))),
]


def conv_inputs(case):
    """(x, kernel) float32 numpy arrays drawn from a per-case seed."""
    name, b, h, c, n, k = case[:6]
    rng = np.random.default_rng(sum(map(ord, name)))
    return (rng.standard_normal((b, h, h, c)).astype(np.float32),
            rng.standard_normal((k, k, c, n)).astype(np.float32))


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


@pytest.mark.parametrize("case", CONV_CASES, ids=[c[0] for c in CONV_CASES])
def test_conv_kernel_within_ulp_bound_and_plain_version(case, cuda_device):
    _, b, h, c, n, k, s, d, pads = case
    x, kern = (torch.from_numpy(a).to(cuda_device) for a in conv_inputs(case))
    xp = pad_or_crop(x, pads).contiguous()
    sp = kern.reshape(k * k * c, n)
    kw = dict(taps_hw=(k, k), strides=(s, s), rhs_dilation=(d, d))
    torch.full((b * h * h * n,), float("nan"), device=cuda_device)
    launches = tk.untangled_conv2d_superpack.launches
    y = tk.untangled_conv2d_superpack(xp, sp, **kw)
    torch.cuda.synchronize()
    assert tk.untangled_conv2d_superpack.launches == launches + 1
    y_ref = tk.untangled_conv2d_superpack_ref(xp, sp, **kw)
    y64, amax = ref.conv_oracle_f64(x, kern, strides=(s, s), dilation=(d, d),
                                    padding=pads)
    bound = ref.ulp_bound(y64, amax, k * k * c)
    assert bool(((y.double() - y64).abs() <= bound).all())
    assert bool(((y_ref.double() - y64).abs() <= bound).all())


def test_conv_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    x = torch.randn((2, 9, 9, 4), device=cuda_device)
    sp = torch.randn((25 * 4, 8), device=cuda_device)
    kw = dict(taps_hw=(5, 5), strides=(2, 2))
    with pytest.raises(NotImplementedError):
        tk.untangled_conv2d_superpack(x.clone().requires_grad_(), sp, **kw)
    with pytest.raises(TypeError):
        tk.untangled_conv2d_superpack(x.double(), sp.double(), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        tk.untangled_conv2d_superpack(x.transpose(1, 2), sp, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        tk.untangled_conv2d_superpack(x, sp.cpu(), **kw)


def test_cuda_train_step_matches_torch(cuda_device):
    """One step of the reduced DCGAN on the 'cuda' route: the kernels run
    every planned forward (A: one generator per pass, B: two
    discriminators per pass, two passes) and every gradient matches the
    'torch' route's."""
    from repro_torch import train_gan
    from repro_torch.models import gan
    from repro_torch.train.data import GANPipeline
    cfgs = [gan.GANConfig("g", train_gan.SMALL_LAYERS, backend=be)
            for be in ("cuda", "torch")]
    gp = gan.generator_init(0, cfgs[0], device=cuda_device)
    dp = gan.discriminator_init(1, cfgs[0], device=cuda_device)
    bt = GANPipeline(cfgs[0], 5, image_hw=32).batch_at(0)
    z, real = (torch.from_numpy(bt[k]).to(cuda_device) for k in ("z", "real"))
    a0 = tk.untangled_deconv2d.launches
    b0 = tk.untangled_conv2d_superpack.launches
    out_cuda = train_gan.step_grads(gp, dp, z, real, cfgs[0])
    torch.cuda.synchronize()
    n_layers = len(train_gan.SMALL_LAYERS)
    assert tk.untangled_deconv2d.launches == a0 + 2 * n_layers
    assert tk.untangled_conv2d_superpack.launches == b0 + 4 * n_layers
    out_torch = train_gan.step_grads(gp, dp, z, real, cfgs[1])
    for lc, lt in zip(out_cuda[:2], out_torch[:2]):
        assert abs(float(lc) - float(lt)) <= 1e-4 * abs(float(lt))
    # each gradient within 1e-4 of its own scale
    for gc, gt in zip(out_cuda[2:], out_torch[2:]):
        for k in gt:
            scale = float(gt[k].abs().max())
            assert scale > 0, k
            assert float((gc[k] - gt[k]).abs().max()) <= 1e-4 * scale, k


# ---------------------------------------------------------------------------
# kernel E: the int8 entries of kernels A and B
# ---------------------------------------------------------------------------

def _int8(packed):
    from repro_torch.runtime.compress import (dequantize_int8,
                                              quantize_int8_rows)
    q, scale = quantize_int8_rows(packed)
    return q, scale, dequantize_int8(q, scale)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_int8_deconv_kernel_bit_equal_to_f32_on_dequant(case, cuda_device):
    """Kernel A's int8 entry on (q, scale) is bit-equal to its f32 entry on
    ``dequantize_int8(q, scale)``, and both it and its plain version sit
    within the f64 ULP bound of the dequantized kernel."""
    _, b, h, c, n, k, s, pads = case
    plan, xt, kt, xg, packed, kw = case_on(case, cuda_device)
    q, scale, wd = _int8(packed)
    launches = tk.untangled_deconv2d.launches_int8
    torch.full((b * plan.out_hw[0] * plan.out_hw[1] * n,), float("nan"),
               device=cuda_device)
    y_i8 = tk.untangled_deconv2d(xg, q, scales=scale, **kw)
    y_f = tk.untangled_deconv2d(xg, wd, **kw)
    torch.cuda.synchronize()
    assert tk.untangled_deconv2d.launches_int8 == launches + 1
    assert torch.equal(y_i8, y_f)
    y_ref = tk.untangled_deconv2d_ref(xg, q, scales=scale, **kw)
    y64, amax = ref.conv_oracle_f64(ref.zero_insert(xt, (s, s)),
                                    plan.unpack(wd), padding=pads)
    terms = torch.zeros(plan.out_hw, dtype=torch.float64, device=cuda_device)
    for ex in plan.phases:
        terms[ex.q[0]::s, ex.q[1]::s] = ex.taps[0] * ex.taps[1] * c
    bound = ref.ulp_bound(y64, amax, terms[None, :, :, None])
    assert bool(((y_i8.double() - y64).abs() <= bound).all())
    assert bool(((y_ref.double() - y64).abs() <= bound).all())


# kernel A at the generator sites: (name, b, h, c, n, k, s, pads); B = 1
# takes the split K (and its reduction), B = 64 the unsplit grid but at
# DC1 (split to even out its phases); DC4 and the cGAN's DC2 (N = 3) the
# thin-N tile, split at B = 1
def _gen_sites():
    from repro_torch.models import gan
    out = []
    for tag, layers, batches in (("DCGAN", gan.DCGAN_LAYERS, (1, 64)),
                                 ("cGAN", gan.CGAN_LAYERS, (1, 16))):
        for i, l in enumerate(layers):
            for b in batches:
                out.append((f"{tag}_DC{i + 1}_B{b}", b, l.in_hw, l.in_c,
                            l.out_c, l.kernel, l.stride,
                            gan.deconv_padding(l.kernel, l.stride)))
    return out


GEN_SITES = _gen_sites()


@pytest.mark.parametrize("case", GEN_SITES, ids=[c[0] for c in GEN_SITES])
def test_deconv_kernel_at_generator_sites(case, cuda_device):
    """Kernel A's f32 and int8 entries at full width, split and unsplit:
    within the f64 ULP bound (and their plain versions), the output and
    the workspace from NaN-filled memory, a second launch bit-equal to the
    first, int8 bit-equal to f32 on the dequantized superpack."""
    _, b, h, c, n, k, s, pads = case
    plan, xt, kt, xg, packed, kw = case_on(case, cuda_device)
    q, scale, wd = _int8(packed)
    sch = tk.deconv_schedule(tuple(plan.phases), b, c, n)
    numels = (b * plan.out_hw[0] * plan.out_hw[1] * n,
              sch.workspace_bytes // 4)

    def poisoned(*args, **kwargs):
        blocks = [torch.full((m,), float("nan"), device=cuda_device)
                  for m in numels if m]
        del blocks
        return tk.untangled_deconv2d(*args, **kwargs)

    y = poisoned(xg, packed, **kw)
    y_again = poisoned(xg, packed, **kw)
    y8 = poisoned(xg, q, scales=scale, **kw)
    y8_again = poisoned(xg, q, scales=scale, **kw)
    y_d = poisoned(xg, wd, **kw)
    torch.cuda.synchronize()
    assert torch.equal(y, y_again) and torch.equal(y8, y8_again)
    assert torch.equal(y8, y_d)
    terms = torch.zeros(plan.out_hw, dtype=torch.float64, device=cuda_device)
    for ex in plan.phases:
        terms[ex.q[0]::s, ex.q[1]::s] = ex.taps[0] * ex.taps[1] * c
    for got, plain, w in (
            (y, tk.untangled_deconv2d_ref(xg, packed, **kw), kt),
            (y8, tk.untangled_deconv2d_ref(xg, q, scales=scale, **kw),
             plan.unpack(wd))):
        y64, amax = ref.conv_oracle_f64(ref.zero_insert(xt, (s, s)), w,
                                        padding=pads)
        bound = ref.ulp_bound(y64, amax, terms[None, :, :, None])
        assert bool(((got.double() - y64).abs() <= bound).all())
        assert bool(((plain.double() - y64).abs() <= bound).all())
    if b == 1:
        assert sch.split and sch.units >= tk.SMS


@pytest.mark.parametrize("case", CONV_CASES, ids=[c[0] for c in CONV_CASES])
def test_int8_conv_kernel_bit_equal_to_f32_on_dequant(case, cuda_device):
    """Kernel B's int8 entry, as kernel A's, with an all-zero row."""
    _, b, h, c, n, k, s, d, pads = case
    x, kern = (torch.from_numpy(a).to(cuda_device) for a in conv_inputs(case))
    xp = pad_or_crop(x, pads).contiguous()
    sp = kern.reshape(k * k * c, n).clone()
    sp[c] = 0.0
    q, scale, wd = _int8(sp)
    kw = dict(taps_hw=(k, k), strides=(s, s), rhs_dilation=(d, d))
    launches = tk.untangled_conv2d_superpack.launches_int8
    torch.full((b * h * h * n,), float("nan"), device=cuda_device)
    y_i8 = tk.untangled_conv2d_superpack(xp, q, scales=scale, **kw)
    y_f = tk.untangled_conv2d_superpack(xp, wd, **kw)
    torch.cuda.synchronize()
    assert tk.untangled_conv2d_superpack.launches_int8 == launches + 1
    assert torch.equal(y_i8, y_f)
    y_ref = tk.untangled_conv2d_superpack_ref(xp, q, scales=scale, **kw)
    y64, amax = ref.conv_oracle_f64(x, wd.reshape(k, k, c, n),
                                    strides=(s, s), dilation=(d, d),
                                    padding=pads)
    bound = ref.ulp_bound(y64, amax, k * k * c)
    assert bool(((y_i8.double() - y64).abs() <= bound).all())
    assert bool(((y_ref.double() - y64).abs() <= bound).all())


# kernel B at the full-width sites: (name, b, h, c, n, k, s, d, pads) of
# the DCGAN and cGAN discriminators and the SegNet at B = 1 (mostly split
# K) and B = 64 (mostly the 128-row tiles, unsplit)
def _disc_sites():
    from repro_torch.models import gan
    out = []
    for tag, layers in (("DCGAN", gan.DCGAN_LAYERS),
                        ("cGAN", gan.CGAN_LAYERS)):
        for i, l in enumerate(reversed(layers)):
            k = l.kernel
            for b in (1, 64):
                out.append((f"{tag}_D{i + 1}_B{b}", b, l.in_hw * l.stride,
                            l.out_c, l.in_c, k, l.stride, 1,
                            ((k // 2, (k - 1) // 2),) * 2))
    return out


def _seg_sites():
    from repro_torch.models import segnet
    return [(f"SegNet_L{i}_B{b}", b, l.in_hw, l.in_c, l.out_c, l.kernel,
             l.stride, l.dilation, segnet.atrous_padding(l.kernel,
                                                         l.dilation))
            for i, l in enumerate(segnet.SEGNET.layers) for b in (1, 64)]


DISC_SITES, SEG_SITES = _disc_sites(), _seg_sites()


def _conv_site_runs(case, device, with_f32):
    """Kernel B at one site on NaN-filled output and workspace memory: the
    (f32, f32 again, int8, int8 again, f32 on the dequantized superpack)
    outputs (the f32 pair only ``with_f32``), the inputs and the
    schedule."""
    _, b, h, c, n, k, s, d, pads = case
    rng = np.random.default_rng(sum(map(ord, case[0])))
    x = torch.from_numpy(rng.standard_normal((b, h, h, c)).astype(
        np.float32)).to(device)
    kern = torch.from_numpy(rng.standard_normal((k, k, c, n)).astype(
        np.float32)).to(device)
    xp = pad_or_crop(x, pads).contiguous()
    sp = kern.reshape(k * k * c, n).clone()
    sp[sp.shape[0] // 2] = 0.0                  # an all-zero row
    q, scale, wd = _int8(sp)
    kw = dict(taps_hw=(k, k), strides=(s, s), rhs_dilation=(d, d))
    oh, ow = tk.single_out_hw(xp.shape[1], xp.shape[2], (k, k), (s, s),
                              (d, d))
    sch = tk.conv_schedule(b * oh * ow, k * k * c, n)
    numels = (b * oh * ow * n, sch.workspace_bytes // 4)

    def poisoned(w, **scales):
        blocks = [torch.full((m,), float("nan"), device=device)
                  for m in numels if m]
        del blocks
        return tk.untangled_conv2d_superpack(xp, w, **kw, **scales)

    runs = {}
    if with_f32:
        runs["f32"], runs["f32_again"] = poisoned(sp), poisoned(sp)
    runs["int8"] = poisoned(q, scales=scale)
    runs["int8_again"] = poisoned(q, scales=scale)
    runs["dequant"] = poisoned(wd)
    torch.cuda.synchronize()
    return runs, (x, sp, q, scale, wd, xp, kw), sch


def _hold_to_oracle(got, plain, x, w, case):
    _, b, h, c, n, k, s, d, pads = case
    y64, amax = ref.conv_oracle_f64(x, w.reshape(k, k, c, n), strides=(s, s),
                                    dilation=(d, d), padding=pads)
    bound = ref.ulp_bound(y64, amax, k * k * c)
    assert bool(((got.double() - y64).abs() <= bound).all())
    assert bool(((plain.double() - y64).abs() <= bound).all())


@pytest.mark.parametrize("case", DISC_SITES, ids=[c[0] for c in DISC_SITES])
def test_conv_kernel_at_discriminator_sites(case, cuda_device):
    """Kernel B's f32 and int8 entries at full width, split (B = 1) and
    unsplit (B = 64): within the f64 ULP bound (and their plain versions),
    the output and the workspace from NaN-filled memory, a second launch
    bit-equal to the first, int8 bit-equal to f32 on the dequantized
    superpack; at B = 1 the DCGAN sites split K into 132+ units (D1's K of
    5 chunks stays whole)."""
    runs, (x, sp, q, scale, wd, xp, kw), sch = _conv_site_runs(
        case, cuda_device, with_f32=True)
    assert torch.equal(runs["f32"], runs["f32_again"])
    assert torch.equal(runs["int8"], runs["int8_again"])
    assert torch.equal(runs["int8"], runs["dequant"])
    _hold_to_oracle(runs["f32"], tk.untangled_conv2d_superpack_ref(
        xp, sp, **kw), x, sp, case)
    _hold_to_oracle(runs["int8"], tk.untangled_conv2d_superpack_ref(
        xp, q, scales=scale, **kw), x, wd, case)
    if case[1] == 1 and case[0].startswith("DCGAN") \
            and sch.chunks >= tk._MIN_SLICE:
        assert sch.split and sch.units >= tk.SMS


@pytest.mark.parametrize("case", SEG_SITES, ids=[c[0] for c in SEG_SITES])
def test_int8_conv_kernel_at_segnet_sites(case, cuda_device):
    """Kernel B's int8 entry at the full-width SegNet sites: bit-equal to
    the f32 entry on the dequantized superpack, two launches bit-equal on
    NaN-filled memory, within the f64 ULP bound (and its plain version);
    at B = 1 the sites L1-L8 fill the card."""
    runs, (x, sp, q, scale, wd, xp, kw), sch = _conv_site_runs(
        case, cuda_device, with_f32=False)
    assert torch.equal(runs["int8"], runs["int8_again"])
    assert torch.equal(runs["int8"], runs["dequant"])
    _hold_to_oracle(runs["int8"], tk.untangled_conv2d_superpack_ref(
        xp, q, scales=scale, **kw), x, wd, case)
    layer = int(case[0].split("_")[1][1:])
    if case[1] == 1 and 1 <= layer <= 8:
        assert sch.split and sch.units >= tk.SMS


@pytest.mark.parametrize("kind", ["transposed", "conv", "dilated"])
def test_int8_dscale_cuda_matches_torch(kind, cuda_device):
    """dx and dscale of an int8 plan on the 'cuda' route (forward on the
    int8 kernel) against the 'torch' route, each within 1e-4 of its own
    scale."""
    from repro_torch.core.plan import QuantizedSuperpack
    rng = np.random.default_rng(3)
    if kind == "transposed":
        x_shape, k_shape, kw = (3, 6, 6, 16), (5, 5, 16, 12), dict(
            strides=(2, 2), padding=((2, 3), (2, 3)))
    else:
        d = 2 if kind == "dilated" else 1
        x_shape, k_shape, kw = (3, 12, 12, 16), (3, 3, 16, 12), dict(
            strides=(1, 1) if d == 2 else (2, 2), dilation=(d, d),
            padding=((d, d), (d, d)))
    x = torch.from_numpy(rng.standard_normal(x_shape).astype(np.float32))
    kern = torch.from_numpy(rng.standard_normal(k_shape).astype(np.float32))
    out = []
    for backend in ("cuda", "torch"):
        plan = plan_conv(conv_spec(kind, x_shape, k_shape, backend=backend,
                                   wdtype="int8", **kw))
        packed = plan.pack(kern.to(cuda_device))
        xt = x.to(cuda_device).requires_grad_()
        scale = packed.scale.clone().requires_grad_()
        launches = (tk.untangled_deconv2d.launches_int8
                    + tk.untangled_conv2d_superpack.launches_int8)
        y = plan.apply(xt, QuantizedSuperpack(packed.q, scale))
        ct = torch.ones_like(y)
        out.append(torch.autograd.grad(y, (xt, scale), ct))
        torch.cuda.synchronize()
        ran = (tk.untangled_deconv2d.launches_int8
               + tk.untangled_conv2d_superpack.launches_int8) - launches
        assert ran == (1 if backend == "cuda" else 0)
    for got, want in zip(*out):
        scale = float(want.abs().max())
        assert scale > 0
        assert float((got - want).abs().max()) <= 1e-4 * scale


def test_serve_segnet_int8_on_the_card(cuda_device):
    from repro_torch import serve_segnet
    launches = tk.untangled_conv2d_superpack.launches_int8
    st = serve_segnet.main(["--requests", "12", "--wdtype", "int8"])
    assert st["completed"] == 12
    assert st["int8_gate"]["rel_err"] <= st["int8_gate"]["bound"]
    assert tk.untangled_conv2d_superpack.launches_int8 > launches


# ---------------------------------------------------------------------------
# kernels C and D: the spatially tiled kernels, f32 and int8
# ---------------------------------------------------------------------------

# (name, b, hp, wp, c, n, r, s, strides, dilation, tile) on a pre-padded
# plane: the geometries of tests/test_tiled_kernels.py's SINGLE_CASES with
# their tiles, then C = 3 and N = 3 (the scalar paths), a 7x7 site (the
# run-time tap loop) and a U-Net-like strided site; then a 3x3 site at
# every BN (4, 32, 64, 128, the last over two N tiles), the stem's C = 3, a
# stride-2 site, d = 2 and d = 4 sites (pixels spaced d apart) and a ragged
# C not divisible by 4 (4-byte plane copies); tile None takes the card's
# own (pick_block_tile_single)
TILED_CONV_CASES = [
    ("ragged_edge", 2, 13, 11, 5, 7, 3, 2, (1, 1), (1, 1), (4, 4)),
    ("strided", 1, 17, 17, 8, 8, 3, 3, (2, 2), (1, 1), (3, 5)),
    ("big_halo", 1, 21, 21, 4, 4, 3, 3, (1, 1), (3, 3), (8, 8)),
    ("ragged_c", 2, 14, 14, 130, 40, 2, 2, (2, 2), (2, 2), (2, 7)),
    ("one_by_one", 1, 9, 9, 3, 4, 1, 1, (1, 1), (1, 1), (4, 4)),
    ("one_tile_is_plane", 1, 16, 16, 6, 5, 3, 3, (1, 1), (1, 1), (16, 16)),
    ("ragged_edge_card_tile", 2, 13, 11, 5, 7, 3, 2, (1, 1), (1, 1), None),
    ("c3_n32", 2, 34, 34, 3, 32, 3, 3, (1, 1), (1, 1), None),
    ("c32_n3", 2, 34, 34, 32, 3, 3, 3, (1, 1), (1, 1), None),
    ("k7_n256", 1, 30, 29, 16, 256, 7, 7, (1, 1), (1, 1), None),
    ("s2_c32_n64", 2, 66, 66, 32, 64, 3, 3, (2, 2), (1, 1), None),
    ("bn4_n4", 2, 42, 40, 8, 4, 3, 3, (1, 1), (1, 1), None),
    ("bn32_n32", 2, 42, 40, 16, 32, 3, 3, (1, 1), (1, 1), None),
    ("bn64_n48", 1, 42, 40, 16, 48, 3, 3, (1, 1), (1, 1), None),
    ("bn128_n160", 1, 26, 24, 8, 160, 3, 3, (1, 1), (1, 1), None),
    ("stem_c3_n32", 2, 66, 66, 3, 32, 3, 3, (1, 1), (1, 1), None),
    ("s2_c16_n32", 2, 65, 65, 16, 32, 3, 3, (2, 2), (1, 1), None),
    ("d2_c8_n32", 1, 44, 44, 8, 32, 3, 3, (1, 1), (2, 2), None),
    ("d4_c8_n16", 1, 52, 52, 8, 16, 3, 3, (1, 1), (4, 4), None),
    ("ragged_c10_n32", 1, 30, 30, 10, 32, 3, 3, (1, 1), (1, 1), None),
]
# (name, b, h, w, c, n, k, stride, pads, tile): tests/test_tiled_kernels.py's
# DECONV_CASES (DCGAN and cGAN phases, an empty phase, stride 1) with their
# tiles, then the card's own tiles (pick_block_tile_transposed): the
# U-Net's k4 s2 up site at small planes (the shared-window path; up0's
# widths over ragged tiles), the run-time path at k5 s2, C % 4 != 0 and N
# not a multiple of BN on either path, BN 128 over two N tiles, BN 4 with
# N = 3, and nine phases of one shared window (run-time: 9 phases do not
# split over the threads of the shared path)
TILED_DECONV_CASES = [
    ("dcgan", 2, 8, 8, 6, 4, 5, 2, ((2, 3), (2, 3)), (3, 3)),
    ("cgan", 1, 8, 8, 5, 4, 4, 2, ((1, 3), (1, 3)), (8, 2)),
    ("empty_phase", 2, 6, 6, 5, 4, 2, 3, ((0, 0), (0, 0)), (2, 3)),
    ("stride_1", 1, 7, 5, 4, 3, 3, 1, ((1, 1), (1, 1)), (3, 2)),
    ("dcgan_card_tile", 2, 8, 8, 6, 4, 5, 2, ((2, 3), (2, 3)), None),
    ("unet_up_k4s2", 2, 20, 20, 16, 32, 4, 2, ((1, 3), (1, 3)), None),
    ("wide_k5s2", 1, 12, 12, 24, 72, 5, 2, ((2, 3), (2, 3)), None),
    ("up0_widths_k4s2", 1, 40, 36, 64, 32, 4, 2, ((1, 3), (1, 3)), None),
    ("k4s2_c10_n48", 1, 20, 20, 10, 48, 4, 2, ((1, 3), (1, 3)), None),
    ("k4s2_n160", 1, 12, 12, 8, 160, 4, 2, ((1, 3), (1, 3)), None),
    ("k4s2_bn4_n3", 2, 16, 16, 8, 3, 4, 2, ((1, 3), (1, 3)), None),
    ("k5s2_c16_n40", 1, 16, 16, 16, 40, 5, 2, ((2, 3), (2, 3)), None),
    ("k6s3_nine_phases", 1, 9, 9, 8, 8, 6, 3, ((2, 5), (2, 5)), None),
]


def tiled_conv_case(case, device):
    name, b, hp, wp, c, n, r, s, strides, dil, tile = case
    rng = np.random.default_rng(sum(map(ord, name)))
    x = torch.from_numpy(rng.standard_normal((b, hp, wp, c))
                         .astype(np.float32)).to(device)
    kern = torch.from_numpy(rng.standard_normal((r, s, c, n))
                            .astype(np.float32)).to(device)
    oh, ow = tk.single_out_hw(hp, wp, (r, s), strides, dil)
    if tile is None:
        tile = tk.pick_block_tile_single((oh, ow), (r, s), strides, dil, n)
    kw = dict(taps_hw=(r, s), strides=strides, rhs_dilation=dil,
              sp_tiles=tile)
    return x, kern, kern.reshape(r * s * c, n), kw


def tiled_deconv_case(case, device):
    name, b, h, w, c, n, k, s, pads, tile = case
    rng = np.random.default_rng(sum(map(ord, name)))
    x = torch.from_numpy(rng.standard_normal((b, h, w, c))
                         .astype(np.float32)).to(device)
    kern = torch.from_numpy(rng.standard_normal((k, k, c, n))
                            .astype(np.float32)).to(device)
    plan = plan_conv(conv_spec("transposed", x.shape, kern.shape,
                               strides=(s, s), padding=pads, backend="cuda"))
    packed = plan.pack(kern)
    if tile is None:
        tile = tk.pick_block_tile_transposed(plan.phases, n)
    kw = dict(phases=plan.phases, out_hw=plan.out_hw, strides=(s, s),
              sum_uv=plan.sum_uv, sp_tiles=tile)
    return plan, x, kern, pad_or_crop(x, plan.gpad), packed, kw


def _phase_bound(plan, x, kern, c):
    s = plan.spec.strides[0]
    y64, amax = ref.conv_oracle_f64(ref.zero_insert(x, (s, s)), kern,
                                    padding=plan.spec.padding)
    terms = torch.zeros(plan.out_hw, dtype=torch.float64, device=x.device)
    for ex in plan.phases:
        terms[ex.q[0]::s, ex.q[1]::s] = ex.taps[0] * ex.taps[1] * c
    return y64, ref.ulp_bound(y64, amax, terms[None, :, :, None])


@pytest.mark.parametrize("case", TILED_CONV_CASES,
                         ids=[c[0] for c in TILED_CONV_CASES])
def test_tiled_conv_kernel_within_ulp_bound_f32_and_int8(case, cuda_device):
    """Kernel C and its plain version within the f64 ULP bound on a
    NaN-poisoned output, two launches bit-equal; its int8 entry bit-equal
    to the f32 entry on the dequantized superpack (an all-zero row
    included), to its own second launch, and within the bound of the
    dequantized kernel."""
    _, b, hp, wp, c, n, r, s, strides, dil, _ = case
    x, kern, sp, kw = tiled_conv_case(case, cuda_device)
    torch.full((b * hp * wp * n,), float("nan"), device=cuda_device)
    launches = tk.untangled_conv2d_superpack.launches_tiled
    y = tk.untangled_conv2d_superpack(x, sp, **kw)
    torch.cuda.synchronize()
    assert tk.untangled_conv2d_superpack.launches_tiled == launches + 1
    torch.full((b * hp * wp * n,), float("nan"), device=cuda_device)
    assert torch.equal(tk.untangled_conv2d_superpack(x, sp, **kw), y)
    y_ref = tk.untangled_conv2d_superpack_tiled_ref(x, sp, **kw)
    y64, amax = ref.conv_oracle_f64(x, kern, strides=strides, dilation=dil)
    bound = ref.ulp_bound(y64, amax, r * s * c)
    assert bool(((y.double() - y64).abs() <= bound).all())
    assert bool(((y_ref.double() - y64).abs() <= bound).all())
    sp0 = sp.clone()
    sp0[c // 2] = 0.0
    q, scale, wd = _int8(sp0)
    launches = tk.untangled_conv2d_superpack.launches_tiled_int8
    torch.full((b * hp * wp * n,), float("nan"), device=cuda_device)
    y_i8 = tk.untangled_conv2d_superpack(x, q, scales=scale, **kw)
    y_f = tk.untangled_conv2d_superpack(x, wd, **kw)
    torch.cuda.synchronize()
    assert tk.untangled_conv2d_superpack.launches_tiled_int8 == launches + 1
    assert torch.equal(y_i8, y_f)
    torch.full((b * hp * wp * n,), float("nan"), device=cuda_device)
    assert torch.equal(
        tk.untangled_conv2d_superpack(x, q, scales=scale, **kw), y_i8)
    y64, amax = ref.conv_oracle_f64(x, wd.reshape(r, s, c, n),
                                    strides=strides, dilation=dil)
    bound = ref.ulp_bound(y64, amax, r * s * c)
    assert bool(((y_i8.double() - y64).abs() <= bound).all())


@pytest.mark.parametrize("case", TILED_DECONV_CASES,
                         ids=[c[0] for c in TILED_DECONV_CASES])
def test_tiled_deconv_kernel_within_ulp_bound_f32_and_int8(case,
                                                           cuda_device):
    """Kernel D as kernel C above (two launches bit-equal, f32 and int8);
    empty phases written as zeros."""
    _, b, h, w, c, n, k, s, pads, _ = case
    plan, x, kern, xg, packed, kw = tiled_deconv_case(case, cuda_device)
    numel = b * plan.out_hw[0] * plan.out_hw[1] * n
    torch.full((numel,), float("nan"), device=cuda_device)
    launches = tk.untangled_deconv2d.launches_tiled
    y = tk.untangled_deconv2d(xg, packed, **kw)
    torch.cuda.synchronize()
    assert tk.untangled_deconv2d.launches_tiled == launches + 1
    torch.full((numel,), float("nan"), device=cuda_device)
    assert torch.equal(tk.untangled_deconv2d(xg, packed, **kw), y)
    y_ref = tk.untangled_deconv2d(xg.cpu(), packed.cpu(), **kw)
    y64, bound = _phase_bound(plan, x, kern, c)
    assert bool(((y.double() - y64).abs() <= bound).all())
    assert bool(((y_ref.to(y64).double() - y64).abs() <= bound).all())
    for ex in plan.phases:
        if ex.taps[0] * ex.taps[1] == 0:
            assert not bool(y[:, ex.q[0]::s, ex.q[1]::s].ne(0).any())
    q, scale, wd = _int8(packed)
    launches = tk.untangled_deconv2d.launches_tiled_int8
    torch.full((numel,), float("nan"), device=cuda_device)
    y_i8 = tk.untangled_deconv2d(xg, q, scales=scale, **kw)
    y_f = tk.untangled_deconv2d(xg, wd, **kw)
    torch.cuda.synchronize()
    assert tk.untangled_deconv2d.launches_tiled_int8 == launches + 1
    assert torch.equal(y_i8, y_f)
    torch.full((numel,), float("nan"), device=cuda_device)
    assert torch.equal(tk.untangled_deconv2d(xg, q, scales=scale, **kw),
                       y_i8)
    y64, bound = _phase_bound(plan, x, plan.unpack(wd), c)
    assert bool(((y_i8.double() - y64).abs() <= bound).all())


def test_tiled_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    x = torch.randn((1, 40, 40, 8), device=cuda_device)
    sp = torch.randn((9 * 8, 8), device=cuda_device)
    with pytest.raises(ValueError, match="pixel"):
        tk.untangled_conv2d_superpack(x, sp, taps_hw=(3, 3),
                                      sp_tiles=(38, 38))
    with pytest.raises(NotImplementedError):
        tk.untangled_conv2d_superpack(x.clone().requires_grad_(), sp,
                                      taps_hw=(3, 3), sp_tiles=(8, 8))
    plan, _, _, xg, packed, kw = tiled_deconv_case(TILED_DECONV_CASES[0],
                                                   cuda_device)
    with pytest.raises(ValueError, match="CUDA"):
        tk.untangled_deconv2d(xg, packed.cpu(), **kw)


def test_unet_cuda_route_matches_torch_route(cuda_device):
    """A reduced U-Net at 64 px on the 'cuda' route against the 'torch'
    route on the same weights: every site one kernel launch."""
    import dataclasses
    from repro_torch.models import unet
    cfg = unet.UNetConfig("u", image_hw=64, base=16, time_dim=16,
                          backend="cuda")
    params = unet.unet_init(0, cfg, device=cuda_device)
    x = torch.randn((3, 64, 64, 3), generator=torch.Generator()
                    .manual_seed(2)).to(cuda_device)
    t = torch.tensor([0.1, 0.5, 0.9], device=cuda_device)
    before = (tk.untangled_deconv2d.launches
              + tk.untangled_conv2d_superpack.launches)
    with torch.inference_mode():
        y_cuda = unet.unet_apply(params, x, t, cfg)
        y_torch = unet.unet_apply(params, x, t, dataclasses.replace(
            cfg, backend="torch"))
        torch.cuda.synchronize()
    after = (tk.untangled_deconv2d.launches
             + tk.untangled_conv2d_superpack.launches)
    assert after - before == len(unet.unet_sites(cfg))
    scale = float(y_torch.abs().max())
    assert float((y_cuda - y_torch).abs().max()) <= 2e-4 * scale


# ---------------------------------------------------------------------------
# kernel F (flash attention)
# ---------------------------------------------------------------------------

# (name, b, sq, sk, h, kh, d, causal, window, q_offset, view): JAX's four
# test geometries (tests/test_flash_attention_kernel.py), ragged lengths,
# every instantiated head dim, a decode-style row past the start, windows
# that leave one row or some rows no visible key; then, for the bf16
# tensor-core entry, each head dim with GQA groups 1, 4 and 8, Sq and Sk
# that are multiples of neither query tile (64, 128) nor key chunk (32,
# 64), q_offset > 0, views whose rows are not 16-byte aligned (`view`:
# the scalar staging path), and the encoder-decoder's cross attention at
# decode (one query row over 3072 memory rows, non-causal)
FLASH_CASES = [
    ("jax_mha_d64", 1, 256, 256, 4, 4, 64, True, 0, 0, False),
    ("jax_gqa_d32", 2, 256, 256, 8, 2, 32, True, 0, 0, False),
    ("jax_mqa_window", 1, 512, 512, 4, 1, 64, True, 128, 0, False),
    ("jax_bidirectional", 1, 256, 256, 2, 2, 64, False, 0, 0, False),
    ("ragged_causal", 1, 1000, 1000, 8, 2, 64, True, 0, 0, False),
    ("ragged_noncausal_d128", 2, 77, 77, 4, 2, 128, False, 0, 0, False),
    ("ragged_cross_d32", 2, 37, 101, 4, 4, 32, False, 0, 0, False),
    ("decode_q_offset", 1, 1, 512, 8, 2, 64, True, 0, 300, False),
    ("block_q_offset_window", 2, 70, 200, 4, 2, 64, True, 48, 120, False),
    ("window_d256", 1, 300, 300, 4, 1, 256, True, 64, 0, False),
    ("no_visible_key", 1, 3, 40, 2, 1, 64, True, 8, 60, False),
    ("gqa8_offset_d32", 1, 130, 203, 16, 2, 32, True, 0, 73, False),
    ("gqa4_window_offset_d64", 2, 197, 333, 8, 2, 64, True, 40, 136, False),
    ("gqa1_offset_d128", 1, 150, 231, 4, 4, 128, True, 0, 81, False),
    ("gqa8_window_d256", 1, 141, 141, 8, 1, 256, True, 33, 0, False),
    ("some_rows_no_key_d128", 1, 70, 50, 4, 1, 128, True, 16, 40, False),
    ("some_rows_no_key_d64", 1, 300, 200, 2, 1, 64, True, 30, 60, False),
    ("unaligned_gqa4_d64", 1, 90, 90, 8, 2, 64, True, 0, 0, True),
    ("unaligned_window_d32", 2, 75, 120, 4, 4, 32, True, 24, 45, True),
    ("unaligned_noncausal_d128", 1, 33, 70, 8, 1, 128, False, 0, 0, True),
    ("unaligned_gqa8_d256", 1, 40, 40, 8, 1, 256, True, 0, 0, True),
    ("qwen2_7b_gqa7_d128", 1, 300, 300, 28, 4, 128, True, 0, 0, False),
    ("glm4_9b_gqa16_d128", 1, 200, 200, 32, 2, 128, True, 0, 0, False),
    ("qwen2_vl_gqa6_d128", 2, 150, 150, 12, 2, 128, True, 0, 0, False),
    ("recurrentgemma_gqa10_window_d256", 1, 600, 600, 10, 1, 256, True,
     256, 0, False),
    ("gemma3_global_d256", 1, 500, 500, 4, 1, 256, True, 0, 0, False),
    ("mla_d192", 1, 300, 300, 16, 16, 192, True, 0, 0, False),
    ("ragged_gqa4_offset_d192", 2, 99, 170, 8, 2, 192, True, 0, 71, False),
    ("window_noncausal_d192", 1, 70, 70, 4, 1, 192, False, 0, 0, False),
    ("unaligned_window_d192", 1, 85, 85, 4, 4, 192, True, 24, 0, True),
    ("s2t_cross_decode", 4, 1, 3072, 16, 16, 64, False, 0, 0, False),
]
# the f64 oracle and the plain version in f32: the test file's 2e-4; bf16:
# one bf16 rounding of the output (a relative 2^-7) above that
TOL_F32 = 2e-4
TOL_BF16_REL = 2.0 ** -7


def flash_inputs(case, device, dtype):
    """q, k, v from a per-case seed; with ``view``, each is the last D of a
    (.., D + 1) tensor, so no row starts 16-byte aligned."""
    name, b, sq, sk, h, kh, d = case[:7]
    view = case[10]
    gen = torch.Generator().manual_seed(sum(map(ord, name)))
    out = [torch.randn(shape[:3] + (shape[3] + view,), generator=gen)
           .to(device=device, dtype=dtype)
           for shape in ((b, sq, h, d), (b, sk, kh, d), (b, sk, kh, d))]
    return [t[..., 1:] for t in out] if view else out


def within(got, want, tol_abs, tol_rel=0.0):
    err = (got.double() - want.double()).abs()
    bound = tol_abs + tol_rel * want.double().abs()
    return bool((err <= bound).all()), float(err.max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_flash_kernel_matches_plain_and_f64_oracle(case, dtype, cuda_device):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_ref
    causal, window, q_offset = case[7:10]
    q, k, v = flash_inputs(case, cuda_device, getattr(torch, dtype))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    before = fa.flash_attention.launches
    torch.full((q.numel(),), float("nan"), device=cuda_device)
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    plain = fa.flash_attention_plain(q, k, v, **kw)
    oracle = flash_attention_ref(q.double(), k.double(), v.double(), **kw)
    rel = TOL_BF16_REL if dtype == "bfloat16" else 0.0
    for want in (plain, oracle):
        ok, err = within(got, want, TOL_F32, rel)
        assert ok, err


def test_flash_kernel_scalar_path_on_unaligned_views(cuda_device):
    """Views whose rows are not 16-byte aligned take the scalar loads."""
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator().manual_seed(5)
    big = [torch.randn((1, 90, 4, 65), generator=gen).to(cuda_device)
           for _ in range(3)]
    q, k, v = (t[..., 1:] for t in big)
    got = fa.flash_attention(q, k, v, causal=True)
    want = fa.flash_attention_plain(q, k, v, causal=True)
    ok, err = within(got, want, TOL_F32)
    assert ok, err


def test_flash_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    from repro_torch.kernels import flash_attention as fa
    q = torch.randn((1, 8, 2, 48), device=cuda_device)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention(q, q, q)
    q = torch.randn((1, 8, 2, 64), device=cuda_device)
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(NotImplementedError):
        fa.flash_attention(q.requires_grad_(), q, q)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q.detach(), q.detach().cpu(), q.detach().cpu())


def test_llama_prefill_launches_kernel_f_once_per_layer(cuda_device):
    """The full-width llama3.2-1b prefill (bf16, S = 256) launches kernel F
    16 times, once per layer, and gives finite logits."""
    from repro_torch.configs import registry
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer as tfm
    cfg = registry.get_config("llama3.2-1b")
    params = tfm.init(cfg, seed=0, device=cuda_device)
    toks = torch.randint(0, cfg.vocab_size, (2, 256),
                         generator=torch.Generator().manual_seed(1))
    before = fa.flash_attention.launches
    logits = make_prefill_step(cfg)(params, {"inputs": toks.to(cuda_device)})
    torch.cuda.synchronize()
    assert fa.flash_attention.launches - before == cfg.num_layers
    assert logits.shape == (2, cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all())


# the LM families (reduced widths): F launches a prefill, one an attention
# layer of each kind (attn, local, global, moe, mla, mla_moe; none for rec
# and ssd)
FAMILY_ATTENTION_LAYERS = (("gemma3-1b", 3), ("qwen2-7b", 2), ("glm4-9b", 2),
                           ("qwen2-vl-2b", 2), ("recurrentgemma-2b", 1),
                           ("mamba2-130m", 0), ("dbrx-132b", 2),
                           ("deepseek-v3-671b", 3))


@pytest.mark.parametrize("arch,n_attn", FAMILY_ATTENTION_LAYERS,
                         ids=[a for a, _ in FAMILY_ATTENTION_LAYERS])
def test_family_prefill_launches_kernel_f_once_per_attention_layer(
        arch, n_attn, cuda_device):
    """The reduced config's bf16 prefill at S = 100 (past the reduced
    window of 8) launches F once an attention layer, and its logits are
    finite and within 3e-2·max|logits| of the plain attention route's.
    A reduced head dim of 16 (below F's smallest, 32) is doubled, with
    the M-RoPE sections; MLA's q·k dim of 16 + 8 takes deepseek's 128 +
    64 (F's D = 192)."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.layers import attention
    from repro_torch.models import transformer as tfm
    cfg = registry.get_reduced(arch)
    if cfg.use_mla:
        cfg = dataclasses.replace(cfg, qk_nope_dim=128, qk_rope_dim=64,
                                  v_head_dim=32)
    elif n_attn and cfg.head_dim not in fa.HEAD_DIMS:
        cfg = dataclasses.replace(
            cfg, head_dim=2 * cfg.head_dim, mrope_sections=cfg.mrope_sections
            and tuple(2 * n for n in cfg.mrope_sections))
    params = tfm.init(cfg, seed=0, device=cuda_device)
    toks = torch.randint(0, cfg.vocab_size, (2, 100),
                         generator=torch.Generator().manual_seed(2))
    batch = {"inputs": toks.to(cuda_device)}
    prefill = make_prefill_step(cfg)
    before = fa.flash_attention.launches
    logits = prefill(params, batch)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches - before == n_attn
    assert bool(torch.isfinite(logits).all())
    core = attention.flash_attention
    attention.flash_attention = (
        lambda q, k, v, *, kv_chunk=1024, **kw: fa.flash_attention_plain(
            q, k, v, ck=kv_chunk, **kw))
    try:
        plain = prefill(params, batch)
    finally:
        attention.flash_attention = core
    v = cfg.vocab_size
    err = float((logits[:, :v] - plain[:, :v]).abs().max())
    assert err <= 3e-2 * float(plain[:, :v].abs().max())


@pytest.mark.parametrize("arch", ["gemma3-1b", "recurrentgemma-2b",
                                  "mamba2-130m"])
def test_decode_graphs_give_the_eager_tokens_on_state_caches(arch,
                                                             cuda_device):
    """The slot graphs over the local-KV, RG-LRU and SSD caches, whose
    decode writes the recurrent state in place: 6 requests over 4 slots
    (two slots recycled) give the eager batcher's tokens and each
    request's lone run's; a replayed graph that left its state unchanged
    would repeat the first step's state."""
    from repro_torch.configs import registry
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.batcher import ContinuousBatcher, Request
    cfg = registry.get_reduced(arch)
    params = tfm.init(cfg, seed=0, device=cuda_device)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, p)
               for p in (3, 5, 2, 12, 6, 3)]

    def run(slots, graphs, ids):
        cb = ContinuousBatcher(cfg, params, slots=slots, max_len=24,
                               device=cuda_device, graphs=graphs)
        for i in ids:
            cb.submit(Request(rid=i, prompt=prompts[i], max_new=8))
        cb.run()
        return {r.rid: r.out for r in cb.done}
    ids = range(len(prompts))
    graphed = run(4, True, ids)
    assert graphed == run(4, False, ids)
    for i in ids:
        assert run(1, True, [i])[i] == graphed[i]
    assert all(len(o) == 8 for o in graphed.values())


def _mla_cfg():
    """The reduced deepseek-v3-671b at MLA's published q·k dims (128 + 64:
    F's D = 192) and v dim 128, 8 heads."""
    import dataclasses

    from repro_torch.configs import registry
    return dataclasses.replace(registry.get_reduced("deepseek-v3-671b"),
                               num_heads=8, num_kv_heads=8, qk_nope_dim=128,
                               qk_rope_dim=64, v_head_dim=128,
                               kv_lora_rank=64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_layer_on_kernel_f(dtype, cuda_device):
    """One MLA prefill layer (S = 300) launches F once at D = 192 (bf16
    on the tensor cores, f32 on FFMA) and agrees with the plain attention
    core on the same weights: f32 within 1e-4·max|y|, bf16 within
    3e-2·max|y|."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.layers import attention
    cfg = _mla_cfg()
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    p = attention.mla_init(gen, cfg, dt)
    x = torch.randn((2, 300, cfg.d_model), generator=gen,
                    device=cuda_device).to(dt)
    pos = torch.arange(300, device=cuda_device)[None].expand(2, 300)
    before = fa.flash_attention.launches
    got = attention.mla_apply(p, x, cfg, positions=pos)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    core = attention.flash_attention
    attention.flash_attention = (
        lambda q, k, v, *, kv_chunk=1024, **kw: fa.flash_attention_plain(
            q, k, v, ck=kv_chunk, **kw))
    try:
        want = attention.mla_apply(p, x, cfg, positions=pos)
    finally:
        attention.flash_attention = core
    err = float((got.float() - want.float()).abs().max())
    tol = 1e-4 if dtype == "float32" else 3e-2
    assert err <= tol * float(want.float().abs().max()), err


@pytest.mark.parametrize("arch", ["dbrx-132b", "deepseek-v3-671b"])
def test_moe_forms_on_the_card(arch, cuda_device):
    """bf16 experts on the card: ``moe_apply`` (sorted by expert) and
    ``moe_decode`` (gathered, the form a graph captures) each within one
    bf16 step (2^-7 of max|y|) of the f32 all-experts combine
    ``moe_apply_dense``; ``moe_decode`` captured in a CUDA graph gives its
    eager bits, on new tokens after each replay."""
    from repro_torch.configs import registry
    from repro_torch.layers import moe
    cfg = registry.get_reduced(arch)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    p = moe.moe_init(gen, cfg)
    x = torch.randn((3, 40, cfg.d_model), generator=gen,
                    device=cuda_device).to(torch.bfloat16)
    want = moe.moe_apply_dense(p, x.float(), cfg)
    for fn in (moe.moe_apply, moe.moe_decode):
        got = fn(p, x, cfg)
        assert got.dtype == torch.bfloat16
        err = float((got.float() - want).abs().max())
        assert err <= 2.0 ** -7 * float(want.abs().max()), (fn, err)
    static = x[:, :1].clone()
    with torch.no_grad():
        moe.moe_decode(p, static, cfg)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = moe.moe_decode(p, static, cfg)
    for t in range(3):
        static.copy_(x[:, t:t + 1])
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, moe.moe_decode(p, x[:, t:t + 1], cfg))


@pytest.mark.parametrize("arch", ["dbrx-132b", "deepseek-v3-671b"])
def test_moe_decode_graphs_give_the_eager_tokens(arch, cuda_device):
    """The slot graphs over MoE decode (and MLA's compressed cache at
    deepseek): 6 requests over 4 slots give the eager batcher's tokens and
    each request's lone run's, with no kernel-F launch captured."""
    from repro_torch.configs import registry
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.batcher import ContinuousBatcher, Request
    cfg = registry.get_reduced(arch)
    params = tfm.init(cfg, seed=0, device=cuda_device)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, p)
               for p in (3, 5, 2, 9, 6, 3)]

    def run(slots, graphs, ids):
        cb = ContinuousBatcher(cfg, params, slots=slots, max_len=20,
                               device=cuda_device, graphs=graphs)
        for i in ids:
            cb.submit(Request(rid=i, prompt=prompts[i], max_new=6))
        cb.run()
        assert all("F" not in g.kernels for g in cb.graphs)
        return {r.rid: r.out for r in cb.done}
    ids = range(len(prompts))
    graphed = run(4, True, ids)
    assert graphed == run(4, False, ids)
    for i in ids:
        assert run(1, True, [i])[i] == graphed[i]


# ---------------------------------------------------------------------------
# the LM's dense products on the card
# ---------------------------------------------------------------------------

def f32_sum_bound(x, w):
    """The rounding error of an f32 sum of x @ w's K products (each exact
    in f32 for bf16 operands): gamma_K * sum |x||w|, gamma_K = K u / (1 -
    K u), u = 2^-24, in float64."""
    k = x.shape[-1]
    gamma = k * 2.0 ** -24 / (1 - k * 2.0 ** -24)
    return gamma * (x.double().abs() @ w.double().abs())


def test_tied_readout_returns_f32_logits_on_the_card(cuda_device):
    """llama3.2-1b's tied readout (V = 128256, D = 2048) in bf16: the
    logits are the f32 sum itself, within f32 accumulation error of the
    f64 product, and not rounded to bf16 on the way."""
    from repro_torch.configs import registry
    from repro_torch.layers import common as cm
    cfg = registry.get_config("llama3.2-1b")
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    p = cm.embed_init(gen, cfg.vocab_size, cfg.d_model)
    x = torch.randn((2, 3, cfg.d_model), generator=gen, device=cuda_device
                    ).to(torch.bfloat16)
    y = cm.embed_logits(p, x)
    assert y.dtype == torch.float32 and y.shape == (2, 3, cfg.vocab_size)
    w = p["w"].t()
    want = x.double() @ w.double()
    err = (y.double() - want).abs()
    assert bool((err <= f32_sum_bound(x, w)).all()), float(err.max())
    assert bool((y.to(torch.bfloat16).float() != y).any())


# llama3.2-1b's dense products (in, out): q and o, k and v, the MLP's gate
# and up, its down
LLAMA_DENSE = ((2048, 2048), (2048, 512), (2048, 8192), (8192, 2048))


@pytest.mark.parametrize("reduced", [False, True],
                         ids=["bf16_reduction_off", "bf16_reduction_on"])
@pytest.mark.parametrize("rows", [4, 4096])
def test_dense_apply_accumulates_in_f32(rows, reduced, cuda_device):
    """``dense_apply`` in bf16 at llama3.2-1b's widths, with cuBLAS allowed
    (or not) to reduce bf16 partial sums in bf16
    (``allow_bf16_reduced_precision_reduction``): every output is the f64
    product within f32 accumulation error plus one bf16 rounding."""
    from repro_torch.layers import common as cm
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    gen = torch.Generator(device=cuda_device).manual_seed(rows)
    try:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            reduced
        for d_in, d_out in LLAMA_DENSE:
            p = cm.dense_init(gen, d_in, d_out)
            x = torch.randn((rows, d_in), generator=gen, device=cuda_device
                            ).to(torch.bfloat16)
            y = cm.dense_apply(p, x)
            assert y.dtype == torch.bfloat16
            want = x.double() @ p["w"].double()
            e = f32_sum_bound(x, p["w"])
            # half a bf16 step at |want| + e: 2^(floor(log2 a) - 8)
            half = torch.exp2(torch.floor(torch.log2(want.abs() + e)) - 8)
            err = (y.double() - want).abs()
            assert bool((err <= e + half).all()), (d_in, d_out,
                                                   float(err.max()))
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            flag


# ---------------------------------------------------------------------------
# CUDA graphs: one per image bucket (DynamicImageBatcher) and per decode
# slot (ContinuousBatcher)
# ---------------------------------------------------------------------------

def image_models(device):
    """(name, serve fn, proto row, kernel counter, launches a forward) of
    the Table-1 DCGAN generator and SEGNET_TINY in f32 and int8, all on
    the 'cuda' route."""
    import dataclasses
    from repro_torch.models import gan, segnet
    gcfg = gan.GANConfig("dcgan", gan.DCGAN_LAYERS, backend="cuda")
    gp = gan.generator_init(0, gcfg, device=device)
    out = [("dcgan", lambda z: gan.generator_apply(gp, z, gcfg),
            np.zeros((gcfg.z_dim,), np.float32), "A", 4)]
    for wdtype in ("float32", "int8"):
        scfg = dataclasses.replace(segnet.SEGNET_TINY, backend="cuda",
                                   wdtype=wdtype)
        sp = segnet.segnet_init(0, scfg, device=device)
        out.append((f"segnet_{wdtype}",
                    lambda x, p=sp, c=scfg: torch.argmax(
                        segnet.segnet_apply(p, x, c), dim=-1),
                    np.zeros((scfg.in_hw, scfg.in_hw, scfg.in_c), np.float32),
                    "B" if wdtype == "float32" else "B_int8", 10))
    return out


def test_bucket_graphs_bit_equal_to_eager_and_count_their_launches(
        cuda_device):
    """Every bucket's graph replay is bit-equal to the eager forward on the
    same padded batch; a capture records 4 kernel-A (10 kernel-B or B-int8)
    launches; a replay after the static input is overwritten answers the
    new rows; the launches of the replays are captured count x replays;
    the route cache keeps graph costs under their own key."""
    from repro_torch.serving.image_batcher import DynamicImageBatcher
    rng = np.random.default_rng(0)
    for name, fn, proto, kernel, per_forward in image_models(cuda_device):
        b = DynamicImageBatcher(fn, device=cuda_device)
        assert b.cache_key is None and b.graphed
        # graph-measured bucket costs never mix with eager ones
        assert DynamicImageBatcher(fn, device=cuda_device, cache_key=name
                                   ).cache_key == f"{name}/cuda-graph"
        b.warmup(proto, iters=1)
        assert sorted(b.graphs) == list(b.buckets)
        for bucket, g in b.graphs.items():
            assert g.kernels == {kernel: per_forward}, (name, bucket)
            for n in sorted({1, max(1, bucket // 2), bucket}):
                rows = rng.uniform(-1, 1, (n,) + proto.shape).astype(
                    np.float32)
                got = b.execute(list(rows), bucket)
                pad = np.zeros((bucket,) + proto.shape, np.float32)
                pad[:n] = rows
                with torch.inference_mode():
                    want = fn(torch.from_numpy(pad).to(cuda_device))
                np.testing.assert_array_equal(got, want[:n].cpu().numpy())
        assert b.graph_launches() == {
            kernel: per_forward * len(b.launches)}


def test_decode_graphs_give_the_eager_tokens(cuda_device):
    """One graph a slot: the greedy tokens of 6 requests over 4 slots
    equal the eager batcher's (``graphs=False``) on the same prompts; a
    capture records no kernel-F launch (decode attends densely)."""
    from repro_torch.configs import registry
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.batcher import ContinuousBatcher, Request
    cfg = registry.get_reduced("llama3.2-1b")
    params = tfm.init(cfg, seed=0, device=cuda_device)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, p) for p in (3, 5, 2, 4, 6, 3)]
    outs = {}
    for graphs in (True, False):
        cb = ContinuousBatcher(cfg, params, slots=4, max_len=16,
                               device=cuda_device, graphs=graphs)
        for i, p in enumerate(prompts):
            cb.submit(Request(rid=i, prompt=p, max_new=5))
        cb.run()
        outs[graphs] = {r.rid: r.out for r in cb.done}
        if graphs:
            assert len(cb.graphs) == 4
            assert all(g.kernels == {} for g in cb.graphs)
        else:
            assert cb.graphs == []
    assert outs[True] == outs[False]
    assert all(len(o) == 5 for o in outs[True].values())


def test_bucket_graph_capture_error_raises_without_fallback(cuda_device):
    """A serve function that syncs with the host cannot be captured: the
    batcher raises and never answers from an eager run.  (Last in the
    file: a failed capture is the one test that leaves the stream's
    capture state to the driver's recovery.)"""
    from repro_torch.serving.image_batcher import DynamicImageBatcher

    def syncing(x):
        return x * float(x.sum().item() * 0 + 2)   # a host sync

    b = DynamicImageBatcher(syncing, buckets=(1, 4), device=cuda_device)
    with pytest.raises(RuntimeError):
        b.warmup(np.zeros((3,), np.float32))
    with pytest.raises(RuntimeError):
        b.execute([np.ones((3,), np.float32)], 1)
    assert not b.launches and not b.graphs


# ---------------------------------------------------------------------------
# training: the tied readout's and the attention core's backward, the
# encoder-decoder on kernel F, the train step
# ---------------------------------------------------------------------------

def test_tied_readout_gradients_against_f32_products(cuda_device):
    """``embed_logits`` under autograd on the card (``mm_f32``): the
    forward bits of the no-grad path, and the gradients of x and w equal
    to the f32 products of the f32 cotangent with the operands cast up,
    each rounded once to bf16."""
    from repro_torch.layers import common as cm
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    w = (torch.randn((3000, 256), generator=gen, device=cuda_device)
         * 0.06).to(torch.bfloat16)
    x = torch.randn((2, 7, 256), generator=gen, device=cuda_device).to(
        torch.bfloat16)
    g = torch.randn((2, 7, 3000), generator=gen, device=cuda_device)
    with torch.no_grad():
        y0 = cm.embed_logits({"w": w}, x)
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = cm.embed_logits({"w": wr}, xr)
    assert y.dtype == torch.float32 and torch.equal(y.detach(), y0)
    dx, dw = torch.autograd.grad(y, (xr, wr), g)
    g2 = g.reshape(-1, 3000)
    want_dx = (g2 @ w.float()).to(torch.bfloat16).reshape(x.shape)
    want_dw = (g2.t() @ x.reshape(-1, 256).float()).to(torch.bfloat16)
    assert dx.dtype == dw.dtype == torch.bfloat16
    for got, want in ((dx, want_dx), (dw, want_dw)):
        err = float((got.float() - want.float()).abs().max())
        assert err <= 2.0 ** -8 * float(want.float().abs().max()), err


# (name, b, sq, sk, h, kh, d, causal, window, q_offset, kv_chunk)
FLASH_GRAD_CASES = [
    ("causal", 2, 200, 200, 4, 4, 64, True, 0, 0, 64),
    ("window", 1, 300, 300, 4, 2, 64, True, 48, 0, 128),
    ("ragged_noncausal", 2, 77, 150, 4, 4, 128, False, 0, 0, 64),
    ("gqa_offset", 1, 64, 256, 8, 2, 32, True, 0, 192, 100),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_GRAD_CASES,
                         ids=[c[0] for c in FLASH_GRAD_CASES])
def test_flash_function_gradients_against_f64_oracle(case, dtype,
                                                     cuda_device):
    """The attention core under autograd on the card: kernel F forward
    (one launch), the chunked backward's dQ, dK and dV against
    ``torch.autograd`` through the dense f64 oracle on f64 copies of the
    same inputs, each within 1e-4 (f32) or 2^-6 (bf16: the output O that
    delta reads and the gradients are rounded to bf16) of the oracle
    gradient's largest magnitude."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.layers import attention
    name, b, sq, sk, h, kh, d, causal, window, q_offset, ck = case
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(sum(map(ord, name)))
    q, k, v = (torch.randn(s, generator=gen).to(cuda_device, dt)
               for s in ((b, sq, h, d), (b, sk, kh, d), (b, sk, kh, d)))
    do = torch.randn((b, sq, h, d), generator=gen).to(cuda_device, dt)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    before = fa.flash_attention.launches
    o = attention.flash_attention(*ins, kv_chunk=ck, **kw)
    assert fa.flash_attention.launches - before == 1
    got = torch.autograd.grad(o, ins, do)
    ref = [t.double().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(flash_attention_ref(*ref, **kw), ref,
                               do.double())
    tol = 1e-4 if dtype == "float32" else 2.0 ** -6
    for n, g, w in zip("qkv", got, want):
        assert g.dtype == dt
        err = float((g.double() - w).abs().max())
        assert err <= tol * float(w.abs().max()), (n, err)


def _encdec_cfg():
    """The reduced seamless-m4t-large-v2 at head dim 32 (F's smallest)."""
    import dataclasses

    from repro_torch.configs import registry
    return dataclasses.replace(
        registry.get_reduced("seamless-m4t-large-v2"), head_dim=32)


def test_encdec_prefill_and_slot_graphs_on_kernel_f(cuda_device):
    """The encoder-decoder in bf16: a prefill over 40 source frames
    launches F once at each encoder layer and twice at each decoder layer
    (self and cross attention), its logits within 3e-2·max|logits| of the
    plain attention route's; the slot graphs over one encoded memory
    record one F launch a decoder layer and give the eager batcher's
    tokens."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.layers import attention
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.batcher import ContinuousBatcher, Request
    cfg = _encdec_cfg()
    params = tfm.init(cfg, seed=0, device=cuda_device)
    gen = torch.Generator().manual_seed(6)
    batch = {"inputs": torch.randint(0, cfg.vocab_size, (2, 24),
                                     generator=gen).to(cuda_device),
             "src_embeds": torch.randn((2, 40, cfg.d_model), generator=gen
                                       ).to(cuda_device, torch.bfloat16)}
    prefill = make_prefill_step(cfg)
    before = fa.flash_attention.launches
    logits = prefill(params, batch)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches - before == 2 + 2 * 2
    core = attention.flash_attention
    attention.flash_attention = (
        lambda q, k, v, *, kv_chunk=1024, **kw: fa.flash_attention_plain(
            q, k, v, ck=kv_chunk, **kw))
    try:
        plain = prefill(params, batch)
    finally:
        attention.flash_attention = core
    v = cfg.vocab_size
    assert bool(torch.isfinite(logits).all())
    err = float((logits[:, :v] - plain[:, :v]).abs().max())
    assert err <= 3e-2 * float(plain[:, :v].abs().max())
    with torch.no_grad():
        memory = tfm.encode(params, batch["src_embeds"][:1], cfg)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, p) for p in (3, 5, 2, 4, 6)]
    outs = {}
    for graphs in (True, False):
        cb = ContinuousBatcher(cfg, params, slots=4, max_len=16,
                               memory=memory, device=cuda_device,
                               graphs=graphs)
        for i, p in enumerate(prompts):
            cb.submit(Request(rid=i, prompt=p, max_new=5))
        cb.run()
        outs[graphs] = {r.rid: r.out for r in cb.done}
        if graphs:
            assert all(g.kernels == {"F": 2} for g in cb.graphs)
    assert outs[True] == outs[False]


def test_train_step_on_kernel_f_under_remat(cuda_device):
    """Three AdamW steps of the reduced llama3.2-1b (head dim 32) in bf16
    on one batch: F launches twice an attention layer a step (the forward
    and its recomputation under remat), the loss is finite and falls."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import steps
    from repro_torch.launch.train import build_state
    from repro_torch.train.data import TokenPipeline
    cfg = dataclasses.replace(registry.get_reduced("llama3.2-1b"),
                              head_dim=32)
    state, opt_cfg = build_state(cfg, device=cuda_device)
    step = steps.make_train_step(cfg, opt_cfg, kv_chunk=32)
    batch = TokenPipeline(cfg, 4, 64).batch_at(0)
    losses = []
    for _ in range(3):
        before = fa.flash_attention.launches
        state, m = step(state, batch)
        torch.cuda.synchronize()
        assert fa.flash_attention.launches - before == 2 * cfg.num_layers
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
