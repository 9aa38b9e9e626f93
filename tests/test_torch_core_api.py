"""The rest of ``repro_torch.core`` and ``repro_torch.kernels`` against
the JAX package on the same numpy inputs: the Fig. 8 traffic models equal
to JAX's to the byte at the fig7, fig8 and dilated-bench geometries; the
naive ``_pre`` engine, ``precompute_transposed_weights`` and
``huge_conv_transpose2d_pre`` (the port of ``tests/test_precomputed_
engine.py``); ``untangled_conv2d`` fused and per tap and
``untangled_depthwise_conv1d``; ``apply_per_phase`` f32 and int8; the
HWIO kernel entries of ``kernels/ops`` and the library oracle of
``kernels/ref``; the public names of ``repro_torch.core``; and the
``quickstart`` and ``segment`` CLIs in process."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from benchmarks.dilated_conv import LAYERS as DILATED_LAYERS
from repro.core import engine as jengine
from repro.core import plan as jplan
from repro.core import reference as jref
from repro.core import untangle as juntangle
from repro.kernels import ops as jops
from repro.kernels import ref as jkref
from repro.models import gan as jgan
from repro.models import vae as jvae
import repro_torch.core as tcore
from repro_torch import quickstart, segment
from repro_torch.core import engine as tengine
from repro_torch.core import plan as tplan
from repro_torch.core import reference as tref
from repro_torch.core import untangle as tuntangle
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tkref

from tests.conftest import TOL_FWD, assert_close


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


# the fig7 (DCGAN, cGAN, VAE decoder) and fig8 (DCGAN, cGAN) layers
FIG_LAYERS = [(f"{tag}_DC{i + 1}", l) for tag, layers in (
    ("DCGAN", jgan.DCGAN_LAYERS), ("cGAN", jgan.CGAN_LAYERS),
    ("VAE", jvae.VAE.decoder_layers)) for i, l in enumerate(layers)]


def _spec(cls, l, backend):
    return cls(kind="transposed", in_hw=(l.in_hw, l.in_hw), in_c=l.in_c,
               out_c=l.out_c, kernel_hw=(l.kernel, l.kernel),
               strides=(l.stride, l.stride),
               padding=jgan.deconv_padding(l.kernel, l.stride),
               backend=backend)


def rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


@pytest.mark.parametrize("name,l", FIG_LAYERS, ids=[n for n, _ in FIG_LAYERS])
def test_transpose_traffic_models_equal_jax(name, l):
    args = (l.in_hw, l.in_hw, l.in_c, l.kernel, l.kernel, l.out_c, l.stride)
    jp = jplan.plan_conv(_spec(jplan.ConvSpec, l, "xla"))
    tp = tplan.plan_conv(_spec(tplan.ConvSpec, l, "torch"))
    for b in (1, 4, 64):
        for fn in ("bytes_naive_transpose", "bytes_huge_transpose",
                   "memory_reduction_transpose"):
            assert getattr(tref, fn)(b, *args) == getattr(jref, fn)(b, *args)
        assert tref.bytes_planned_transpose(tp, b=b) == \
            jref.bytes_planned_transpose(jp, b=b)
    assert tref.bytes_huge_transpose(1, *args, itemsize=2) == \
        jref.bytes_huge_transpose(1, *args, itemsize=2)


@pytest.mark.parametrize("h,c,n,k,d", DILATED_LAYERS)
def test_single_traffic_models_equal_jax(h, c, n, k, d):
    pad = (d * (k - 1) // 2,) * 2
    specs = [cls(kind="dilated", in_hw=(h, h), in_c=c, out_c=n,
                 kernel_hw=(k, k), padding=(pad, pad), dilation=(d, d),
                 backend=b) for cls, b in ((jplan.ConvSpec, "xla"),
                                           (tplan.ConvSpec, "torch"))]
    jp, tp = jplan.plan_conv(specs[0]), tplan.plan_conv(specs[1])
    for b in (1, 16):
        assert tref.bytes_planned_single(tp, b=b) == \
            jref.bytes_planned_single(jp, b=b)
        assert tref.bytes_naive_dilated(b, h, h, c, k, k, n, tp.out_hw,
                                        (d, d)) == \
            jref.bytes_naive_dilated(b, h, h, c, k, k, n, jp.out_hw, (d, d))


PRE_CASES = [(4, 5, 2, (2, 3)), (8, 4, 2, (1, 2)), (5, 3, 3, (0, 0)),
             (6, 3, 1, (1, 1)), (8, 4, 2, (1, 3))]


@pytest.mark.parametrize("h,r,stride,pad", PRE_CASES)
def test_precomputed_engine_matches_jax(h, r, stride, pad):
    """``precompute_transposed_weights`` bit-equal to JAX's, phase for
    phase; ``huge_conv_transpose2d_pre`` through the plan's superpack and
    the naive ``_pre`` engine against JAX's engine and oracle."""
    x, k = rand(h, 2, h, h + 1, 6), rand(r, r, r, 6, 8)
    pads, strides = (pad, pad), (stride, stride)
    jsubs = jengine.precompute_transposed_weights(jnp.asarray(k), strides,
                                                  pads)
    tsubs = tengine.precompute_transposed_weights(torch.from_numpy(k),
                                                  strides, pads)
    assert set(tsubs) == set(jsubs)
    for q, sub in tsubs.items():
        np.testing.assert_array_equal(sub.numpy(), np.asarray(jsubs[q]))
    want = np.asarray(jref.oracle_conv_transpose2d(
        jnp.asarray(x), jnp.asarray(k), strides=strides, padding=pads))
    got = tengine.huge_conv_transpose2d_pre(torch.from_numpy(x), tsubs,
                                            (r, r), strides, pads)
    assert_close(got, np.asarray(jengine.huge_conv_transpose2d_pre(
        jnp.asarray(x), jsubs, (r, r), strides, pads)), TOL_FWD)
    assert_close(got, want, TOL_FWD)
    naive = tref.naive_conv_transpose2d_pre(
        torch.from_numpy(x), torch.from_numpy(k).reshape(r * r * 6, 8),
        (r, r), strides=strides, padding=pads)
    assert_close(naive, np.asarray(jref.naive_conv_transpose2d_pre(
        jnp.asarray(x), jnp.asarray(k).reshape(r * r * 6, 8), (r, r),
        strides=strides, padding=pads)), TOL_FWD)
    assert_close(naive, want, TOL_FWD)


UNTANGLE_CASES = [
    # (name, x shape, kernel (r, s), strides, padding, rhs_dilation)
    ("same_3x3", (2, 9, 9, 5), (3, 3), (1, 1), ((1, 1), (1, 1)), (1, 1)),
    ("strided_k4s2", (2, 16, 16, 3), (4, 4), (2, 2), ((2, 1), (2, 1)),
     (1, 1)),
    ("dilated_d2", (1, 12, 11, 4), (3, 3), (1, 1), ((2, 2), (2, 2)), (2, 2)),
    ("cropped", (2, 10, 10, 4), (3, 2), (2, 1), ((-1, 1), (0, -2)), (1, 1)),
    ("big_plane", (1, 20, 20, 3), (3, 3), (1, 1), ((1, 1), (1, 1)), (1, 1)),
]


@pytest.mark.parametrize("fuse_taps", [None, True, False])
@pytest.mark.parametrize("name,xs,ks,strides,padding,dil", UNTANGLE_CASES,
                         ids=[c[0] for c in UNTANGLE_CASES])
def test_untangled_conv2d_matches_jax(name, xs, ks, strides, padding, dil,
                                      fuse_taps):
    x, k = rand(len(name), *xs), rand(3, *ks, xs[-1], 7)
    want = np.asarray(juntangle.untangled_conv2d(
        jnp.asarray(x), jnp.asarray(k), strides=strides, padding=padding,
        rhs_dilation=dil, fuse_taps=fuse_taps))
    got = tuntangle.untangled_conv2d(
        torch.from_numpy(x), torch.from_numpy(k), strides=strides,
        padding=padding, rhs_dilation=dil, fuse_taps=fuse_taps)
    assert got.shape == want.shape
    assert_close(got, want, TOL_FWD)
    assert_close(got, np.asarray(jkref.untangled_conv2d_ref(
        jnp.asarray(x), jnp.asarray(k), strides=strides, padding=padding,
        rhs_dilation=dil)), TOL_FWD)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("k", [1, 4, 5])
def test_untangled_depthwise_conv1d_matches_jax(causal, k):
    x, w = rand(k, 2, 3, 11, 6), rand(k + 1, k, 6)
    want = np.asarray(juntangle.untangled_depthwise_conv1d(
        jnp.asarray(x), jnp.asarray(w), causal=causal))
    got = tuntangle.untangled_depthwise_conv1d(
        torch.from_numpy(x), torch.from_numpy(w), causal=causal)
    assert got.shape == want.shape
    assert_close(got, want, 1e-6)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("wdtype", ["float32", "int8"])
@pytest.mark.parametrize("name,l", [FIG_LAYERS[5], FIG_LAYERS[7]],
                         ids=["cGAN_DC2", "VAE_DC2"])
def test_apply_per_phase_matches_jax(name, l, wdtype, backend):
    """``apply_per_phase`` on JAX's superpack against JAX's (its 'xla'
    per-phase policy; on 'cuda' each phase is kernel B's plain version),
    and against the fused ``apply`` of the same plan.  JAX's
    ``apply_per_phase`` does not dequantize an int8 superpack (it fails to
    trace one), so an int8 plan is held to JAX's f32 plan on the
    dequantized rows."""
    jspec = dataclasses.replace(_spec(jplan.ConvSpec, l, "xla"),
                                wdtype=wdtype)
    tspec = dataclasses.replace(_spec(tplan.ConvSpec, l, backend),
                                wdtype=wdtype)
    jp, tp = jplan.plan_conv(jspec), tplan.plan_conv(tspec)
    x = rand(1, 2, l.in_hw, l.in_hw, l.in_c)
    k = rand(2, l.kernel, l.kernel, l.in_c, l.out_c) * 0.1
    jpacked = jp.pack(jnp.asarray(k))
    if wdtype == "int8":
        want = np.asarray(jplan.plan_conv(dataclasses.replace(
            jspec, wdtype="float32")).apply_per_phase(
                jnp.asarray(x), jpacked.dequant()))
    else:
        want = np.asarray(jp.apply_per_phase(jnp.asarray(x), jpacked))
    packed = tplan.QuantizedSuperpack(
        torch.from_numpy(np.array(jpacked.q)),
        torch.from_numpy(np.array(jpacked.scale))) \
        if wdtype == "int8" else torch.from_numpy(np.array(jpacked))
    with torch.no_grad():
        got = tp.apply_per_phase(torch.from_numpy(x), packed)
        fused = tp.apply(torch.from_numpy(x), packed)
    assert_close(got, want, TOL_FWD)
    assert_close(got, fused, TOL_FWD)


@pytest.mark.parametrize("wdtype", ["float32", "int8"])
@pytest.mark.parametrize("hw,c,n,tiled", [(16, 64, 3, False),
                                          (384, 8, 8, True)],
                         ids=["VAE_DC2", "plane384"])
def test_per_phase_cuda_is_one_kernel_launch_a_phase(monkeypatch, hw, c, n,
                                                     tiled, wdtype):
    """On the 'cuda' policy every live phase of ``apply_per_phase`` is one
    call of the kernel wrapper, never the plain ``untangled_conv2d``: the
    whole-plane kernel B where the phase's plane fits the reference's
    budget, kernel C with the card's tile where it does not (384² × 8), on
    the int8 codes and their scale rows for an int8 plan.  The output
    matches JAX's per-phase executor on the dequantized superpack."""
    calls = []
    real = tplan.untangled_conv2d_superpack

    def record(x, sp, **kw):
        calls.append((sp.dtype, kw.get("sp_tiles"), kw.get("scales")))
        return real(x, sp, **kw)

    def refuse(*a, **kw):
        raise AssertionError("plain untangled_conv2d on the 'cuda' policy")

    monkeypatch.setattr(tplan, "untangled_conv2d_superpack", record)
    monkeypatch.setattr(tplan, "untangled_conv2d", refuse)
    l = jvae.VAE.decoder_layers[1]
    l = dataclasses.replace(l, in_hw=hw, in_c=c, out_c=n)
    tp = tplan.plan_conv(dataclasses.replace(
        _spec(tplan.ConvSpec, l, "cuda"), wdtype=wdtype))
    jp = jplan.plan_conv(_spec(jplan.ConvSpec, l, "xla"))
    x = rand(3, 1, hw, hw, c)
    packed = tp.pack(torch.from_numpy(rand(4, 4, 4, c, n) * 0.1))
    with torch.no_grad():
        got = tp.apply_per_phase(torch.from_numpy(x), packed)
    live = [ex for ex in tp.phases if ex.taps[0] * ex.taps[1]]
    assert len(calls) == len(live) == 4
    for dtype, sp_tiles, scales in calls:
        assert (sp_tiles is not None) == tiled
        assert dtype == (torch.int8 if wdtype == "int8" else torch.float32)
        assert (scales is not None) == (wdtype == "int8")
    want = np.asarray(jp.apply_per_phase(
        jnp.asarray(x), jnp.asarray(tplan._deq(packed).numpy())))
    assert_close(got, want, TOL_FWD)


OPS_CASES = [
    ("conv_k3", (2, 9, 9, 4), (3, 3, 4, 6), (1, 1), ((1, 1), (1, 1)),
     (1, 1)),
    ("conv_k4s2_stem", (1, 16, 16, 3), (4, 4, 3, 8), (2, 2),
     ((2, 1), (2, 1)), (1, 1)),
    ("dilated_d2", (1, 11, 11, 4), (3, 3, 4, 5), (1, 1), ((2, 2), (2, 2)),
     (2, 2)),
]


@pytest.mark.parametrize("name,xs,ks,strides,padding,dil", OPS_CASES,
                         ids=[c[0] for c in OPS_CASES])
def test_ops_untangled_conv2d_matches_jax(name, xs, ks, strides, padding,
                                          dil):
    """The HWIO entry on the 'cuda' route (kernel B's plain version on the
    CPU) against JAX's Pallas entry in interpret mode and both library
    oracles."""
    x, k = rand(1, *xs), rand(2, *ks)
    want = np.asarray(jops.untangled_conv2d(
        jnp.asarray(x), jnp.asarray(k), strides=strides, padding=padding,
        rhs_dilation=dil, interpret=True))
    got = tops.untangled_conv2d(torch.from_numpy(x), torch.from_numpy(k),
                                strides=strides, padding=padding,
                                rhs_dilation=dil)
    assert_close(got, want, TOL_FWD)
    oracle = tkref.untangled_conv2d_ref(torch.from_numpy(x),
                                        torch.from_numpy(k), strides=strides,
                                        padding=padding, rhs_dilation=dil)
    assert_close(oracle, np.asarray(jkref.untangled_conv2d_ref(
        jnp.asarray(x), jnp.asarray(k), strides=strides, padding=padding,
        rhs_dilation=dil)), TOL_FWD)
    assert_close(got, oracle, TOL_FWD)


@pytest.mark.parametrize("name,h,r,s,pads", [
    ("k4s2_pad13", 8, 4, 2, ((1, 3), (1, 3))),
    ("k5s2", 4, 5, 2, ((2, 3), (2, 3))),
    ("k3s2_asym", 5, 3, 2, ((1, 0), (2, 1)))])
def test_ops_untangled_deconv2d_matches_jax(name, h, r, s, pads):
    """The transposed HWIO entry on the 'cuda' route (kernel A's plain
    version on the CPU) against JAX's Pallas entry in interpret mode and
    the oracle."""
    x, k = rand(h, 2, h, h, 5), rand(r, r, r, 5, 3)
    want = np.asarray(jops.untangled_deconv2d(
        jnp.asarray(x), jnp.asarray(k), strides=(s, s), padding=pads,
        interpret=True))
    got = tops.untangled_deconv2d(torch.from_numpy(x), torch.from_numpy(k),
                                  strides=(s, s), padding=pads)
    assert_close(got, want, TOL_FWD)
    assert_close(got, tref.oracle_conv_transpose2d(
        torch.from_numpy(x), torch.from_numpy(k), strides=(s, s),
        padding=pads), TOL_FWD)


def test_core_exports_every_public_name_of_jax():
    assert set(tcore.__all__) >= set(jcore.__all__)
    for name in tcore.__all__:
        assert hasattr(tcore, name), name
    tplan.plan_cache_clear()
    spec = _spec(tplan.ConvSpec, FIG_LAYERS[0][1], "torch")
    tcore.plan_conv(spec)
    tcore.plan_conv(spec)
    info = tcore.plan_cache_info()
    assert (info.hits, info.misses, info.currsize) == (1, 1, 1)


def test_quickstart_in_process():
    times = quickstart.main(["--device", "cpu", "--backend", "torch",
                             "--iters", "1"])
    assert set(times) == {"naive(zero-insert+im2col)", "HUGE2"}


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_segment_in_process(backend):
    out = segment.main(["--device", "cpu", "--backend", backend,
                        "--steps", "2"])
    assert out["final"] < out["loss0"]


def test_example_clis_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for main in (quickstart.main, segment.main):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main([])
