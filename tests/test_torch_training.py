"""The port's training path against the JAX package's custom VJPs: the
single-correlation forward on every route, and dx/dK of ``ConvPlan.apply``
for the transposed, conv and dilated kinds (both ``fused_bwd`` forms,
negative padding, 4-D HWIO weights) against ``jax.vjp`` of JAX's
``plan.apply`` on the same numpy inputs."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import plan as jplan
from repro_torch.core import engine as tengine
from repro_torch.core import plan as tplan

from tests.conftest import TOL_FWD, TOL_GRAD, assert_close
from tests.test_torch_cuda import CASES as TRANSPOSED_CASES
from tests.test_torch_cuda import inputs as transposed_inputs

# (name, b, h, c, n, k, strides, dilation, pads): a DCGAN-discriminator-like
# site (C = 3, k5 s2), the cGAN's asymmetric pad, dilated sites, and a
# dilated strided site with uneven pads
SINGLE_CASES = [
    ("disc_c3_k5s2", 2, 9, 3, 4, 5, (2, 2), (1, 1), ((2, 2), (2, 2))),
    ("cgan_asym_k4s2", 2, 8, 6, 5, 4, (2, 2), (1, 1), ((2, 1), (2, 1))),
    ("dilated_d2", 1, 11, 4, 3, 3, (1, 1), (2, 2), ((2, 2), (2, 2))),
    ("dilated_s2_d2", 2, 10, 3, 4, 3, (2, 2), (2, 2), ((1, 2), (2, 1))),
]
SINGLE_IDS = [c[0] for c in SINGLE_CASES]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def single_inputs(case):
    name, b, h, c, n, k, *_ = case
    rng = np.random.default_rng(sum(map(ord, name)))
    x = rng.standard_normal((b, h, h, c)).astype(np.float32)
    kern = rng.standard_normal((k, k, c, n)).astype(np.float32)
    return x, kern, rng


def single_plans(case, backend):
    _, b, h, c, n, k, strides, dil, pads = case
    kind = "dilated" if dil != (1, 1) else "conv"
    jb = {"cuda": "pallas", "torch": "xla"}[backend]
    jp = jplan.plan_conv(jplan.conv_spec(
        kind, (b, h, h, c), (k, k, c, n), strides=strides, padding=pads,
        dilation=dil, backend=jb))
    tp = tplan.plan_conv(tplan.conv_spec(
        kind, (b, h, h, c), (k, k, c, n), strides=strides, padding=pads,
        dilation=dil, backend=backend))
    return jp, tp


def force(jp, tp, path, fused_bwd):
    """Both plans with every bucket on ``path`` (JAX keeps its own
    'pallas' tiles under the port's 'cuda') and the given backward form."""
    jroutes = tuple(
        jplan.Route(r.batch, r.path if path == "cuda" else path,
                    r.tiles if path == "cuda" else None,
                    fused_bwd=fused_bwd) for r in jp.routes)
    troutes = tuple(tplan.Route(bb, path, None, fused_bwd=fused_bwd)
                    for bb in tplan.BATCH_BUCKETS)
    return jp.with_routes(jroutes), tp.with_routes(troutes)


def jax_vjp(jp, x, packed, dy):
    """JAX's planned forward and custom VJP, jitted (one compile instead
    of an eager dispatch per tap slice)."""
    def fwd_bwd(x, packed, dy):
        y, vjp = jax.vjp(jp.apply, x, packed)
        return (y,) + tuple(vjp(dy))

    return tuple(np.asarray(a) for a in jax.jit(fwd_bwd)(
        jnp.asarray(x), jnp.asarray(packed), jnp.asarray(dy)))


def torch_vjp(tp, x, packed, dy):
    xt = torch.from_numpy(x).requires_grad_()
    pt = torch.from_numpy(np.array(packed)).requires_grad_()
    y = tp.apply(xt, pt)
    y.backward(torch.from_numpy(dy))
    return y.detach().numpy(), xt.grad.numpy(), pt.grad.numpy()


@pytest.mark.parametrize("path", ["fused_tap", "taps", "cuda"])
@pytest.mark.parametrize("case", SINGLE_CASES, ids=SINGLE_IDS)
def test_single_fwd_matches_jax_route(case, path):
    """``_single_fwd`` on each route against JAX's same route ('cuda' runs
    kernel B's plain version here; JAX's 'pallas' runs in interpret mode)."""
    x, kern, _ = single_inputs(case)
    jp, tp = single_plans(case, "cuda" if path == "cuda" else "torch")
    jp, tp = force(jp, tp, path, True)
    packed = np.asarray(jp.pack(kern))
    want = np.asarray(jp.apply(jnp.asarray(x), jnp.asarray(packed)))
    got = tplan._single_fwd(tp, torch.from_numpy(x),
                            torch.from_numpy(np.array(packed)))
    assert got.shape == want.shape == (x.shape[0], *tp.out_hw, kern.shape[3])
    assert_close(got.numpy(), want, TOL_FWD)


@pytest.mark.parametrize("fused_bwd", [True, False], ids=["fused", "per_tap"])
@pytest.mark.parametrize("path", ["fused_tap", "cuda"])
@pytest.mark.parametrize("case", SINGLE_CASES, ids=SINGLE_IDS)
def test_single_vjp_matches_jax(case, path, fused_bwd):
    x, kern, rng = single_inputs(case)
    jp, tp = single_plans(case, "cuda" if path == "cuda" else "torch")
    jp, tp = force(jp, tp, path, fused_bwd)
    packed = np.asarray(jp.pack(kern))
    dy = rng.standard_normal((x.shape[0], *tp.out_hw, kern.shape[3])) \
        .astype(np.float32)
    y_j, dx_j, dk_j = jax_vjp(jp, x, packed, dy)
    y_t, dx_t, dk_t = torch_vjp(tp, x, packed, dy)
    assert_close(y_t, y_j, TOL_FWD)
    assert dk_t.shape == packed.shape          # grads stay superpacked
    assert_close(dx_t, dx_j, TOL_GRAD)
    assert_close(dk_t, dk_j, TOL_GRAD)


def _uniform(case):
    _, b, h, c, n, k, s, pads = case
    return tplan.plan_conv(tplan.conv_spec(
        "transposed", (b, h, h, c), (k, k, c, n), strides=(s, s),
        padding=pads, backend="torch")).uniform


# every transposed route on every case (fused_tap stacks equal phase
# views, so it serves uniform plans only)
TRANSPOSED_RUNS = [(case, path) for case in TRANSPOSED_CASES
                   for path in ("fused_tap", "fused_plane", "taps", "cuda")
                   if path != "fused_tap" or _uniform(case)]


@functools.lru_cache(maxsize=None)
def transposed_reference(case):
    """JAX's planned forward and custom VJP on the case's inputs (its
    backward does not depend on the forward route, so one serves all)."""
    _, b, h, c, n, k, s, pads = case
    x, kern = transposed_inputs(case)
    jp = jplan.plan_conv(jplan.conv_spec(
        "transposed", x.shape, kern.shape, strides=(s, s), padding=pads,
        backend="xla"))
    packed = np.asarray(jp.pack(kern))
    out_hw = jp.out_hw
    dy = np.random.default_rng(b + h).standard_normal(
        (b, *out_hw, n)).astype(np.float32)
    return (x, packed, dy) + jax_vjp(jp, x, packed, dy)


@pytest.mark.parametrize("case,path", TRANSPOSED_RUNS,
                         ids=[f"{c[0]}-{p}" for c, p in TRANSPOSED_RUNS])
def test_transposed_vjp_matches_jax(case, path):
    """``_pt_bwd`` (dx contracting N against ``panel.T``, dK in superpack
    row order, empty phases skipped) against JAX's custom VJP, with the
    forward on every route."""
    _, b, h, c, n, k, s, pads = case
    x, packed, dy, y_j, dx_j, dk_j = transposed_reference(case)
    tp = tplan.plan_conv(tplan.conv_spec(
        "transposed", x.shape, (k, k, c, n), strides=(s, s), padding=pads,
        backend="cuda" if path == "cuda" else "torch"))
    tp = tp.with_routes(tuple(tplan.Route(bb, path, None)
                              for bb in tplan.BATCH_BUCKETS))
    y_t, dx_t, dk_t = torch_vjp(tp, x, packed, dy)
    assert_close(y_t, y_j, TOL_FWD)
    assert dk_t.shape == packed.shape
    assert_close(dx_t, dx_j, TOL_GRAD)
    assert_close(dk_t, dk_j, TOL_GRAD)


def test_fused_bwd_comes_from_the_actual_batch(monkeypatch):
    """The backward's form is the route of the batch it runs at: a plan
    whose B=1 bucket fuses and whose B=4 bucket goes per tap takes each
    form at its own batch, and both match JAX."""
    case = SINGLE_CASES[0]
    x, kern, rng = single_inputs(case)
    jp, tp = single_plans(case, "torch")
    forms = {1: True, 4: False, 16: True, 64: False}
    jp = jp.with_routes(tuple(jplan.Route(bb, "fused_tap", None,
                                          fused_bwd=forms[bb])
                              for bb in jplan.BATCH_BUCKETS))
    tp = tp.with_routes(tuple(tplan.Route(bb, "fused_tap", None,
                                          fused_bwd=forms[bb])
                              for bb in tplan.BATCH_BUCKETS))
    packed = np.asarray(jp.pack(kern))
    seen = []
    real_matmul = torch.matmul

    def spy(a, b_):
        seen.append(tuple(b_.shape))
        return real_matmul(a, b_)

    for b in (1, 3):
        xb = np.repeat(x[:1], b, axis=0)
        dy = rng.standard_normal((b, *tp.out_hw, kern.shape[3])) \
            .astype(np.float32)
        _, dx_j, dk_j = jax_vjp(jp, xb, packed, dy)
        seen.clear()
        with monkeypatch.context() as m:
            m.setattr(torch, "matmul", spy)
            _, dx_t, dk_t = torch_vjp(tp, xb, packed, dy)
        c, n = tp.spec.in_c, tp.spec.out_c
        # the fused dx GEMM contracts dy against the whole (N, ΣT·C) view
        assert ((n, tp.total_taps * c) in seen) == (b == 1)
        assert_close(dx_t, dx_j, TOL_GRAD)
        assert_close(dk_t, dk_j, TOL_GRAD)


def test_kernel_wrappers_see_detached_inputs(monkeypatch):
    """Inside the autograd Functions the inputs still require grad; the
    forward hands the kernel wrappers detached tensors (on CUDA tensors the
    wrappers raise on ``requires_grad``)."""
    seen = []
    for name in ("untangled_conv2d_superpack", "untangled_deconv2d"):
        real = getattr(tplan, name)

        def spy(x, sp, *a, _real=real, **kw):
            seen.append((x.requires_grad, sp.requires_grad))
            return _real(x, sp, *a, **kw)

        monkeypatch.setattr(tplan, name, spy)
    x, kern, _ = single_inputs(SINGLE_CASES[0])
    _, tp = single_plans(SINGLE_CASES[0], "cuda")
    xt = torch.from_numpy(x).requires_grad_()
    pk = tp.pack(torch.from_numpy(kern)).requires_grad_()
    tp.apply(xt, pk).sum().backward()
    xt2, kern2 = transposed_inputs(TRANSPOSED_CASES[0])
    _, b, h, c, n, k, s, pads = TRANSPOSED_CASES[0]
    tp2 = tplan.plan_conv(tplan.conv_spec(
        "transposed", xt2.shape, kern2.shape, strides=(s, s), padding=pads,
        backend="cuda"))
    x2 = torch.from_numpy(xt2).requires_grad_()
    tp2.apply(x2, tp2.pack(torch.from_numpy(kern2)).requires_grad_()) \
        .sum().backward()
    assert seen == [(False, False), (False, False)]
    assert xt.grad is not None and pk.grad is not None
    assert x2.grad is not None


def test_only_the_needed_cotangents_are_computed(monkeypatch):
    """A frozen input or weight gets no cotangent product (as XLA drops an
    unused one under jit)."""
    x, kern, _ = single_inputs(SINGLE_CASES[0])
    _, tp = single_plans(SINGLE_CASES[0], "torch")
    calls = []
    real = tplan._ps_bwd

    def spy(*a, **kw):
        calls.append((kw["need_dx"], kw["need_dk"]))
        return real(*a, **kw)

    monkeypatch.setattr(tplan, "_ps_bwd", spy)
    pk = tp.pack(torch.from_numpy(kern)).requires_grad_()
    tp.apply(torch.from_numpy(x), pk).sum().backward()
    xt = torch.from_numpy(x).requires_grad_()
    tp.apply(xt, tp.pack(torch.from_numpy(kern))).sum().backward()
    assert calls == [(False, True), (True, False)]


def test_hwio_kernel_gets_a_4d_cotangent():
    """Callers passing the HWIO kernel get an HWIO cotangent back
    (``test_single_correlation.py``'s case)."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((1, 9, 9, 2)).astype(np.float32)
    k = rng.standard_normal((3, 3, 2, 4)).astype(np.float32)
    kw = dict(dilation=(3, 3), padding=((3, 3), (3, 3)))
    y_j, vjp = jax.vjp(lambda x, k: jengine.huge_dilated_conv2d(x, k, **kw),
                       jnp.asarray(x), jnp.asarray(k))
    dx_j, dk_j = vjp(jnp.ones_like(y_j))
    xt = torch.from_numpy(x).requires_grad_()
    kt = torch.from_numpy(k).requires_grad_()
    y = tengine.huge_dilated_conv2d(xt, kt, backend="torch", **kw)
    y.sum().backward()
    assert kt.grad.shape == k.shape
    assert_close(y.detach().numpy(), np.asarray(y_j), TOL_FWD)
    assert_close(xt.grad.numpy(), np.asarray(dx_j), TOL_GRAD)
    assert_close(kt.grad.numpy(), np.asarray(dk_j), TOL_GRAD)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_negative_padding_vjp(backend):
    """``pad_or_crop``'s crop branch transposes through ``_unpad_transpose``
    (``test_single_correlation.py``'s case)."""
    rng = np.random.default_rng(13)
    x = rng.standard_normal((1, 12, 12, 3)).astype(np.float32)
    k = rng.standard_normal((3, 3, 3, 2)).astype(np.float32)
    pads = ((-1, -2), (-2, -1))
    case = ("neg", 1, 12, 3, 2, 3, (1, 1), (2, 2), pads)
    jp, tp = single_plans(case, backend)
    packed = np.asarray(jp.pack(k))
    dy = rng.standard_normal((1, *tp.out_hw, 2)).astype(np.float32)
    y_j, dx_j, dk_j = jax_vjp(jp, x, packed, dy)
    y_t, dx_t, dk_t = torch_vjp(tp, x, packed, dy)
    assert_close(y_t, y_j, TOL_FWD)
    assert_close(dx_t, dx_j, TOL_GRAD)
    assert_close(dk_t, dk_j, TOL_GRAD)
    # the cropped border gets exactly zero gradient
    assert not dx_t[:, :1].any() and not dx_t[:, -2:].any()
    assert not dx_t[:, :, :2].any() and not dx_t[:, :, -1:].any()


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_engine_functions_match_jax(backend):
    """``huge_*`` against JAX's, forward and VJP: the transposed case of
    ``tests/test_pallas_training_path.py`` (JAX on 'pallas' in interpret
    mode for the port's 'cuda'), a strided conv and a dilated conv."""
    rng = np.random.default_rng(7)
    jb = {"cuda": "pallas", "torch": "xla"}[backend]
    x5 = rng.standard_normal((2, 5, 5, 8)).astype(np.float32)
    x9 = rng.standard_normal((2, 9, 9, 3)).astype(np.float32)
    calls = [
        ("huge_conv_transpose2d", x5,
         rng.standard_normal((5, 5, 8, 4)).astype(np.float32),
         dict(strides=(2, 2), padding=((2, 3), (2, 3)))),
        ("huge_conv2d", x9,
         rng.standard_normal((5, 5, 3, 4)).astype(np.float32),
         dict(strides=(2, 2), padding=((2, 2), (2, 2)))),
        ("huge_dilated_conv2d", x9,
         rng.standard_normal((3, 3, 3, 4)).astype(np.float32),
         dict(dilation=(2, 2), padding=((2, 2), (2, 2)))),
    ]
    for name, x, k, kw in calls:
        jfn, tfn = getattr(jengine, name), getattr(tengine, name)
        y_shape = jax.eval_shape(lambda x, k: jfn(x, k, backend=jb, **kw),
                                 x, k).shape
        dy = rng.standard_normal(y_shape).astype(np.float32)

        @jax.jit
        def fwd_bwd(x, k, dy):
            y, vjp = jax.vjp(lambda x, k: jfn(x, k, backend=jb, **kw), x, k)
            return (y,) + tuple(vjp(dy))

        y_j, dx_j, dk_j = fwd_bwd(x, k, dy)
        xt = torch.from_numpy(x).requires_grad_()
        kt = torch.from_numpy(k).requires_grad_()
        y = tfn(xt, kt, backend=backend, **kw)
        y.backward(torch.from_numpy(dy))
        assert_close(y.detach().numpy(), np.asarray(y_j), TOL_FWD)
        assert_close(xt.grad.numpy(), np.asarray(dx_j), TOL_GRAD)
        assert_close(kt.grad.numpy(), np.asarray(dk_j), TOL_GRAD)
