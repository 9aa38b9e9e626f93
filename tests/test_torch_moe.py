"""The port's MoE (``repro_torch.layers.moe``) against the JAX package's
(``repro.layers.moe``) on the CPU, at the reduced dbrx-132b (softmax
router, 4 experts top-2) and deepseek-v3-671b (sigmoid_bias router with a
selection bias and ``routed_scaling``, 8 experts top-2) with JAX's own
expert weights: the router's indices equal to JAX's and its weights
within f32 rounding, ``moe_apply`` (the one-card form: tokens sorted by
expert) and ``moe_decode`` (the static-shape form a CUDA graph captures)
against JAX's ``moe_apply_dense`` in f32 and bf16, the port's
all-experts ``moe_apply_dense`` against JAX's, the two forms against each
other, the tree of ``moe_init``, and ``update_balance_bias`` /
``expert_load_from_idx`` equal to JAX's.  Inputs are drawn with numpy
from fixed seeds.

Tolerances: f32 results relative to max|y| at ``TOL_LAYER`` (1e-5: the
same f32 products summed in another order); bf16 results within one bf16
rounding of the f32 value on either side, 2^-7 relative to max|y|.  The
router's top-k picks the same experts unless two selection scores sit
within f32 rounding of each other: ``near_ties`` counts such rows, and
the test reports them rather than hiding them (none at these seeds)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.layers import moe as jmoe
from repro_torch.configs import registry as tregistry
from repro_torch.layers import moe as tmoe

ARCHS = ("dbrx-132b", "deepseek-v3-671b")
TOL_LAYER = 1e-5
TOL_BF16 = 2.0 ** -7


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def cfgs(arch):
    return jregistry.get_reduced(arch), tregistry.get_reduced(arch)


def rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def jax_params(arch, which="bf16"):
    """JAX's MoE params at the reduced config (bf16 experts, or their f32
    cast), with a non-zero selection bias so the sigmoid_bias router's
    selection differs from its weights' order."""
    jc = cfgs(arch)[0]
    p, _ = jmoe.moe_init(jax.random.PRNGKey(3), jc)
    p["bias"] = jnp.asarray(rand((jc.n_experts,), 4, 0.05))
    if which == "f32":
        p = jax.tree.map(lambda a: a.astype(jnp.float32), p)
    return p


def to_port(jp):
    def t(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.uint16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(a.copy())
    return {k: t(v) for k, v in jp.items()}


def close_rel(got, want, tol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), err


def near_ties(sel, k):
    """Rows whose k-th and (k+1)-th selection scores sit within f32
    rounding (4 ulps) of each other: there top-k may pick either."""
    top = np.sort(np.asarray(sel, np.float32), -1)[:, ::-1]
    gap = top[:, k - 1] - top[:, k]
    return int((gap <= 4 * np.spacing(np.abs(top[:, k - 1]))).sum())


def x_of(arch, b, s, seed, dtype):
    x = rand((b, s, cfgs(arch)[0].d_model), seed)
    return (jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32),
            torch.from_numpy(x).to(torch.bfloat16 if dtype == "bf16"
                                   else torch.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_jax(arch):
    """Indices equal to JAX's, weights within f32 rounding, at 40 tokens
    in f32 and bf16 activations."""
    jc, tc = cfgs(arch)
    jp = jax_params(arch)
    tp = to_port(jp)
    for dtype, seed in (("f32", 10), ("bf16", 11)):
        jx, tx = x_of(arch, 1, 40, seed, dtype)
        jx, tx = jx.reshape(40, -1), tx.reshape(40, -1)
        jw, jidx = jmoe._route(jx, jp, jc)
        tw, tidx = tmoe._route(tx, tp, tc)
        logits = np.asarray(jx, np.float32) @ np.asarray(jp["router"])
        sel = (1 / (1 + np.exp(-logits)) + np.asarray(jp["bias"])
               if jc.router_type == "sigmoid_bias" else logits)
        assert near_ties(sel, jc.top_k) == 0
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                                   atol=1e-7)
        assert tw.dtype == torch.float32 and tidx.dtype == torch.int64


@pytest.mark.parametrize("form", ["apply", "decode", "dense"])
@pytest.mark.parametrize("which", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_matches_jax_dense(arch, which, form):
    """The port's three forms against JAX's ``moe_apply_dense`` on the same
    weights and tokens (B = 2, S = 7), in f32 and bf16."""
    jc, tc = cfgs(arch)
    jp = jax_params(arch, which)
    tp = to_port(jp)
    jx, tx = x_of(arch, 2, 7, 12, which)
    want = jax.jit(lambda p, x: jmoe.moe_apply_dense(p, x, jc))(jp, jx)
    fn = {"apply": tmoe.moe_apply, "decode": tmoe.moe_decode,
          "dense": tmoe.moe_apply_dense}[form]
    got = fn(tp, tx, tc)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    close_rel(got.float().numpy(), np.asarray(want, np.float32),
              TOL_LAYER if which == "f32" else TOL_BF16)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_form_matches_prefill_form(arch):
    """``moe_decode`` (gathered experts, the k slots summed in slot order)
    against ``moe_apply`` (sorted by expert, summed in expert order) on
    the same f32 tokens: the same f32 products summed in another order,
    within ``TOL_LAYER`` of max|y|; in bf16 within one bf16 step."""
    tc = cfgs(arch)[1]
    tp32 = to_port(jax_params(arch, "f32"))
    tp = to_port(jax_params(arch))
    for which, p, tol in (("f32", tp32, TOL_LAYER), ("bf16", tp, TOL_BF16)):
        _, tx = x_of(arch, 3, 5, 13, which)
        close_rel(tmoe.moe_decode(p, tx, tc).float().numpy(),
                  tmoe.moe_apply(p, tx, tc).float().numpy(), tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_init_matches_jax_tree(arch):
    jc, tc = cfgs(arch)
    jp = jax_params(arch)
    tp = tmoe.moe_init(torch.Generator().manual_seed(0), tc)
    assert sorted(tp) == sorted(jp)
    for key in jp:
        assert tuple(tp[key].shape) == jp[key].shape, key
        assert str(tp[key].dtype)[6:] == jp[key].dtype.name, key
    assert bool((tp["bias"] == 0).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_expert_load_and_balance_bias_match_jax(arch):
    """``expert_load_from_idx`` and ``update_balance_bias`` on the router's
    own indices equal JAX's bit for bit."""
    jc, tc = cfgs(arch)
    jp = jax_params(arch)
    jx, _ = x_of(arch, 1, 33, 14, "f32")
    _, jidx = jmoe._route(jx.reshape(33, -1), jp, jc)
    want_load = jmoe.expert_load_from_idx(jidx, jc.n_experts)
    got_load = tmoe.expert_load_from_idx(torch.from_numpy(
        np.array(jidx)).long(), tc.n_experts)
    np.testing.assert_array_equal(got_load.numpy(), np.asarray(want_load))
    assert abs(float(got_load.sum()) - 1.0) < 1e-6
    for gamma in (1e-3, 0.25):
        want = jmoe.update_balance_bias(jp["bias"], want_load, gamma)
        got = tmoe.update_balance_bias(to_port(jp)["bias"], got_load, gamma)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_route_ignores_tf32_setting():
    """The router product is IEEE f32 whatever the TF32 flag, and the flag
    is restored."""
    tc = cfgs("deepseek-v3-671b")[1]
    tp = to_port(jax_params("deepseek-v3-671b"))
    _, tx = x_of("deepseek-v3-671b", 1, 9, 15, "f32")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        w, idx = tmoe._route(tx.reshape(9, -1), tp, tc)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    w0, idx0 = tmoe._route(tx.reshape(9, -1), tp, tc)
    assert torch.equal(idx, idx0) and torch.equal(w, w0)
