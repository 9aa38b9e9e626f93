"""LM training in the port against the JAX package on the CPU: ``loss_fn``
and every parameter's gradient for each of the ten reduced architectures
(from ``params_from_jax`` on f32 params, against
``jax.value_and_grad(loss_fn)``), the attention core's backward
(``layers.attention.FlashAttention``: kernel F's plain version forward,
the chunked flash backward) against ``jax.vjp`` of JAX's flash attention.
The train step and the optimisers are ``tests/test_torch_train_runtime.py``'s.

Gradients are held per tensor to their own scale: max|Δ| ≤
TOL_GRAD·max|g_jax| (f32 on both sides, other summation orders)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.layers import attention as jattn
from repro.models import transformer as jtfm
from repro.train.data import TokenPipeline
from repro_torch.configs import registry as tregistry
from repro_torch.launch import steps as tsteps
from repro_torch.layers import attention as tattn
from repro_torch.models import transformer as ttfm
from repro_torch.train.tree import tree_leaves, tree_paths
from tests.test_torch_lm import rand
from tests.test_torch_lm_families import port_params

TOL_GRAD = 1e-3             # f32 gradients, relative to max|g_jax| (the
                            # repo's gradient form and value, as in
                            # tests/test_torch_training.py)
TOL_LOSS = 1e-5             # f32 loss, relative
ARCHS = tuple(jregistry.ARCH_IDS)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@functools.cache
def jparams32(arch):
    """JAX's params at the reduced config (``PRNGKey(0)``, jitted), cast
    to f32."""
    cfg = jregistry.get_reduced(arch)
    return jax.jit(lambda k: jax.tree.map(
        lambda a: a.astype(jnp.float32), jtfm.init(k, cfg)[0]))(
            jax.random.PRNGKey(0))


def lm_batch(arch, b=2, s=16, seed=0):
    """JAX's own token pipeline (8 source frames for the encoder-decoder:
    one whole chunk of 8, see tests/test_torch_encdec.py)."""
    return TokenPipeline(jregistry.get_reduced(arch), b, s, seed=seed,
                         src_len=8).batch_at(3)


def port_layout(arch, jtree):
    """A JAX tree shaped like the params (grads, new params) in the
    port's layout: ``params_from_jax`` on it, in f32."""
    return port_params(arch, jax.tree.map(lambda a: np.asarray(
        a, np.float32), jtree))


# ---------------------------------------------------------------------------
# loss_fn and its gradients, every architecture
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    jc = jregistry.get_reduced(arch)
    tc = tregistry.get_reduced(arch)
    jp = jparams32(arch)
    bt = lm_batch(arch)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jtfm.loss_fn(p, b, jc, kv_chunk=8)))(
        jp, jax.tree.map(jnp.asarray, bt))
    tp = port_params(arch, jp)
    leaves = [t.requires_grad_() for t in tree_leaves(tp)]
    loss = ttfm.loss_fn(tp, tsteps.batch_to(bt, "cpu"), tc, kv_chunk=8)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert abs(float(loss.detach()) - float(jloss)) <= \
        TOL_LOSS * abs(float(jloss))
    want = port_layout(arch, jgrads)
    for (k, g), (k2, w) in zip(
            zip([k for k, _ in tree_paths(tp)], grads), tree_paths(want)):
        assert k == k2
        w = w.numpy()
        g = np.zeros_like(w) if g is None else g.numpy()
        err = float(np.abs(g - w).max())
        assert err <= TOL_GRAD * float(np.abs(w).max()) + 1e-30, \
            f"{arch} d{k}: {err:.3e} of max {float(np.abs(w).max()):.3e}"


# ---------------------------------------------------------------------------
# the attention core's backward
# ---------------------------------------------------------------------------

# (b, sq, sk, h, kh, d, causal, window, q_offset, kv_chunk): causal over
# two chunks, GQA with a window, a decode-style q_offset, non-causal over
# whole chunks (JAX pads a ragged non-causal Sk with live zero keys)
VJP_CASES = [
    (2, 24, 24, 4, 4, 16, True, 0, 0, 8),
    (1, 32, 32, 4, 2, 16, True, 7, 0, 8),
    (1, 5, 40, 4, 1, 8, True, 0, 35, 16),
    (2, 12, 16, 4, 2, 16, False, 0, 0, 8),
]


@pytest.mark.parametrize("case", VJP_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_backward_matches_jax_vjp(case):
    b, sq, sk, h, kh, d, causal, window, q_offset, ck = case
    q, k, v = rand((b, sq, h, d), 50), rand((b, sk, kh, d), 51), \
        rand((b, sk, kh, d), 52)
    do = rand((b, sq, h, d), 53)
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_chunk=ck)
    want_o, vjp = jax.vjp(lambda q, k, v: jattn.flash_attention(q, k, v, **kw),
                          jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = tattn.flash_attention(*ts, **kw)
    assert o.grad_fn is not None and "FlashAttention" in type(o.grad_fn).__name__
    got = torch.autograd.grad(o, ts, torch.from_numpy(do))
    np.testing.assert_allclose(o.detach().numpy(), want_o, atol=1e-5)
    for name, g, w in zip("qkv", got, want):
        w = np.asarray(w)
        err = float(np.abs(g.numpy() - w).max())
        assert err <= TOL_GRAD * float(np.abs(w).max()), (name, err)


def test_flash_without_grad_takes_no_function():
    q = torch.from_numpy(rand((1, 8, 2, 8), 54))
    assert tattn.flash_attention(q, q, q).grad_fn is None
    with torch.no_grad():
        assert tattn.flash_attention(q.requires_grad_(), q, q).grad_fn is None
