"""Kernel F's plain version (``repro_torch.kernels.flash_attention``) and the
port's dense oracle against the JAX package on the CPU: JAX's Pallas kernel
in interpret mode at its four test geometries, JAX's jnp flash path in
bf16, JAX's dense oracle at ragged, ``q_offset``, non-causal ragged and
window cases, and the wrappers' dispatch and refusals.  The kernel itself
runs only on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``);
here a replay of F's recurrence with P rounded as the card's bf16 entry
may round it shows why that entry splits P in two for P·V."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.ref import flash_attention_ref as jref
from repro.layers.attention import flash_attention as jflash
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.layers import attention as tattn

TOL = 2e-4                  # test_flash_attention_kernel.py's f32 tolerance
TOL_BF16 = 3e-2             # its bf16 tolerance against the jnp path


def qkv(b, sq, sk, h, kh, d, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d)).astype(dtype),
            rng.standard_normal((b, sk, kh, d)).astype(dtype),
            rng.standard_normal((b, sk, kh, d)).astype(dtype))


def t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def jax_ref_at_offset(q, k, v, *, causal, window, q_offset):
    """JAX's dense oracle has no ``q_offset``: put q[0] at that position by
    prepending ``q_offset`` zero query rows and dropping their outputs."""
    pad = np.zeros((q.shape[0], q_offset) + q.shape[2:], q.dtype)
    out = jref(jnp.asarray(np.concatenate([pad, q], 1)), jnp.asarray(k),
               jnp.asarray(v), causal=causal, window=window)
    return np.asarray(out)[:, q_offset:]


# test_flash_attention_kernel.py's geometries: (b, s, h, kh, d, causal,
# window)
PALLAS_CASES = [
    (1, 256, 4, 4, 64, True, 0),
    (2, 256, 8, 2, 32, True, 0),        # GQA
    (1, 512, 4, 1, 64, True, 128),      # MQA + sliding window
    (1, 256, 2, 2, 64, False, 0),       # bidirectional (encoder)
]


@pytest.mark.parametrize("case", PALLAS_CASES,
                         ids=[f"b{c[0]}s{c[1]}h{c[2]}kh{c[3]}d{c[4]}"
                              f"{'c' if c[5] else 'nc'}w{c[6]}"
                              for c in PALLAS_CASES])
def test_plain_matches_pallas_interpret(case):
    b, s, h, kh, d, causal, window = case
    q, k, v = qkv(b, s, s, h, kh, d, seed=s + h)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  window=window, bq=128, ck=128,
                                  interpret=True)
    got = fa.flash_attention_plain(*t(q, k, v), causal=causal,
                                   window=window, ck=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_plain_matches_jnp_flash_bf16():
    q, k, v = qkv(1, 256, 256, 4, 2, 64, seed=0)
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = jflash(*bf, causal=True, kv_chunk=64)
    tq, tk, tv = (torch.from_numpy(np.asarray(a, np.float32))
                  .to(torch.bfloat16) for a in bf)
    got = fa.flash_attention_plain(tq, tk, tv, causal=True, ck=128)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL_BF16, atol=TOL_BF16)


# (name, b, sq, sk, h, kh, d, causal, window, q_offset, ck)
ORACLE_CASES = [
    ("ragged_causal", 1, 100, 100, 4, 2, 32, True, 0, 0, 48),
    ("ragged_gqa_b2", 2, 77, 77, 4, 2, 16, True, 0, 0, 32),
    ("q_offset_decode", 1, 1, 40, 4, 1, 16, True, 0, 30, 16),
    ("q_offset_block", 2, 5, 40, 4, 2, 16, True, 0, 20, 16),
    ("window_q_offset", 1, 6, 50, 2, 1, 16, True, 8, 30, 16),
    # the row sits past the window's reach of every key: no key is visible,
    # so F (and the oracle) give the uniform average over all Sk keys
    ("no_visible_key", 1, 1, 20, 2, 2, 16, True, 8, 50, 8),
    # JAX's jnp flash_attention pads K/V with zero keys to a multiple of
    # kv_chunk and masks them only through the causal test; with
    # causal=False and Sk % kv_chunk != 0 those zero keys score 0 and enter
    # the softmax (0.178 off the oracle at q/k/v (1, 10, 2, 16),
    # kv_chunk=4).  That is a fault of the reference: F asserts Sk % ck == 0
    # and the oracle has no padding, so the port is held to the oracle.
    ("noncausal_ragged", 1, 10, 10, 2, 2, 16, False, 0, 0, 4),
    ("noncausal_ragged_gqa", 2, 37, 53, 4, 2, 32, False, 0, 0, 16),
]


@pytest.mark.parametrize("case", ORACLE_CASES, ids=[c[0] for c in ORACLE_CASES])
def test_plain_matches_jax_dense_oracle(case):
    name, b, sq, sk, h, kh, d, causal, window, q_offset, ck = case
    q, k, v = qkv(b, sq, sk, h, kh, d, seed=sum(map(ord, name)))
    want = jax_ref_at_offset(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)
    got = fa.flash_attention_plain(*t(q, k, v), causal=causal,
                                   window=window, q_offset=q_offset, ck=ck)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    # and the port's oracle, which takes q_offset itself
    mine = flash_attention_ref(*t(q, k, v), causal=causal, window=window,
                               q_offset=q_offset)
    np.testing.assert_allclose(mine.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 16),
                                           (False, 0)])
def test_port_oracle_matches_jax_oracle(dtype, causal, window):
    q, k, v = qkv(2, 48, 48, 4, 2, 32, seed=7)
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
          "float64": jnp.float32}[dtype]
    jq, jk, jv = (jnp.asarray(a, jd) for a in (q, k, v))
    want = np.asarray(jref(jq, jk, jv, causal=causal, window=window),
                      np.float32)
    td = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(np.array(a, np.float32)).to(td)
                  for a in (jq, jk, jv))
    got = flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == td
    # bf16: one bf16 rounding of the output apart at most; f64: the f32
    # oracle's own rounding
    tol = 2 ** -7 if dtype == "bfloat16" else TOL
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol)


def test_cpu_tensors_take_the_plain_version():
    """The wrapper and the layer's core run F's plain version on CPU
    tensors, bit for bit, and count no launch."""
    q, k, v = t(*qkv(1, 70, 70, 4, 2, 32, seed=3))
    before = fa.flash_attention.launches
    want = fa.flash_attention_plain(q, k, v, causal=True, ck=512)
    np.testing.assert_array_equal(fa.flash_attention(q, k, v).numpy(),
                                  want.numpy())
    np.testing.assert_array_equal(
        tattn.flash_attention(q, k, v, kv_chunk=512).numpy(), want.numpy())
    assert fa.flash_attention.launches == before


@pytest.mark.parametrize("bad", ["kv_heads", "head_dim", "dtype", "rank",
                                 "no_keys", "q_offset"])
def test_wrapper_refuses_bad_arguments(bad):
    q, k, v = t(*qkv(1, 8, 8, 4, 2, 32, seed=1))
    kw = {}
    if bad == "kv_heads":
        k, v = k[:, :, :1].expand(1, 8, 3, 32), v[:, :, :1].expand(1, 8, 3,
                                                                    32)
    elif bad == "head_dim":
        k, v = k[..., :16], v[..., :16]
    elif bad == "dtype":
        k = k.double()
    elif bad == "rank":
        q = q[0]
    elif bad == "no_keys":
        k, v = k[:, :0], v[:, :0]
    else:
        kw = {"q_offset": -1}
    with pytest.raises((ValueError, TypeError)):
        fa.flash_attention(q, k, v, **kw)


def p_rounded_attention(q, k, v, *, causal, p_form, ck=64):
    """F's recurrence (as ``flash_attention_plain``) on bf16 q, k, v, with
    P·V taken on P rounded as a bf16 tensor-core product would take it:
    ``"one"`` one bf16 P, ``"split"`` the two terms hi = bf16(p) and
    lo = bf16(p - hi).  Each bf16 product is exact in f32 and summed in
    f32; ``l`` sums the f32 P."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, sq, kh, h // kh, d)
    acc = torch.zeros((b, kh, h // kh, sq, d))
    m = torch.full((b, kh, h // kh, sq), fa.NEG_INF)
    l = torch.zeros((b, kh, h // kh, sq))
    for c0 in range(0, sk, ck):
        kc, vc = k[:, c0:c0 + ck].float(), v[:, c0:c0 + ck].float()
        s = torch.einsum("bqkgd,bskd->bkgqs", qf, kc) * d ** -0.5
        if causal:
            seen = torch.arange(sq)[:, None] >= c0 + torch.arange(
                kc.shape[1])[None, :]
            s = s.masked_fill(~seen, fa.NEG_INF)
        m2 = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m2[..., None])
        r = torch.exp(m - m2)
        hi = p.to(torch.bfloat16).float()
        pv = torch.einsum("bkgqs,bskd->bkgqd", hi, vc)
        if p_form == "split":
            lo = (p - hi).to(torch.bfloat16).float()
            pv = pv + torch.einsum("bkgqs,bskd->bkgqd", lo, vc)
        acc = acc * r[..., None] + pv
        l = l * r + p.sum(dim=-1)
        m = m2
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


@pytest.mark.parametrize("case", [(1, 256, 2, 2, 64, False),
                                  (1, 128, 4, 1, 32, True)],
                         ids=["bidirectional_d64", "causal_mqa_d32"])
def test_bf16_p_needs_two_terms_for_the_card_gate(case):
    """The card holds bf16 F to |o - oracle| <= 2e-4 + 2^-7 |oracle| (the
    f64 dense oracle).  With P rounded to one bf16 for P·V (SDPA's choice)
    the result breaks that gate; with P = hi + lo in two bf16 terms it
    stays within it, as F's f32 P does."""
    b, s, h, kh, d, causal = case
    q, k, v = (a.to(torch.bfloat16) for a in t(*qkv(b, s, s, h, kh, d,
                                                     seed=s + d)))
    oracle = flash_attention_ref(q.double(), k.double(), v.double(),
                                 causal=causal)
    gate = 2e-4 + 2.0 ** -7 * oracle.abs()

    def share(o):
        return float(((o.double() - oracle).abs() / gate).max())
    assert share(p_rounded_attention(q, k, v, causal=causal,
                                     p_form="one")) > 1
    assert share(p_rounded_attention(q, k, v, causal=causal,
                                     p_form="split")) <= 1
    assert share(fa.flash_attention_plain(q, k, v, causal=causal)) <= 1
