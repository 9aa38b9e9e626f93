"""The port's int8 quantization primitives against the JAX package's:
``quantize_int8_rows`` codes and scales bit-equal (``np.array_equal``) on
random rows and on every edge case the JAX suite names, ``_SCALE_MAX`` and
``_SCALE_FLOOR`` equal, ``dequantize_int8`` bit-equal, and the round-trip
within half a grid step."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import compress as jc
from repro_torch.runtime import compress as tc

TINY = np.finfo(np.float32).tiny          # smallest normal f32
FMAX = np.finfo(np.float32).max
# the round-trip bound in units of the row's scale: q = round(fl(w/s)) is
# within 0.5 + 127·u of w/s (the divide rounds once, u = 2^-24, |w/s| ≤
# 127) and fl(q·s) within |q|·s·u of q·s, so |w - fl(q·s)| ≤ s·(0.5 +
# 254·u) ≤ 0.5·s·(1 + 2^-15)
HALF_STEP = 0.5 * (1 + 2.0 ** -15)


def _rows(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    if name.startswith("random"):
        scale = {"random": 1.0, "random_small": 1e-30,
                 "random_large": 1e30}[name]
        return (rng.standard_normal((64, 37)) * scale).astype(np.float32)
    if name == "all_zero":
        return np.zeros((4, 8), np.float32)
    if name == "signed_zero":
        return np.array([[-0.0, 0.0, -0.0, 0.0]], np.float32)
    if name == "subnormal":
        return np.array([[TINY, -TINY / 2, 0.0, TINY / 4],
                         [0.6 * TINY, -0.3 * TINY, 0.9 * TINY, 1e-45],
                         [1e-36, 5e-39, -7e-39, 1e-37]], np.float32)
    if name == "f32max":
        return np.array([[FMAX, -FMAX, FMAX / 3, 0.0],
                         [-FMAX, FMAX / 127, 1.0, -1.0]], np.float32)
    if name == "huge_among_tiny":
        row = (rng.standard_normal((3, 16)) * 1e-6).astype(np.float32)
        row[:, 5] = np.float32(3e35)
        return row
    if name == "half_steps":
        # exact .5 ties on the grid: 127 and k + 0.5 multiples of max/127
        return np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5]],
                        np.float32)
    raise KeyError(name)


CASES = ["random", "random_small", "random_large", "all_zero",
         "signed_zero", "subnormal", "f32max", "huge_among_tiny",
         "half_steps"]


@pytest.mark.parametrize("name", CASES)
def test_codes_and_scales_bit_equal_to_jax(name):
    w = _rows(name)
    q_j, s_j = jc.quantize_int8_rows(jnp.asarray(w))
    q_t, s_t = tc.quantize_int8_rows(torch.from_numpy(w))
    assert q_t.dtype == torch.int8 and s_t.dtype == torch.float32
    assert tuple(s_t.shape) == (w.shape[0], 1)
    assert np.array_equal(q_t.numpy(), np.asarray(q_j))
    assert np.array_equal(s_t.numpy(), np.asarray(s_j))
    d_j = np.asarray(jc.dequantize_int8(q_j, s_j))
    d_t = tc.dequantize_int8(q_t, s_t).numpy()
    assert np.array_equal(d_t, d_j)
    assert np.all(np.isfinite(d_t)) and np.all(np.isfinite(s_t.numpy()))
    assert int(q_t.min()) >= -127 and int(q_t.max()) <= 127


@pytest.mark.parametrize("name", CASES)
def test_roundtrip_within_half_a_step(name):
    """|w - q·scale| ≤ ``HALF_STEP``·scale per element: half a grid step,
    with the f32 rounding of the divide and the multiply.  Subnormal weights are flushed to
    zero, as XLA flushes them, so theirs is their own size, under the
    scale floor."""
    w = _rows(name)
    q, s = tc.quantize_int8_rows(torch.from_numpy(w))
    err = np.abs(tc.dequantize_int8(q, s).numpy().astype(np.float64)
                 - w.astype(np.float64))
    bound = HALF_STEP * s.numpy().astype(np.float64)
    sub = np.abs(w) < TINY
    assert np.all(err[~sub] <= np.broadcast_to(bound, w.shape)[~sub])
    assert np.all(err[sub] <= TINY)


def test_scale_limits_equal_jax():
    assert tc._SCALE_MAX == jc._SCALE_MAX
    assert tc._SCALE_FLOOR == jc._SCALE_FLOOR
    assert np.isfinite(np.float32(127.0) * np.float32(tc._SCALE_MAX))


def test_dequantize_takes_a_per_tensor_scale():
    q = torch.tensor([[-127, 0, 5]], dtype=torch.int8)
    got = tc.dequantize_int8(q, torch.tensor(0.25))
    want = np.asarray(jc.dequantize_int8(jnp.asarray(q.numpy()),
                                         jnp.float32(0.25)))
    assert np.array_equal(got.numpy(), want)
