"""The port's recurrent LM families against the JAX package on the CPU:
recurrentgemma-2b (the RG-LRU ``rec`` layers beside local attention, the
gemma norm) and mamba2-130m (the SSD ``ssd`` mixer-only layers), at JAX's
``reduced()`` configs with JAX's own weights: configs, params bit for bit,
the mixers alone (``rglru_apply``/``rglru_decode``, ``ssd_chunked``/
``ssd_apply``/``ssd_decode``), ``forward`` in f32 and bf16, the prefill
step, three decode steps and their ``h``/``conv`` states, decode against
forward, the state written in place, and the greedy tokens of ``serve``
and ``ContinuousBatcher``.  Sequence lengths pass recurrentgemma's window
(8) and are no multiple of mamba2's ``ssm_chunk`` (16).  The tolerances
and helpers are ``tests/test_torch_lm.py``'s and
``tests/test_torch_lm_families.py``'s."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.layers import rglru as jrglru
from repro.layers import ssm as jssm
from repro.models import transformer as jtfm
from repro_torch.configs import registry as tregistry
from repro_torch.launch import serve as tserve
from repro_torch.layers import rglru as trglru
from repro_torch.layers import ssm as tssm
from repro_torch.models import transformer as ttfm
from repro_torch.serving import batcher as tbatcher
from tests.test_torch_lm_families import (
    TOL_BF16, TOL_LAYER, TOL_PRIM, cfgs, check_batcher_tokens,
    check_decode_matches_forward, check_decode_steps, check_forward,
    check_params_bit_exact, check_prefill, check_serve_tokens, close_rel,
    f32_caches, jax_layers, jparams, leaves, port_params, rand, tokens)

ARCHS = ("recurrentgemma-2b", "mamba2-130m")
# sequence lengths: past recurrentgemma's window of 8, no multiple of
# mamba2's ssm_chunk of 16 (21 = one chunk and a ragged one)
SEQ = {"recurrentgemma-2b": 13, "mamba2-130m": 21}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _mixer(arch, key):
    """Layer 0's mixer params in f32: JAX's and the port's."""
    jc = cfgs(arch)[0]
    jp = jax_layers(jparams(arch)[1]["stages"], jc)[0][key]
    tp = port_params(arch, jparams(arch)[1])["layers"][0][key]
    return jax.tree.map(jnp.asarray, jp), tp


# ---------------------------------------------------------------------------
# configs and params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["config", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_match_jax(arch, which):
    fn = "get_config" if which == "config" else "get_reduced"
    jc, tc = getattr(jregistry, fn)(arch), getattr(tregistry, fn)(arch)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert (jc.padded_vocab, jc.total_layers()) == \
        (tc.padded_vocab, tc.total_layers())
    ttfm.check_supported(tc)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_bit_exact(arch):
    check_params_bit_exact(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_jax_tree(arch):
    """The port's seeded init has JAX's tree, shapes and dtypes: an
    ``ssd`` layer is mixer-only (no ``ln2``/``mlp``)."""
    jc, tc = cfgs(arch)
    tp = ttfm.init(tc, seed=0, device="cpu")
    jl = jax_layers(jparams(arch)[0]["stages"], jc)
    for layer, jlayer in zip(tp["layers"], jl):
        assert [(p, tuple(t.shape), str(t.dtype)[6:])
                for p, t in leaves(layer)] == \
            [(p, a.shape, a.dtype.name) for p, a in leaves(jlayer)]
    if arch == "mamba2-130m":
        assert all(set(layer) == {"ln1", "ssd"} for layer in tp["layers"])


# ---------------------------------------------------------------------------
# the RG-LRU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [1, 7, 16, 37])
def test_linear_scan_matches_a_loop_and_jax(s):
    """The log-step scan against h_t = a_t h_{t-1} + b_t step by step and
    against JAX's ``associative_scan`` with the same combine, at decays
    as small as RG-LRU's (a = e^-17)."""
    rng = np.random.default_rng(s)
    a = np.exp(-rng.uniform(0, 17, (2, s, 5))).astype(np.float32)
    b = rng.standard_normal((2, s, 5)).astype(np.float32)
    got = trglru.linear_scan(_t(a), _t(b)).numpy()
    h, want = np.zeros((2, 5), np.float64), []
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    np.testing.assert_allclose(got, np.stack(want, 1), rtol=1e-5,
                               atol=TOL_PRIM)
    _, jh = jax.jit(lambda a, b: jax.lax.associative_scan(
        lambda l, r: (l[0] * r[0], l[1] * r[0] + r[1]), (a, b), axis=1))(
        jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(got, np.asarray(jh), rtol=1e-5, atol=TOL_PRIM)


@pytest.mark.parametrize("s", [2, 13])
def test_rglru_apply_matches_jax(s):
    """A sequence shorter than the conv window (4) and one past it."""
    jc, tc = cfgs("recurrentgemma-2b")
    jp, tp = _mixer("recurrentgemma-2b", "rec")
    x = rand((2, s, jc.d_model), 40)
    want = jax.jit(lambda p, x: jrglru.rglru_apply(p, x, jc))(
        jp, jnp.asarray(x))
    got = trglru.rglru_apply(tp, _t(x), tc)
    close_rel(got.numpy(), want, TOL_LAYER)


def test_rglru_decode_matches_jax_in_place():
    """Three decode steps: the output, and the state the port writes into
    the tensors it was given (JAX returns new ones)."""
    jc, tc = cfgs("recurrentgemma-2b")
    jp, tp = _mixer("recurrentgemma-2b", "rec")
    h0 = rand((2, jc.lru_width), 42)
    c0 = rand((2, jc.conv_width - 1, jc.lru_width), 43)
    jstate = {"h": jnp.asarray(h0), "conv": jnp.asarray(c0)}
    tstate = {"h": _t(h0.copy()), "conv": _t(c0.copy())}
    ptrs = {k: v.data_ptr() for k, v in tstate.items()}
    jdecode = jax.jit(lambda p, x, st: jrglru.rglru_decode(p, x, st, jc))
    for i in range(3):
        x = rand((2, 1, jc.d_model), 44 + i)
        want, jstate = jdecode(jp, jnp.asarray(x), jstate)
        got, out_state = trglru.rglru_decode(tp, _t(x), tstate, tc)
        assert out_state is tstate
        assert {k: v.data_ptr() for k, v in tstate.items()} == ptrs
        close_rel(got.numpy(), want, TOL_LAYER)
        for k in ("h", "conv"):
            close_rel(tstate[k].numpy(), jstate[k], TOL_PRIM)


# ---------------------------------------------------------------------------
# SSD
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,chunk,groups", [(32, 16, 1), (21, 16, 1),
                                            (5, 16, 1), (19, 8, 2)])
def test_ssd_chunked_matches_jax(s, chunk, groups):
    """Whole chunks, a ragged last chunk, one short chunk, and two groups
    over four heads."""
    rng = np.random.default_rng(s)
    h, p, n = 4, 8, 6
    x = rng.standard_normal((2, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (2, s, h)).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 16.0, h)).astype(np.float32)
    b = rng.standard_normal((2, s, groups, n)).astype(np.float32)
    c = rng.standard_normal((2, s, groups, n)).astype(np.float32)
    d = rng.standard_normal((h,)).astype(np.float32)
    want = jax.jit(lambda *args: jssm.ssd_chunked(*args, chunk=chunk))(
        *map(jnp.asarray, (x, dt, a_log, b, c, d)))
    got = tssm.ssd_chunked(*map(_t, (x, dt, a_log, b, c, d)), chunk=chunk)
    assert got.dtype == torch.float32
    close_rel(got.numpy(), want, TOL_LAYER)


@pytest.mark.parametrize("s", [21, 32])
def test_ssd_apply_matches_jax(s):
    jc, tc = cfgs("mamba2-130m")
    jp, tp = _mixer("mamba2-130m", "ssd")
    x = rand((2, s, jc.d_model), 50)
    want = jax.jit(lambda p, x: jssm.ssd_apply(p, x, jc))(jp,
                                                           jnp.asarray(x))
    got = tssm.ssd_apply(tp, _t(x), tc)
    close_rel(got.numpy(), want, TOL_LAYER)


def test_ssd_decode_matches_jax_in_place():
    jc, tc = cfgs("mamba2-130m")
    jp, tp = _mixer("mamba2-130m", "ssd")
    di, h, n = jc.d_inner, jc.ssm_heads, jc.ssm_state
    h0 = rand((2, h, n, di // h), 51)
    c0 = rand((2, jc.ssm_conv - 1, di + 2 * jc.ssm_groups * n), 52)
    jstate = {"h": jnp.asarray(h0), "conv": jnp.asarray(c0)}
    tstate = {"h": _t(h0.copy()), "conv": _t(c0.copy())}
    ptrs = {k: v.data_ptr() for k, v in tstate.items()}
    jdecode = jax.jit(lambda p, x, st: jssm.ssd_decode(p, x, st, jc))
    for i in range(3):
        x = rand((2, 1, jc.d_model), 53 + i)
        want, jstate = jdecode(jp, jnp.asarray(x), jstate)
        got, out_state = tssm.ssd_decode(tp, _t(x), tstate, tc)
        assert out_state is tstate
        assert {k: v.data_ptr() for k, v in tstate.items()} == ptrs
        close_rel(got.numpy(), want, TOL_LAYER)
        for k in ("h", "conv"):
            close_rel(tstate[k].numpy(), jstate[k], TOL_PRIM)


def test_ssd_decode_continues_the_chunked_prefill():
    """The state the chunked SSD carries is the recurrence decode runs:
    a prefill of S tokens through ``ssd_apply`` and S decode steps give
    the same outputs, across the ragged chunk boundary."""
    tc = cfgs("mamba2-130m")[1]
    _, tp = _mixer("mamba2-130m", "ssd")
    x = _t(rand((1, 21, tc.d_model), 56))
    full = tssm.ssd_apply(tp, x, tc)
    state = ttfm.init_cache_layer("ssd", tc, 1, 1, torch.float32, "cpu")
    steps = [tssm.ssd_decode(tp, x[:, t:t + 1], state, tc)[0]
             for t in range(21)]
    close_rel(torch.cat(steps, 1).numpy(), full.numpy(), TOL_LAYER)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch, which):
    check_forward(arch, which, SEQ[arch])


@pytest.mark.parametrize("which", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_matches_jax(arch, which):
    check_prefill(arch, which, SEQ[arch])


@pytest.mark.parametrize("which", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(arch, which):
    check_decode_steps(arch, which)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    check_decode_matches_forward(arch, SEQ[arch])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_writes_the_state_in_place(arch):
    """``decode_step`` moves every recurrent state forward in the tensors
    it was given (a captured slot graph replays on them) and returns the
    same list of dicts."""
    tc = cfgs(arch)[1]
    tp = port_params(arch, jparams(arch)[0])
    cache = ttfm.init_cache(tc, 1, 4, device="cpu")
    ptrs = [{k: t.data_ptr() for k, t in c.items()} for c in cache]
    tok = torch.tensor([[3]])
    _, out = ttfm.decode_step(tp, cache, tok, 0, tc)
    assert [{k: t.data_ptr() for k, t in c.items()} for c in out] == ptrs
    for c, kind in zip(cache, ttfm.layer_kinds(tc)):
        if kind in ("rec", "ssd"):
            assert c["h"].dtype == torch.float32
            assert bool(c["h"].abs().sum() > 0)
            assert bool(c["conv"][:, -1].float().abs().sum() > 0)


# ---------------------------------------------------------------------------
# serving (f32 params on f32 caches: see check_decode_steps)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_serve_tokens_match_jax(arch, monkeypatch):
    f32_caches(monkeypatch)
    check_serve_tokens(arch, monkeypatch)


@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_batcher_tokens_match_jax(arch, monkeypatch):
    f32_caches(monkeypatch)
    check_batcher_tokens(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_reset_slot_zeroes_the_recurrent_state(arch):
    tc = cfgs(arch)[1]
    tp = port_params(arch, jparams(arch)[0])
    cb = tbatcher.ContinuousBatcher(tc, tp, slots=2, max_len=8,
                                    device="cpu")
    cb.submit(tbatcher.Request(rid=0, prompt=np.array([1, 2, 3]),
                               max_new=4))
    cb.step()
    cb.step()
    live = [t for c in cb.slot_caches[0] for t in c.values()]
    assert any(bool(t.float().abs().sum() > 0) for t in live)
    cb.reset_slot(0)
    assert all(not bool(t.float().abs().sum() > 0) for t in live)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_on_cpu(arch, capsys):
    gen = tserve.main(["--arch", arch, "--device", "cpu", "--tokens", "3",
                       "--batch", "2"])
    assert gen.shape == (2, 3)
    assert f"arch={arch} device=cpu" in capsys.readouterr().out


def test_bf16_decode_is_close_to_f32():
    """recurrentgemma's bf16 caches (JAX's default dtype) keep decode
    within the bf16 tolerance of the f32 run over 6 steps."""
    tc = cfgs("recurrentgemma-2b")[1]
    toks = torch.from_numpy(tokens(2, 6, tc.vocab_size, 57)).long()
    outs = {}
    for which, idx, dt in (("f32", 1, torch.float32),
                           ("bf16", 0, torch.bfloat16)):
        tp = port_params("recurrentgemma-2b",
                         jparams("recurrentgemma-2b")[idx])
        cache = ttfm.init_cache(tc, 2, 8, dtype=dt, device="cpu")
        lg = [ttfm.decode_step(tp, cache, toks[:, t:t + 1], t, tc)[0]
              for t in range(6)]
        outs[which] = torch.cat(lg, 1).numpy()
    close_rel(outs["bf16"], outs["f32"], TOL_BF16)
