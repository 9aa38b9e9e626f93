"""The port's LM serving slice against the JAX package on the CPU, on the
reduced llama3.2-1b with JAX's own weights (``params_from_jax``): configs,
the layer primitives, the GQA layer and its decode, ``forward`` in f32 and
bf16, the prefill step, ``decode_step``, and the greedy tokens of
``serve``'s loop and of ``ContinuousBatcher``.  Inputs are drawn with numpy
from fixed seeds.  On the CPU the attention core is kernel F's plain
version; the kernel itself is tested on the card
(``tests/test_torch_cuda.py``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import registry as jregistry
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.layers import attention as jattn
from repro.layers import common as jcm
from repro.layers import mlp as jmlp
from repro.layers import rope as jrope
from repro.models import transformer as jtfm
from repro.serving import batcher as jbatcher
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as tregistry
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.layers import attention as tattn
from repro_torch.layers import common as tcm
from repro_torch.layers import mlp as tmlp
from repro_torch.layers import rope as trope
from repro_torch.models import transformer as ttfm
from repro_torch.serving import batcher as tbatcher

ARCH = "llama3.2-1b"
TOL_PRIM = 1e-6             # f32 layer primitives
TOL_LAYER = 1e-5            # f32 attention layer, relative to max|y|
TOL_MODEL = 1e-4            # f32 logits, relative to max|logits|
TOL_BF16 = 3e-2             # test_arch_smoke.py's bf16 tolerance


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def cfgs():
    return jregistry.get_reduced(ARCH), tregistry.get_reduced(ARCH)


@pytest.fixture(scope="module")
def jparams(cfgs):
    """JAX's bf16 params and their f32 cast."""
    params, _ = jtfm.init(jax.random.PRNGKey(0), cfgs[0])
    return params, jax.tree.map(lambda a: a.astype(jnp.float32), params)


def port_params(jp):
    return ttfm.params_from_jax(jax.tree.map(np.asarray, jp),
                                tregistry.get_reduced(ARCH), "cpu")


def tokens(b, s, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, s),
                                                dtype=np.int32)


def close_rel(got, want, tol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), err


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["config", "reduced"])
def test_config_fields_match_jax(which):
    fn = "get_config" if which == "config" else "get_reduced"
    jc, tc = getattr(jregistry, fn)(ARCH), getattr(tregistry, fn)(ARCH)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert (jc.padded_vocab, jc.total_layers()) == \
        (tc.padded_vocab, tc.total_layers())
    assert set(tregistry.ARCH_IDS) <= set(jregistry.ARCH_IDS)


def test_schema_helpers_match_jax():
    assert [f.name for f in dataclasses.fields(jbase.ModelConfig)] == \
        [f.name for f in dataclasses.fields(tbase.ModelConfig)]
    assert {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in tbase.SHAPES.items()}
    assert jbase.uniform_stages("attn", 3) == tbase.uniform_stages("attn", 3)
    for n in (5, 6, 7, 26):
        pat = ("local",) * 5 + ("global",)
        assert jbase.patterned_stages(pat, n) == \
            tbase.patterned_stages(pat, n)


def test_unported_kinds_raise(cfgs):
    """The encoder-decoder's kinds initialise (``enc`` layers in
    ``enc_layers``, a ``dec`` layer with ``lnx`` and ``cross``); a kind
    or a frontend the port does not know still raises."""
    encdec = dataclasses.replace(
        cfgs[1], stages=tbase.uniform_stages("dec", 2),
        encoder_stages=tbase.uniform_stages("enc", 1),
        is_encoder_decoder=True)
    p = ttfm.init(encdec, device="cpu")
    assert [sorted(layer) for layer in p["layers"]] == \
        [["attn", "cross", "ln1", "ln2", "lnx", "mlp"]] * 2
    assert len(p["enc_layers"]) == 1 and "cross" not in p["enc_layers"][0]
    with pytest.raises(NotImplementedError, match="swin not known"):
        ttfm.init(dataclasses.replace(
            cfgs[1], stages=tbase.uniform_stages("swin", 2)), device="cpu")
    with pytest.raises(NotImplementedError, match="frontend=video"):
        ttfm.init(dataclasses.replace(cfgs[1], frontend="video"),
                  device="cpu")


# ---------------------------------------------------------------------------
# params and primitives
# ---------------------------------------------------------------------------

def test_params_from_jax_bit_exact(jparams, cfgs):
    jp = jparams[0]
    tp = port_params(jp)
    assert len(tp["layers"]) == cfgs[1].num_layers

    def bits(t):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()

    def jbits(a):
        a = np.asarray(a)
        return a.view(np.uint16) if a.dtype.name == "bfloat16" else a

    assert tp["embed"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(bits(tp["embed"]["w"]),
                                  jbits(jp["embed"]["w"]))
    np.testing.assert_array_equal(bits(tp["final_norm"]["g"]),
                                  jbits(jp["final_norm"]["g"]))
    stage = jp["stages"][0]["l0"]
    for r, layer in enumerate(tp["layers"]):
        for path in (("ln1", "g"), ("ln2", "g"), ("attn", "q", "w"),
                     ("attn", "k", "w"), ("attn", "v", "w"),
                     ("attn", "o", "w"), ("mlp", "wi", "w"),
                     ("mlp", "wg", "w"), ("mlp", "wo", "w")):
            t, a = layer, stage
            for key in path:
                t, a = t[key], a[key]
            np.testing.assert_array_equal(bits(t), jbits(np.asarray(a)[r]))


def rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("gemma", [False, True])
def test_rmsnorm_matches_jax(gemma):
    x, g = rand((2, 5, 64), 1), rand((64,), 2)
    want = jcm.rmsnorm_apply({"g": jnp.asarray(g)}, jnp.asarray(x), 1e-5,
                             gemma_style=gemma)
    got = tcm.rmsnorm_apply({"g": torch.from_numpy(g)}, torch.from_numpy(x),
                            1e-5, gemma_style=gemma)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL_PRIM,
                               atol=TOL_PRIM)


def test_apply_rope_matches_jax():
    x = rand((2, 7, 4, 16), 3)
    pos = np.tile(np.arange(7, dtype=np.int32), (2, 1)) + np.array(
        [[0], [5]], np.int32)
    want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), 5e5)
    got = trope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 5e5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL_PRIM,
                               atol=TOL_PRIM)


@pytest.mark.parametrize("bias", [False, True])
def test_dense_apply_matches_jax(bias):
    p = {"w": rand((64, 48), 4)}
    if bias:
        p["b"] = rand((48,), 5)
    x = rand((3, 5, 64), 6)
    want = jcm.dense_apply({k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(x))
    got = tcm.dense_apply({k: torch.from_numpy(v) for k, v in p.items()},
                          torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL_PRIM,
                               atol=TOL_PRIM)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_glu_and_mlp_apply_match_jax(act):
    p = {"wi": {"w": rand((32, 48), 7) * 0.2},
         "wg": {"w": rand((32, 48), 8) * 0.2},
         "wo": {"w": rand((48, 32), 9) * 0.2}}
    x = rand((2, 5, 32), 10)
    jp = jax.tree.map(jnp.asarray, p)
    tp = {k: {"w": torch.from_numpy(v["w"])} for k, v in p.items()}
    np.testing.assert_allclose(
        tmlp.glu_apply(tp, torch.from_numpy(x), act).numpy(),
        np.asarray(jmlp.glu_apply(jp, jnp.asarray(x), act)),
        rtol=TOL_PRIM, atol=TOL_PRIM)
    np.testing.assert_allclose(
        tmlp.mlp_apply(tp, torch.from_numpy(x), act).numpy(),
        np.asarray(jmlp.mlp_apply(jp, jnp.asarray(x), act)),
        rtol=TOL_PRIM, atol=TOL_PRIM)


# ---------------------------------------------------------------------------
# the GQA layer
# ---------------------------------------------------------------------------

def _layer_params(jparams, layer=0):
    jp32 = jax.tree.map(lambda a: a[layer], jparams[1]["stages"][0]["l0"])
    tp = port_params(jparams[1])["layers"][layer]
    return jp32, tp


def test_gqa_apply_matches_jax(jparams, cfgs):
    jp, tp = _layer_params(jparams)
    x = rand((2, 11, cfgs[0].d_model), 11)
    pos = np.tile(np.arange(11, dtype=np.int32), (2, 1))
    want = jattn.gqa_apply(jp["attn"], jnp.asarray(x), cfgs[0],
                           positions=jnp.asarray(pos), kv_chunk=4)
    got = tattn.gqa_apply(tp["attn"], torch.from_numpy(x), cfgs[1],
                          positions=torch.from_numpy(pos), kv_chunk=4)
    close_rel(got.numpy(), want, TOL_LAYER)


def test_gqa_decode_matches_jax(jparams, cfgs):
    jp, tp = _layer_params(jparams, 1)
    jc, tc = cfgs
    shape = (2, 8, jc.num_kv_heads, jc.head_dim)
    k0, v0 = rand(shape, 12), rand(shape, 13)
    jcache = {"k": jnp.asarray(k0), "v": jnp.asarray(v0)}
    tcache = {"k": torch.from_numpy(k0.copy()),
              "v": torch.from_numpy(v0.copy())}
    for idx in (0, 3, 7):
        x = rand((2, 1, jc.d_model), 14 + idx)
        want, jcache = jattn.gqa_decode(jp["attn"], jnp.asarray(x), jcache,
                                        idx, jc)
        got, tcache = tattn.gqa_decode(tp["attn"], torch.from_numpy(x),
                                       tcache, idx, tc)
        close_rel(got.numpy(), want, TOL_LAYER)
        close_rel(tcache["k"].numpy(), jcache["k"], TOL_PRIM)
        close_rel(tcache["v"].numpy(), jcache["v"], TOL_PRIM)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_forward_f32_matches_jax(jparams, cfgs):
    toks = tokens(2, 13, cfgs[0].vocab_size, 20)
    want = jtfm.forward(jparams[1], {"inputs": jnp.asarray(toks)}, cfgs[0],
                        kv_chunk=4)
    got = ttfm.forward(port_params(jparams[1]),
                       {"inputs": torch.from_numpy(toks).long()}, cfgs[1],
                       kv_chunk=4)
    assert got.dtype == torch.float32
    close_rel(got.numpy(), want, TOL_MODEL)


def test_forward_bf16_matches_jax(jparams, cfgs):
    toks = tokens(2, 16, cfgs[0].vocab_size, 21)
    want = jtfm.forward(jparams[0], {"inputs": jnp.asarray(toks)}, cfgs[0],
                        kv_chunk=8)
    got = ttfm.forward(port_params(jparams[0]),
                       {"inputs": torch.from_numpy(toks).long()}, cfgs[1],
                       kv_chunk=8)
    # relative to max|logits|, as the f32 check: element by element, 3 of
    # these 16384 logits sit 0.039 off (max|logits| 3.78), at the bf16 noise
    # floor of the comparison: JAX's forward with its jnp core and with its
    # Pallas kernel F as the core sit 0.044 apart on the same inputs (the
    # jnp core rounds P to bf16 before P.V; F, and so the port, do not)
    close_rel(got.numpy(), want, TOL_BF16)


@pytest.mark.parametrize("which", ["f32", "bf16"])
def test_prefill_step_matches_jax(jparams, cfgs, which):
    jp = jparams[1] if which == "f32" else jparams[0]
    toks = tokens(3, 9, cfgs[0].vocab_size, 22)
    want = jsteps.make_prefill_step(cfgs[0], None, kv_chunk=4)(
        jp, {"inputs": jnp.asarray(toks)})
    got = tsteps.make_prefill_step(cfgs[1], kv_chunk=4)(
        port_params(jp), {"inputs": torch.from_numpy(toks).long()})
    assert got.shape == (3, cfgs[1].padded_vocab)
    if which == "f32":
        close_rel(got.numpy(), want, TOL_MODEL)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                                   rtol=TOL_BF16, atol=TOL_BF16)


def test_decode_steps_match_jax(jparams, cfgs):
    jc, tc = cfgs
    toks = tokens(2, 6, jc.vocab_size, 23)
    jcache, _ = jtfm.init_cache(jc, 2, 8)
    tcache = ttfm.init_cache(tc, 2, 8, device="cpu")
    tp = port_params(jparams[1])
    for i in range(6):
        want, jcache = jtfm.decode_step(jparams[1], jcache,
                                        jnp.asarray(toks[:, i:i + 1]), i, jc)
        got, tcache = ttfm.decode_step(
            tp, tcache, torch.from_numpy(toks[:, i:i + 1]).long(), i, tc)
        close_rel(got.numpy(), want, TOL_MODEL)


def test_decode_matches_forward(jparams, cfgs):
    """Token-by-token decode (an f32 cache) gives the teacher-forced
    logits."""
    tc = cfgs[1]
    tp = port_params(jparams[1])
    toks = torch.from_numpy(tokens(2, 7, tc.vocab_size, 24)).long()
    full = ttfm.forward(tp, {"inputs": toks}, tc, kv_chunk=4)
    cache = ttfm.init_cache(tc, 2, 8, dtype=torch.float32, device="cpu")
    outs = []
    for t in range(7):
        lg, cache = ttfm.decode_step(tp, cache, toks[:, t:t + 1], t, tc)
        outs.append(lg[:, 0])
    close_rel(torch.stack(outs, 1).numpy(), full.numpy(), TOL_MODEL)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_serve_tokens_match_jax(jparams, cfgs, monkeypatch):
    """JAX's ``serve`` on the same f32 params and prompt (its init and its
    prompt draw replaced by them) and the port's give the same tokens."""
    batch, plen, gen = 3, 5, 6
    prompt = tokens(batch, plen, cfgs[0].vocab_size, 25)
    monkeypatch.setattr(jtfm, "init", lambda key, cfg: (jparams[1], None))
    monkeypatch.setattr(jax.random, "randint",
                        lambda *a, **k: jnp.asarray(prompt))
    want, _ = jserve.serve(ARCH, batch=batch, prompt_len=plen,
                           gen_tokens=gen)
    got, _ = tserve.serve(ARCH, batch=batch, prompt_len=plen,
                          gen_tokens=gen, device="cpu",
                          params=port_params(jparams[1]), prompt=prompt)
    assert got.shape == (batch, gen)
    np.testing.assert_array_equal(got, np.asarray(want))


def _requests(mod, vocab):
    rng = np.random.default_rng(26)
    lens, news = (3, 5, 2, 4, 6, 3), (4, 2, 5, 3, 1, 6)
    return [mod.Request(rid=i, prompt=rng.integers(0, vocab, (p,),
                                                   dtype=np.int32),
                        max_new=n) for i, (p, n) in enumerate(zip(lens, news))]


def test_continuous_batcher_tokens_match_jax(jparams, cfgs):
    """6 requests over 4 slots: each request's greedy tokens equal JAX's
    batcher's on the same f32 params, and its own one-request run's."""
    jc, tc = cfgs
    jb = jbatcher.ContinuousBatcher(jc, jparams[1], slots=4, max_len=16)
    tp = port_params(jparams[1])
    tb = tbatcher.ContinuousBatcher(tc, tp, slots=4, max_len=16,
                                    device="cpu")
    for r in _requests(jbatcher, jc.vocab_size):
        jb.submit(r)
    reqs = _requests(tbatcher, tc.vocab_size)
    for r in reqs:
        tb.submit(r)
    assert tb.run() == jb.run()
    want = {r.rid: r.out for r in jb.done}
    got = {r.rid: r.out for r in tb.done}
    assert got == want
    lone = tbatcher.ContinuousBatcher(tc, tp, slots=1, max_len=16,
                                      device="cpu")
    r = _requests(tbatcher, tc.vocab_size)[4]
    lone.submit(r)
    lone.run()
    assert r.out == got[4]
    st = tb.stats()
    assert st["completed"] == 6
    assert {"p50_ms", "p95_ms", "p50_ttft_s", "ttft_p95_ms"} <= set(st)


def test_serve_cli_on_cpu(capsys):
    gen = tserve.main(["--device", "cpu", "--tokens", "4", "--batch", "2"])
    assert gen.shape == (2, 4)
    assert "device=cpu" in capsys.readouterr().out


def test_serve_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.serve(ARCH, device="cuda")
