"""The port's dense LM families against the JAX package on the CPU:
gemma3-1b (local/global layers, the gemma norm, sandwich norms, qk-norm,
the tanh GELU), qwen2-7b (qkv bias), glm4-9b (plain GQA) and qwen2-vl-2b
(M-RoPE and the ``vlm_stub`` frontend's embeddings), each at JAX's
``reduced()`` config with JAX's own weights (``params_from_jax``):
configs, params bit for bit, ``forward`` in f32 and bf16, the prefill
step, three decode steps and their caches, decode against forward, and
the greedy tokens of ``serve`` and ``ContinuousBatcher``.  Inputs are
drawn with numpy from fixed seeds; the tolerances and the comparison
helpers are ``tests/test_torch_lm.py``'s.  The helpers here also serve
``tests/test_torch_lm_recurrent.py`` (recurrentgemma-2b, mamba2-130m).
On the CPU the attention core is kernel F's plain version; the kernel
itself is tested on the card (``tests/test_torch_cuda.py``)."""
import dataclasses
import functools

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
from repro.layers import rope as jrope
from repro.models import transformer as jtfm
from repro.serving import batcher as jbatcher
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as tregistry
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.layers import attention as tattn
from repro_torch.layers import rope as trope
from repro_torch.models import transformer as ttfm
from repro_torch.serving import batcher as tbatcher
from tests.test_torch_lm import (TOL_BF16, TOL_LAYER, TOL_MODEL, TOL_PRIM,
                                 close_rel, rand, tokens)

ARCHS = ("gemma3-1b", "qwen2-7b", "glm4-9b", "qwen2-vl-2b")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


# ---------------------------------------------------------------------------
# helpers (shared with tests/test_torch_lm_recurrent.py)
# ---------------------------------------------------------------------------

def cfgs(arch):
    return jregistry.get_reduced(arch), tregistry.get_reduced(arch)


@functools.cache
def jparams(arch):
    """JAX's bf16 params at the reduced config and their f32 cast."""
    params, _ = jtfm.init(jax.random.PRNGKey(0), cfgs(arch)[0])
    return params, jax.tree.map(lambda a: a.astype(jnp.float32), params)


def port_params(arch, jp):
    return ttfm.params_from_jax(jax.tree.map(np.asarray, jp),
                                tregistry.get_reduced(arch), "cpu")


def bits(t):
    """A tensor's or an array's bits (bf16 as uint16)."""
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    a = np.asarray(t)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def jax_layers(stages, cfg):
    """JAX's stacked stages (params or caches) unstacked into the port's
    layer order: one dict of numpy arrays a layer."""
    out = []
    for (kinds, reps), stage in zip(cfg.stages, stages):
        for r in range(reps):
            for i in range(len(kinds)):
                out.append(jax.tree.map(lambda a, r=r: np.asarray(a)[r],
                                        stage[f"l{i}"]))
    return out


def check_params_bit_exact(arch):
    jp = jparams(arch)[0]
    jc, tc = cfgs(arch)
    tp = port_params(arch, jp)
    assert len(tp["layers"]) == tc.num_layers
    for key in ("embed", "final_norm", "head"):
        assert (key in tp) == (key in jp)
        if key in jp:
            for (path, t), (jpath, a) in zip(leaves(tp[key]),
                                             leaves(jp[key])):
                assert path == jpath
                np.testing.assert_array_equal(bits(t), bits(a))
    for layer, jlayer in zip(tp["layers"], jax_layers(jp["stages"], jc)):
        tl, jl = list(leaves(layer)), list(leaves(jlayer))
        assert [p for p, _ in tl] == [p for p, _ in jl]
        for (path, t), (_, a) in zip(tl, jl):
            assert t.dtype == {"bfloat16": torch.bfloat16,
                               "float32": torch.float32}[a.dtype.name], path
            np.testing.assert_array_equal(bits(t), bits(a))


def check_forward(arch, which, s, kv_chunk=4):
    jc, tc = cfgs(arch)
    jp = jparams(arch)[1 if which == "f32" else 0]
    toks = tokens(2, s, jc.vocab_size, 20)
    want = jax.jit(lambda p, t: jtfm.forward(p, {"inputs": t}, jc,
                                             kv_chunk=kv_chunk))(
        jp, jnp.asarray(toks))
    got = ttfm.forward(port_params(arch, jp),
                       {"inputs": torch.from_numpy(toks).long()}, tc,
                       kv_chunk=kv_chunk)
    assert got.dtype == torch.float32
    close_rel(got.numpy(), want, TOL_MODEL if which == "f32" else TOL_BF16)


def check_prefill(arch, which, s):
    jc, tc = cfgs(arch)
    jp = jparams(arch)[1 if which == "f32" else 0]
    toks = tokens(3, s, jc.vocab_size, 22)
    want = jax.jit(jsteps.make_prefill_step(jc, None, kv_chunk=4))(
        jp, {"inputs": jnp.asarray(toks)})
    got = tsteps.make_prefill_step(tc, kv_chunk=4)(
        port_params(arch, jp), {"inputs": torch.from_numpy(toks).long()})
    assert got.shape == (3, tc.padded_vocab)
    # bf16 relative to max|logits|, as the bf16 forward.  Element by
    # element at test_torch_lm.py's rtol = atol = TOL_BF16 four of the six
    # archs hold; gemma3-1b (logits to 6.8, the sqrt(d) embedding scale)
    # sits 0.082 off JAX where JAX's own bf16 prefill sits 0.076 off its
    # f32 one, recurrentgemma-2b 0.135 where JAX's sits 0.110: the bf16
    # rounding of either package, not a fault of the port
    close_rel(got.numpy(), want, TOL_MODEL if which == "f32" else TOL_BF16)


def check_decode_steps(arch, which, steps=3):
    """``steps`` decode steps of JAX and of the port from zeroed caches of
    the params' dtype: the logits and every cache tensor after each step
    (JAX's stacked caches unstacked).  One dtype for params and caches: a
    recurrent state JAX is handed in bf16 comes back in f32 from f32
    params (``jnp.concatenate`` promotes), where the port writes its
    cache in place in the cache's dtype."""
    jc, tc = cfgs(arch)
    jp = jparams(arch)[1 if which == "f32" else 0]
    jdt, tdt = ((jnp.float32, torch.float32) if which == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    tol = TOL_MODEL if which == "f32" else TOL_BF16
    toks = tokens(2, steps, jc.vocab_size, 23)
    jcache, _ = jtfm.init_cache(jc, 2, 8, jdt)
    tcache = ttfm.init_cache(tc, 2, 8, dtype=tdt, device="cpu")
    tp = port_params(arch, jp)
    jstep = jax.jit(lambda p, c, t, i: jtfm.decode_step(p, c, t, i, jc))
    for i in range(steps):
        want, jcache = jstep(jp, jcache, jnp.asarray(toks[:, i:i + 1]), i)
        got, tcache = ttfm.decode_step(
            tp, tcache, torch.from_numpy(toks[:, i:i + 1]).long(), i, tc)
        close_rel(got.numpy(), want, tol)
        for tl, jl in zip(tcache, jax_layers(jcache, jc)):
            assert sorted(tl) == sorted(jl)
            for key in tl:
                assert tl[key].dtype == (torch.float32 if key == "h"
                                         else tdt)
                close_rel(tl[key].float().numpy(), jl[key],
                          TOL_PRIM if which == "f32" else tol)


def check_decode_matches_forward(arch, s):
    """Token-by-token decode (f32 caches) gives the teacher-forced
    logits."""
    tc = cfgs(arch)[1]
    tp = port_params(arch, jparams(arch)[1])
    toks = torch.from_numpy(tokens(2, s, tc.vocab_size, 24)).long()
    full = ttfm.forward(tp, {"inputs": toks}, tc, kv_chunk=4)
    cache = ttfm.init_cache(tc, 2, s + 1, dtype=torch.float32, device="cpu")
    outs = []
    for t in range(s):
        lg, cache = ttfm.decode_step(tp, cache, toks[:, t:t + 1], t, tc)
        outs.append(lg[:, 0])
    close_rel(torch.stack(outs, 1).numpy(), full.numpy(), TOL_MODEL)


def f32_caches(monkeypatch):
    """Both packages' ``init_cache`` at f32: the serving loops then
    decode f32 params on caches of their own dtype (see
    ``check_decode_steps``)."""
    jinit, tinit = jtfm.init_cache, ttfm.init_cache
    monkeypatch.setattr(jtfm, "init_cache",
                        lambda cfg, b, n, dtype=None: jinit(cfg, b, n,
                                                            jnp.float32))
    monkeypatch.setattr(ttfm, "init_cache",
                        lambda *a, **k: tinit(*a, **{**k,
                                                     "dtype": torch.float32}))


def check_serve_tokens(arch, monkeypatch):
    """JAX's ``serve`` on the same f32 params and prompt (its init and its
    prompt draw replaced by them) and the port's give the same tokens."""
    jc = cfgs(arch)[0]
    jp = jparams(arch)[1]
    batch, plen, gen = 3, 5, 6
    prompt = tokens(batch, plen, jc.vocab_size, 25)
    monkeypatch.setattr(jtfm, "init", lambda key, cfg: (jp, None))
    monkeypatch.setattr(jax.random, "randint",
                        lambda *a, **k: jnp.asarray(prompt))
    want, _ = jserve.serve(arch, batch=batch, prompt_len=plen,
                           gen_tokens=gen)
    got, _ = tserve.serve(arch, batch=batch, prompt_len=plen,
                          gen_tokens=gen, device="cpu",
                          params=port_params(arch, jp), prompt=prompt)
    assert got.shape == (batch, gen)
    np.testing.assert_array_equal(got, np.asarray(want))


def _requests(mod, vocab):
    rng = np.random.default_rng(26)
    lens, news = (3, 5, 2, 4, 6), (4, 2, 5, 3, 4)
    return [mod.Request(rid=i, prompt=rng.integers(0, vocab, (p,),
                                                   dtype=np.int32),
                        max_new=n) for i, (p, n) in enumerate(zip(lens, news))]


def check_batcher_tokens(arch):
    """5 requests over 4 slots: each request's greedy tokens equal JAX's
    batcher's on the same f32 params, and its own one-request run's."""
    jc, tc = cfgs(arch)
    jp = jparams(arch)[1]
    jb = jbatcher.ContinuousBatcher(jc, jp, slots=4, max_len=12)
    tp = port_params(arch, jp)
    tb = tbatcher.ContinuousBatcher(tc, tp, slots=4, max_len=12,
                                    device="cpu")
    for r in _requests(jbatcher, jc.vocab_size):
        jb.submit(r)
    for r in _requests(tbatcher, tc.vocab_size):
        tb.submit(r)
    assert tb.run() == jb.run()
    want = {r.rid: r.out for r in jb.done}
    got = {r.rid: r.out for r in tb.done}
    assert got == want
    lone = tbatcher.ContinuousBatcher(tc, tp, slots=1, max_len=12,
                                      device="cpu")
    r = _requests(tbatcher, tc.vocab_size)[4]
    lone.submit(r)
    lone.run()
    assert r.out == got[4]


# ---------------------------------------------------------------------------
# configs
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


def test_registry_and_shape_applicable_match_jax():
    assert set(tregistry.ARCH_IDS) == set(jregistry.ARCH_IDS)
    for arch in tregistry.ARCH_IDS:
        for shape in jbase.SHAPES:
            assert tregistry.shape_applicable(
                tregistry.get_config(arch), tbase.SHAPES[shape]) == \
                jregistry.shape_applicable(jregistry.get_config(arch),
                                           jbase.SHAPES[shape])



# ---------------------------------------------------------------------------
# params and layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_bit_exact(arch):
    check_params_bit_exact(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_jax_tree(arch):
    """The port's seeded init has JAX's tree, shapes and dtypes."""
    jc, tc = cfgs(arch)
    tp = ttfm.init(tc, seed=0, device="cpu")
    jp = jparams(arch)[0]
    for key in ("embed", "final_norm", "head"):
        assert (key in tp) == (key in jp)
    for layer, jlayer in zip(tp["layers"], jax_layers(jp["stages"], jc)):
        assert [(p, tuple(t.shape), str(t.dtype)[6:])
                for p, t in leaves(layer)] == \
            [(p, a.shape, a.dtype.name) for p, a in leaves(jlayer)]


@pytest.mark.parametrize("pos_kind", ["text", "distinct"])
def test_apply_mrope_matches_jax(pos_kind):
    x = rand((2, 7, 4, 16), 3)
    pos = np.tile(np.arange(7, dtype=np.int32), (3, 2, 1))
    if pos_kind == "distinct":
        pos = pos + np.arange(3, dtype=np.int32)[:, None, None] * 11 \
            + np.array([0, 5], np.int32)[None, :, None]
    want = jrope.apply_mrope(jnp.asarray(x), jnp.asarray(pos), (2, 3, 3),
                             1e6)
    got = trope.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                            (2, 3, 3), 1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL_PRIM,
                               atol=TOL_PRIM)


def _layer(arch, index):
    jc = cfgs(arch)[0]
    jp32 = jax_layers(jparams(arch)[1]["stages"], jc)[index]
    tp = port_params(arch, jparams(arch)[1])["layers"][index]
    return jax.tree.map(jnp.asarray, jp32), tp


@pytest.mark.parametrize("arch,index,kind", [
    ("gemma3-1b", 0, "local"), ("gemma3-1b", 2, "global"),
    ("qwen2-vl-2b", 0, "global")])
def test_gqa_apply_matches_jax(arch, index, kind):
    """gemma3's local layer at S = 20 (past its window of 8) and its
    global layer, and qwen2-vl's M-RoPE layer on distinct t/h/w ids."""
    jc, tc = cfgs(arch)
    jp, tp = _layer(arch, index)
    s = 20
    x = rand((2, s, jc.d_model), 11)
    pos = np.tile(np.arange(s, dtype=np.int32), (2, 1))
    if jc.mrope_sections:
        pos = pos[None] + np.arange(3, dtype=np.int32)[:, None, None] * 3
    want = jax.jit(lambda p, x, pos: jattn.gqa_apply(
        p, x, jc, positions=pos, layer_kind=kind, kv_chunk=4))(
        jp["attn"], jnp.asarray(x), jnp.asarray(pos))
    got = tattn.gqa_apply(tp["attn"], torch.from_numpy(x), tc,
                          positions=torch.from_numpy(pos), layer_kind=kind,
                          kv_chunk=4)
    close_rel(got.numpy(), want, TOL_LAYER)


@pytest.mark.parametrize("arch,index,kind", [
    ("gemma3-1b", 1, "local"), ("qwen2-vl-2b", 1, "global")])
def test_gqa_decode_matches_jax(arch, index, kind):
    """Decode rows past gemma3's window (idx 9, 13 with window 8) and
    qwen2-vl's M-RoPE decode, a 0-d tensor index as a graph passes it."""
    jc, tc = cfgs(arch)
    jp, tp = _layer(arch, index)
    shape = (2, 16, jc.num_kv_heads, jc.head_dim)
    k0, v0 = rand(shape, 12), rand(shape, 13)
    jcache = {"k": jnp.asarray(k0), "v": jnp.asarray(v0)}
    tcache = {"k": torch.from_numpy(k0.copy()),
              "v": torch.from_numpy(v0.copy())}
    jdecode = jax.jit(lambda p, x, c, i: jattn.gqa_decode(
        p, x, c, i, jc, layer_kind=kind))
    for idx in (0, 9, 13):
        x = rand((2, 1, jc.d_model), 14 + idx)
        want, jcache = jdecode(jp["attn"], jnp.asarray(x), jcache, idx)
        got, tcache = tattn.gqa_decode(tp["attn"], torch.from_numpy(x),
                                       tcache, torch.tensor(idx), tc,
                                       layer_kind=kind)
        close_rel(got.numpy(), want, TOL_LAYER)
        close_rel(tcache["k"].numpy(), jcache["k"], TOL_PRIM)
        close_rel(tcache["v"].numpy(), jcache["v"], TOL_PRIM)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

# gemma3's reduced window is 8: S = 13 passes it
@pytest.mark.parametrize("which", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch, which):
    check_forward(arch, which, 13)


def test_gemma3_embed_scale_and_norms():
    """gemma3's hidden state before the first layer is the embedding row
    times sqrt(d_model), one bf16 rounding of the f32 product, as JAX's
    ``_embed_in``; the final norm is the (1 + g) one."""
    jc, tc = cfgs("gemma3-1b")
    jp = jparams("gemma3-1b")[0]
    toks = tokens(1, 5, jc.vocab_size, 30)
    want = jtfm._embed_in(jp, {"inputs": jnp.asarray(toks)}, jc, None)
    tp = port_params("gemma3-1b", jp)
    got = ttfm._embed_in(tp, {"inputs": torch.from_numpy(toks).long()}, tc)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(bits(got), bits(want))
    assert tc.gemma_norm and tc.sandwich_norm
    assert all({"pn1", "pn2"} <= set(layer) for layer in tp["layers"])


@pytest.mark.parametrize("which", ["f32", "bf16"])
def test_vlm_embeds_forward_matches_jax(which):
    """qwen2-vl-2b with the stub frontend's (B, S, D) embeddings in place
    of token ids."""
    jc, tc = cfgs("qwen2-vl-2b")
    jp = jparams("qwen2-vl-2b")[1 if which == "f32" else 0]
    emb = rand((2, 9, jc.d_model), 31)
    jemb = jnp.asarray(emb, jnp.float32 if which == "f32" else jnp.bfloat16)
    temb = torch.from_numpy(emb).to(torch.float32 if which == "f32"
                                    else torch.bfloat16)
    want = jax.jit(lambda p, e: jtfm.forward(p, {"embeds": e}, jc,
                                             kv_chunk=4))(jp, jemb)
    got = ttfm.forward(port_params("qwen2-vl-2b", jp), {"embeds": temb}, tc,
                       kv_chunk=4)
    close_rel(got.numpy(), want, TOL_MODEL if which == "f32" else TOL_BF16)


def test_vlm_embeds_decode_matches_jax():
    """``decode_step`` on (B, 1, D) embeddings, as JAX's."""
    jc, tc = cfgs("qwen2-vl-2b")
    jp = jparams("qwen2-vl-2b")[1]
    tp = port_params("qwen2-vl-2b", jp)
    jcache, _ = jtfm.init_cache(jc, 2, 4, jnp.float32)
    tcache = ttfm.init_cache(tc, 2, 4, dtype=torch.float32, device="cpu")
    jstep = jax.jit(lambda p, c, e, i: jtfm.decode_step(p, c, e, i, jc))
    for i in range(3):
        e = rand((2, 1, jc.d_model), 32 + i)
        want, jcache = jstep(jp, jcache, jnp.asarray(e), i)
        got, tcache = ttfm.decode_step(tp, tcache, torch.from_numpy(e), i,
                                       tc)
        close_rel(got.numpy(), want, TOL_MODEL)


@pytest.mark.parametrize("which", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_matches_jax(arch, which):
    check_prefill(arch, which, 11)


@pytest.mark.parametrize("which", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(arch, which):
    check_decode_steps(arch, which)


# gemma3: 11 positions, past its window of 8
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    check_decode_matches_forward(arch, 11)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_serve_tokens_match_jax(arch, monkeypatch):
    check_serve_tokens(arch, monkeypatch)


@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_batcher_tokens_match_jax(arch):
    check_batcher_tokens(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_on_cpu(arch, capsys):
    gen = tserve.main(["--arch", arch, "--device", "cpu", "--tokens", "3",
                       "--batch", "2"])
    assert gen.shape == (2, 3)
    assert f"arch={arch} device=cpu" in capsys.readouterr().out
