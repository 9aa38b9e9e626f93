"""The port's encoder-decoder (seamless-m4t-large-v2) against the JAX
package on the CPU, at JAX's ``reduced()`` config with JAX's own weights
(``params_from_jax``): the config, params bit for bit (``enc_stages``
unstacked into ``enc_layers``), ``cross_apply``, ``encode``, ``forward``
in f32 and bf16, the prefill step, two ``decode_step``s over a memory
and their caches, decode against forward, and the greedy tokens of
``serve``, ``ContinuousBatcher`` and ``LMBackend`` behind the control
plane, each with JAX's memory handed over.  The tolerances are
``tests/test_torch_lm.py``'s.

JAX's jnp attention core pads K/V with zero keys to a multiple of
``kv_chunk`` and masks them only through the causal test (ROADMAP Queue
3), so with ``causal=False`` (the encoder's self-attention and every
cross attention) and a source length that leaves a partial chunk, JAX
lets the zero keys into the softmax.  The comparisons with JAX therefore
use source lengths that fill whole chunks or one chunk; the ragged case
is held to the dense oracle instead (``test_cross_apply_ragged_...``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.layers import attention as jattn
from repro.models import transformer as jtfm
from repro.serving import batcher as jbatcher
from repro.serving import control_plane as jcp
from repro_torch import serve_lm_continuous
from repro_torch.configs import registry as tregistry
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.layers import attention as tattn
from repro_torch.models import transformer as ttfm
from repro_torch.serving import batcher as tbatcher
from repro_torch.serving import control_plane as tcp
from tests.test_torch_lm import (TOL_BF16, TOL_LAYER, TOL_MODEL, close_rel,
                                 rand, tokens)
from tests.test_torch_lm_families import (bits, cfgs, jparams, leaves,
                                          port_params)

ARCH = "seamless-m4t-large-v2"
SRC = 16                    # source frames: one chunk, or two of 8


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def f32(arch=ARCH):
    """(JAX's f32 params, the port's copy)."""
    jp = jparams(arch)[1]
    return jp, port_params(arch, jp)


def unstack(stages, stage_defs):
    out = []
    for (kinds, reps), stage in zip(stage_defs, stages):
        for r in range(reps):
            for i in range(len(kinds)):
                out.append(jax.tree.map(lambda a, r=r: np.asarray(a)[r],
                                        stage[f"l{i}"]))
    return out


def src_embeds(b, s, d, seed, dtype=np.float32):
    return rand((b, s, d), seed).astype(dtype)


# ---------------------------------------------------------------------------
# config and params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["get_config", "get_reduced"])
def test_config_matches_jax(which):
    from repro.configs import registry as jregistry
    from repro.configs import seamless_m4t_large_v2 as jmod
    from repro_torch.configs import seamless_m4t_large_v2 as tmod
    jc, tc = getattr(jregistry, which)(ARCH), getattr(tregistry, which)(ARCH)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert tc.total_layers() == jc.total_layers()
    assert tmod.SRC_FRAMES == jmod.SRC_FRAMES == 3072
    assert tuple(tregistry.ARCH_IDS) == tuple(jregistry.ARCH_IDS)


def test_params_from_jax_bit_exact():
    jc, tc = cfgs(ARCH)
    jp = jparams(ARCH)[0]
    tp = port_params(ARCH, jp)
    assert sorted(tp) == ["embed", "enc_layers", "enc_norm", "final_norm",
                          "head", "layers"]
    for key in ("embed", "enc_norm", "final_norm", "head"):
        for (path, t), (jpath, a) in zip(leaves(tp[key]), leaves(jp[key])):
            assert path == jpath
            np.testing.assert_array_equal(bits(t), bits(a))
    for mine, theirs, defs in ((tp["layers"], jp["stages"], jc.stages),
                               (tp["enc_layers"], jp["enc_stages"],
                                jc.encoder_stages)):
        jl = unstack(theirs, defs)
        assert len(mine) == len(jl) == 2
        for layer, jlayer in zip(mine, jl):
            tl, jll = list(leaves(layer)), list(leaves(jlayer))
            assert [p for p, _ in tl] == [p for p, _ in jll]
            for (_, t), (_, a) in zip(tl, jll):
                np.testing.assert_array_equal(bits(t), bits(a))


def test_init_has_jax_tree():
    """The port's seeded init: JAX's tree (a ``dec`` layer's ``lnx`` and
    ``cross``, the encoder's layers and ``enc_norm``), shapes and
    dtypes."""
    jc, tc = cfgs(ARCH)
    jp = jparams(ARCH)[0]
    tp = ttfm.init(tc, device="cpu")
    assert ttfm.layer_kinds(tc) == ["dec", "dec"]
    assert ttfm.enc_layer_kinds(tc) == ["enc", "enc"]
    for mine, theirs, defs in ((tp["layers"], jp["stages"], jc.stages),
                               (tp["enc_layers"], jp["enc_stages"],
                                jc.encoder_stages)):
        for layer, jlayer in zip(mine, unstack(theirs, defs)):
            tl, jll = list(leaves(layer)), list(leaves(jlayer))
            assert [p for p, _ in tl] == [p for p, _ in jll]
            for (path, t), (_, a) in zip(tl, jll):
                assert tuple(t.shape) == a.shape, path
                assert str(t.dtype)[6:] == a.dtype.name, path
    assert "lnx" in tp["layers"][0] and "cross" not in tp["enc_layers"][0]


# ---------------------------------------------------------------------------
# cross attention and the encoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_chunk", [8, 16])
def test_cross_apply_matches_jax(kv_chunk):
    """5 decoder positions over 16 memory rows: two whole chunks of 8, or
    one of 16."""
    jp, tp = f32()
    jc, tc = cfgs(ARCH)
    x, mem = rand((2, 5, 64), 30), rand((2, SRC, 64), 31)
    jl = unstack(jp["stages"], jc.stages)[0]
    want = jattn.cross_apply(jax.tree.map(jnp.asarray, jl["cross"]),
                             jnp.asarray(x), jnp.asarray(mem), jc,
                             kv_chunk=kv_chunk)
    got = tattn.cross_apply(tp["layers"][0]["cross"], torch.from_numpy(x),
                            torch.from_numpy(mem), tc, kv_chunk=kv_chunk)
    close_rel(got.numpy(), want, TOL_LAYER)


def test_cross_apply_ragged_against_dense_oracle():
    """12 memory rows in chunks of 8: JAX's jnp core lets the 4 zero pad
    keys of the last chunk into the non-causal softmax (ROADMAP Queue 3),
    so this case is held to the dense oracle on the layer's own
    projections, and to the port's one-chunk result, instead of JAX."""
    _, tp = f32()
    _, tc = cfgs(ARCH)
    p = tp["layers"][0]["cross"]
    x = torch.from_numpy(rand((2, 5, 64), 32))
    mem = torch.from_numpy(rand((2, 12, 64), 33))
    got = tattn.cross_apply(p, x, mem, tc, kv_chunk=8)
    one = tattn.cross_apply(p, x, mem, tc, kv_chunk=16)
    h, dh = tc.num_heads, tc.head_dim
    q = (x @ p["q"]["w"]).reshape(2, 5, h, dh)
    k = (mem @ p["k"]["w"]).reshape(2, 12, h, dh)
    v = (mem @ p["v"]["w"]).reshape(2, 12, h, dh)
    o = flash_attention_ref(q.double(), k.double(), v.double(),
                            causal=False).float()
    want = o.reshape(2, 5, h * dh) @ p["o"]["w"]
    close_rel(got.numpy(), want.numpy(), TOL_LAYER)
    close_rel(got.numpy(), one.numpy(), TOL_LAYER)


@pytest.mark.parametrize("kv_chunk", [8, 1024])
def test_encode_matches_jax(kv_chunk):
    jp, tp = f32()
    jc, tc = cfgs(ARCH)
    src = src_embeds(2, SRC, 64, 34)
    want = jtfm.encode(jp, jnp.asarray(src), jc, None, kv_chunk)
    got = ttfm.encode(tp, torch.from_numpy(src), tc, kv_chunk=kv_chunk)
    close_rel(got.numpy(), want, TOL_MODEL)


def batch(b=2, s=8, seed=35, dtype=np.float32):
    return {"inputs": tokens(b, s, 512, seed),
            "targets": tokens(b, s, 512, seed + 1),
            "src_embeds": src_embeds(b, SRC, 64, seed + 2, dtype)}


def to_port(bt):
    return {k: torch.from_numpy(np.asarray(v).astype(np.int64)
                                if v.dtype == np.int32 else np.asarray(v))
            for k, v in bt.items()}


def test_forward_f32_matches_jax():
    jp, tp = f32()
    jc, tc = cfgs(ARCH)
    bt = batch()
    want = jtfm.forward(jp, jax.tree.map(jnp.asarray, bt), jc, kv_chunk=8)
    got = ttfm.forward(tp, to_port(bt), tc, kv_chunk=8)
    assert got.dtype == torch.float32 and got.shape == (2, 8, 512)
    close_rel(got.numpy(), want, TOL_MODEL)


def test_forward_bf16_matches_jax():
    """JAX's bf16 params; the source frames in bf16 on both sides (the
    port casts them to the params' dtype, JAX would run an f32 frame
    through its bf16 encoder in f32)."""
    jc, tc = cfgs(ARCH)
    jp = jparams(ARCH)[0]
    tp = port_params(ARCH, jp)
    bt = batch()
    jb = jax.tree.map(jnp.asarray, bt)
    jb["src_embeds"] = jb["src_embeds"].astype(jnp.bfloat16)
    want = jtfm.forward(jp, jb, jc, kv_chunk=8)
    got = ttfm.forward(tp, to_port(bt), tc, kv_chunk=8)
    close_rel(got.numpy(), np.asarray(want, np.float32), TOL_BF16)


def test_prefill_step_matches_jax():
    jp, tp = f32()
    jc, tc = cfgs(ARCH)
    bt = batch(b=3, s=6, seed=40)
    want = jsteps.make_prefill_step(jc, None, kv_chunk=8)(
        jp, jax.tree.map(jnp.asarray, bt))
    got = tsteps.make_prefill_step(tc, kv_chunk=8)(tp, to_port(bt))
    assert got.shape == (3, tc.padded_vocab)
    close_rel(got.numpy(), want, TOL_MODEL)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def test_decode_steps_match_jax():
    """Two decode steps over one memory: the logits and the self-attention
    K/V caches."""
    jp, tp = f32()
    jc, tc = cfgs(ARCH)
    mem = rand((2, SRC, 64), 41)
    toks = tokens(2, 2, 512, 42)
    jcache, _ = jtfm.init_cache(jc, 2, 8, jnp.float32)
    tcache = ttfm.init_cache(tc, 2, 8, torch.float32, device="cpu")
    for i in range(2):
        want, jcache = jtfm.decode_step(jp, jcache, jnp.asarray(toks[:, i:i + 1]),
                                        i, jc, memory=jnp.asarray(mem))
        got, tcache = ttfm.decode_step(tp, tcache,
                                       torch.from_numpy(toks[:, i:i + 1]).long(),
                                       i, tc, memory=torch.from_numpy(mem))
        close_rel(got.numpy(), want, TOL_MODEL)
    for layer, jlayer in zip(tcache, unstack(jcache, jc.stages)):
        for k in ("k", "v"):
            close_rel(layer[k].numpy(), jlayer[k], TOL_MODEL)


def test_decode_matches_forward():
    """Decoding the 6 tokens one at a time over ``encode``'s memory gives
    the teacher-forced logits of ``forward`` on the same batch."""
    _, tp = f32()
    _, tc = cfgs(ARCH)
    bt = to_port(batch(b=2, s=6, seed=43))
    full = ttfm.forward(tp, bt, tc)
    mem = ttfm.encode(tp, bt["src_embeds"], tc)
    cache = ttfm.init_cache(tc, 2, 8, torch.float32, device="cpu")
    outs = []
    for t in range(6):
        lg, cache = ttfm.decode_step(tp, cache, bt["inputs"][:, t:t + 1], t,
                                     tc, memory=mem)
        outs.append(lg[:, 0])
    close_rel(torch.stack(outs, 1).numpy(), full.numpy(), TOL_MODEL)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_serve_tokens_match_jax(monkeypatch):
    """JAX's ``serve`` (its init and prompt draw replaced by the f32 params
    and a numpy prompt) and the port's, handed JAX's own random memory:
    the same greedy tokens."""
    jp, tp = f32()
    jc, _ = cfgs(ARCH)
    b, plen, gen = 3, 5, 6
    prompt = tokens(b, plen, jc.vocab_size, 44)
    memory = np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                          (b, 16, jc.d_model), jnp.bfloat16))
    monkeypatch.setattr(jtfm, "init", lambda key, cfg: (jp, None))
    monkeypatch.setattr(jax.random, "randint",
                        lambda *a, **k: jnp.asarray(prompt))
    want, _ = jserve.serve(ARCH, batch=b, prompt_len=plen, gen_tokens=gen)
    got, _ = tserve.serve(ARCH, batch=b, prompt_len=plen, gen_tokens=gen,
                          device="cpu", params=tp, prompt=prompt,
                          memory=ttfm._tensor(memory, "cpu"))
    assert got.shape == (b, gen)
    np.testing.assert_array_equal(got, np.asarray(want))


def _requests(mod, vocab):
    rng = np.random.default_rng(45)
    lens, news = (3, 5, 2, 4, 6), (4, 2, 5, 3, 4)
    return [mod.Request(rid=i, prompt=rng.integers(0, vocab, (p,),
                                                   dtype=np.int32),
                        max_new=n) for i, (p, n) in enumerate(zip(lens, news))]


def test_continuous_batcher_tokens_match_jax():
    """5 requests over 4 slots, every one decoding over one memory: JAX's
    batcher's tokens, and a lone run's."""
    jp, tp = f32()
    jc, tc = cfgs(ARCH)
    mem = rand((1, SRC, 64), 46)
    jb = jbatcher.ContinuousBatcher(jc, jp, slots=4, max_len=16,
                                    memory=jnp.asarray(mem))
    tb = tbatcher.ContinuousBatcher(tc, tp, slots=4, max_len=16,
                                    memory=torch.from_numpy(mem),
                                    device="cpu")
    for r in _requests(jbatcher, jc.vocab_size):
        jb.submit(r)
    for r in _requests(tbatcher, tc.vocab_size):
        tb.submit(r)
    assert tb.run() == jb.run()
    got = {r.rid: r.out for r in tb.done}
    assert got == {r.rid: r.out for r in jb.done}
    lone = tbatcher.ContinuousBatcher(tc, tp, slots=1, max_len=16,
                                      memory=torch.from_numpy(mem),
                                      device="cpu")
    r = _requests(tbatcher, tc.vocab_size)[2]
    lone.submit(r)
    lone.run()
    assert r.out == got[2]


def test_lm_backend_with_memory_serves_like_jax():
    """``LMBackend(memory=)`` behind the control plane: a burst of 4
    prompts over 2 slots, a decode step killed and replayed; the port's
    answers equal JAX's plane's."""
    from repro.runtime import fault as jfault
    from repro_torch.runtime import fault as tfault
    jp, tp = f32()
    jc, tc = cfgs(ARCH)
    mem = rand((1, SRC, 64), 47)
    rng = np.random.default_rng(48)
    prompts = [rng.integers(0, jc.vocab_size, p).astype(np.int32)
               for p in (3, 5, 2, 4)]
    results = []
    for mod, fault, cfg, params, kw in (
            (jcp, jfault, jc, jp, dict(memory=jnp.asarray(mem))),
            (tcp, tfault, tc, tp, dict(memory=torch.from_numpy(mem),
                                       device="cpu"))):
        cp = mod.ControlPlane(injector=fault.FailureInjector((3,)))
        cp.register_lm_model("s2t", cfg, params, slots=2, max_len=16, **kw)
        cp.run([mod.ServeRequest(rid=i, model="s2t", payload=p, max_new=4)
                for i, p in enumerate(prompts)])
        assert len(cp.done) == 4
        results.append({r.rid: list(np.asarray(r.out)) for r in cp.done})
    assert results[0] == results[1]


def test_serve_lm_continuous_drive_on_cpu(capsys):
    cb = serve_lm_continuous.main(["--device", "cpu", "--arch", ARCH])
    assert cb.memory is not None and cb.memory.shape == (1, 16, 64)
    assert "beats sequential" in capsys.readouterr().out
