"""The port's MoE LM families against the JAX package on the CPU:
dbrx-132b (the ``moe`` kind: GQA attention and a softmax-routed MoE FFN)
and deepseek-v3-671b (MLA with its compressed decode cache, a dense
``mla`` stage and an ``mla_moe`` stage with a shared expert and the
sigmoid_bias router), each at JAX's ``reduced()`` config with JAX's own
weights (``params_from_jax``, two stages unstacked at deepseek): configs,
params bit for bit, ``mla_apply`` / ``mla_decode`` and their ``ckv``/``kr``
caches, ``forward`` in f32 and bf16, the prefill step, three decode steps
and their caches, decode against forward, the greedy tokens of ``serve``
and ``ContinuousBatcher``; and kernel F's plain version at MLA's head dim
of 192 against JAX's Pallas F in interpret mode.  The tolerances and the
helpers are ``tests/test_torch_lm.py``'s and
``tests/test_torch_lm_families.py``'s.  On the CPU the attention core is
kernel F's plain version and the MoE the port's f32 combine; the kernel
at D = 192 is tested on the card (``tests/test_torch_cuda.py``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.kernels.flash_attention import flash_attention_pallas
from repro.layers import attention as jattn
from repro.models import transformer as jtfm
from repro_torch.configs import registry as tregistry
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve as tserve
from repro_torch.layers import attention as tattn
from repro_torch.models import transformer as ttfm
from tests.test_torch_lm_families import (
    TOL_LAYER, TOL_PRIM, cfgs, check_batcher_tokens,
    check_decode_matches_forward, check_decode_steps, check_forward,
    check_params_bit_exact, check_prefill, check_serve_tokens, close_rel,
    jax_layers, jparams, leaves, port_params, rand)

ARCHS = ("dbrx-132b", "deepseek-v3-671b")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


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
    """The port's seeded init has JAX's tree, shapes and dtypes: ``moe``
    (and deepseek's ``shared``) in place of ``mlp`` at the MoE kinds,
    MLA's ``dq``/``uq``/``dkv``/``uk``/``uv`` at deepseek."""
    jc, tc = cfgs(arch)
    tp = ttfm.init(tc, seed=0, device="cpu")
    jp = jparams(arch)[0]
    assert [k for k in ("embed", "final_norm", "head") if k in tp] == \
        [k for k in ("embed", "final_norm", "head") if k in jp]
    for layer, jlayer in zip(tp["layers"], jax_layers(jp["stages"], jc)):
        assert [(p, tuple(t.shape), str(t.dtype)[6:])
                for p, t in leaves(layer)] == \
            [(p, a.shape, a.dtype.name) for p, a in leaves(jlayer)]


def test_layer_kinds_and_caches():
    """deepseek's two stages unroll to mla, mla_moe, mla_moe; its cache
    is MLA's compressed one, dbrx's the GQA KV."""
    tc = cfgs("deepseek-v3-671b")[1]
    assert ttfm.layer_kinds(tc) == ["mla", "mla_moe", "mla_moe"]
    cache = ttfm.init_cache(tc, 2, 9, device="cpu")
    assert all(sorted(c) == ["ckv", "kr"] for c in cache)
    assert tuple(cache[0]["ckv"].shape) == (2, 9, tc.kv_lora_rank)
    assert tuple(cache[0]["kr"].shape) == (2, 9, tc.qk_rope_dim)
    dc = cfgs("dbrx-132b")[1]
    assert ttfm.layer_kinds(dc) == ["moe", "moe"]
    assert tuple(ttfm.init_cache(dc, 2, 9, device="cpu")[0]["k"].shape) == \
        (2, 9, dc.num_kv_heads, dc.head_dim)


# ---------------------------------------------------------------------------
# MLA alone
# ---------------------------------------------------------------------------

def _mla_layer(index):
    jc = cfgs("deepseek-v3-671b")[0]
    jp = jax_layers(jparams("deepseek-v3-671b")[1]["stages"], jc)[index]
    tp = port_params("deepseek-v3-671b",
                     jparams("deepseek-v3-671b")[1])["layers"][index]
    return jax.tree.map(jnp.asarray, jp["attn"]), tp["attn"]


@pytest.mark.parametrize("index", [0, 2])
def test_mla_apply_matches_jax(index):
    """The decompressed prefill form (q, k at 16 + 8 = 24, v padded to 24
    and sliced back to 16) at S = 11 on KV chunks of 4, f32."""
    jc, tc = cfgs("deepseek-v3-671b")
    jp, tp = _mla_layer(index)
    s = 11
    x = rand((2, s, jc.d_model), 40 + index)
    pos = np.tile(np.arange(s, dtype=np.int32), (2, 1))
    want = jax.jit(lambda p, x, pos: jattn.mla_apply(
        p, x, jc, positions=pos, kv_chunk=4))(jp, jnp.asarray(x),
                                               jnp.asarray(pos))
    got = tattn.mla_apply(tp, torch.from_numpy(x), tc,
                          positions=torch.from_numpy(pos), kv_chunk=4)
    close_rel(got.numpy(), want, TOL_LAYER)


def test_mla_decode_matches_jax():
    """The absorbed form over a compressed cache, idx 0, 5 and 9 as 0-d
    tensors (as a graph passes them): the output and the ``ckv``/``kr``
    rows written in place."""
    jc, tc = cfgs("deepseek-v3-671b")
    jp, tp = _mla_layer(1)
    c0 = rand((2, 12, jc.kv_lora_rank), 41)
    r0 = rand((2, 12, jc.qk_rope_dim), 42)
    jcache = {"ckv": jnp.asarray(c0), "kr": jnp.asarray(r0)}
    tcache = {"ckv": torch.from_numpy(c0.copy()),
              "kr": torch.from_numpy(r0.copy())}
    jdecode = jax.jit(lambda p, x, c, i: jattn.mla_decode(p, x, c, i, jc))
    for idx in (0, 5, 9):
        x = rand((2, 1, jc.d_model), 43 + idx)
        want, jcache = jdecode(jp, jnp.asarray(x), jcache, idx)
        got, out_cache = tattn.mla_decode(tp, torch.from_numpy(x), tcache,
                                          torch.tensor(idx), tc)
        assert out_cache is tcache
        close_rel(got.numpy(), want, TOL_LAYER)
        close_rel(tcache["ckv"].numpy(), jcache["ckv"], TOL_PRIM)
        close_rel(tcache["kr"].numpy(), jcache["kr"], TOL_PRIM)


def test_plain_matches_pallas_interpret_at_mla_head_dim():
    """Kernel F's plain version at D = 192 (MLA's q·k dim), 8 heads, v
    zero in its last 64 columns as MLA pads it, MLA's scale, against JAX's
    Pallas F in interpret mode (2e-4, test_flash_attention_kernel.py's
    f32 tolerance)."""
    rng = np.random.default_rng(192)
    q, k, v = (rng.standard_normal((1, 256, 8, 192)).astype(np.float32)
               for _ in range(3))
    v[..., 128:] = 0.0
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True, bq=128,
                                  ck=128, scale=192 ** -0.5, interpret=True)
    got = fa.flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                   causal=True, scale=192 ** -0.5, ck=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    assert not got[..., 128:].any()
    assert 192 in fa.HEAD_DIMS


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch, which):
    check_forward(arch, which, 13)


@pytest.mark.parametrize("which", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_matches_jax(arch, which):
    check_prefill(arch, which, 11)


@pytest.mark.parametrize("which", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(arch, which):
    """Three decode steps and every cache tensor after each: the KV at
    dbrx, ``ckv``/``kr`` at deepseek (``moe_decode`` on both)."""
    check_decode_steps(arch, which)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """Token-by-token decode (the absorbed MLA form, ``moe_decode``)
    against the teacher-forced forward (the decompressed form,
    ``moe_apply``)."""
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
